"""SeamlessM4T-medium backbone [arXiv:2308.11596; hf:facebook/seamless-m4t-medium].

Encoder-decoder transformer BACKBONE only: 12 encoder + 12 decoder layers,
d_model=1024, 16 heads (MHA kv=16, head_dim=64), GELU d_ff=4096 (paper's FFN
dim 4096 applies to the text stack), vocab 256206.  The speech frontend
(w2v-BERT conformer feature extractor) is a STUB per the brief:
``input_specs`` supplies precomputed frame embeddings (B, T_frames, d_model).
"""
from repro_torch.configs.base import BLOCK_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,                # decoder layers
    n_enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    ffn_type="gelu",
    pattern=(BLOCK_ATTN,),
    frontend="audio_frames",
    tie_embeddings=True,
)
