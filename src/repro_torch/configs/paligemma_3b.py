"""PaliGemma-3B [arXiv:2407.07726; hf:google/paligemma-3b-pt-224].

SigLIP vision tower (STUB: precomputed patch embeddings, 256 patches) +
Gemma-2B text backbone: 18L, d_model=2048, 8 heads (MQA kv=1,
head_dim=256), GeGLU d_ff=16384, vocab 257216, prefix-LM masking
(bidirectional over image prefix, causal over text).
"""
from repro_torch.configs.base import BLOCK_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    ffn_type="geglu",
    pattern=(BLOCK_ATTN,),
    frontend="image_patches",
    n_prefix=256,
    tie_embeddings=True,
    embed_scale=True,
)
