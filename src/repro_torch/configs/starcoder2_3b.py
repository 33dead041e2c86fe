"""StarCoder2-3B [arXiv:2402.19173; hf:bigcode/starcoder2-3b].

30L, d_model=3072, 24 heads (GQA kv=2, head_dim=128), GELU MLP d_ff=12288,
vocab 49152, RoPE, sliding-window attention (4096).
"""
from repro_torch.configs.base import BLOCK_LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    ffn_type="gelu",
    pattern=(BLOCK_LOCAL,),
    window=4096,
    rope_theta=1e5,
    tie_embeddings=True,
)
