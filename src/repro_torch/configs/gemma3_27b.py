"""Gemma3-27B [hf:google/gemma-3-27b-pt; unverified tier].

62L, d_model=5376, 32 heads (GQA kv=16, head_dim=128), GeGLU d_ff=21504,
vocab 262144, hybrid 5 local (window 1024) : 1 global attention, QK-norm,
gemma embedding scaling, 128k context.
"""
from repro_torch.configs.base import BLOCK_GLOBAL, BLOCK_LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    ffn_type="geglu",
    pattern=(BLOCK_LOCAL,) * 5 + (BLOCK_GLOBAL,),
    window=1024,
    rope_theta=1e6,
    qk_norm=True,
    tie_embeddings=True,
    embed_scale=True,
)
