"""Gemma-7B [arXiv:2403.08295; hf:google/gemma-7b].

28L, d_model=3072, 16 heads (kv=16, head_dim=256 -> q_dim 4096 != d_model),
GeGLU d_ff=24576, vocab 256000, full attention, tied embeddings with
sqrt(d_model) embedding scaling.
"""
from repro_torch.configs.base import BLOCK_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    ffn_type="geglu",
    pattern=(BLOCK_ATTN,),
    tie_embeddings=True,
    embed_scale=True,
)
