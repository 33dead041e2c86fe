"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427; unverified tier].

38L, d_model=4096, 16 heads (MQA kv=1, head_dim=256), GeGLU d_ff=12288,
vocab 256000, hybrid RG-LRU : local attention at 2:1 (pattern
(rec, rec, attn) repeating; window 2048), lru_width=4096, temporal conv
width 4.
"""
from repro_torch.configs.base import BLOCK_LOCAL, BLOCK_REC, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    ffn_type="geglu",
    pattern=(BLOCK_REC, BLOCK_REC, BLOCK_LOCAL),
    window=2048,
    lru_width=4096,
    conv_width=4,
    tie_embeddings=True,
    embed_scale=True,
)
