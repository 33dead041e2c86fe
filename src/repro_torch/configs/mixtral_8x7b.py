"""Mixtral 8x7B [arXiv:2401.04088; hf:mistralai/Mixtral-8x7B-v0.1].

32L, d_model=4096, 32 heads (GQA kv=8, head_dim=128), SwiGLU MoE with 8
experts top-2 (d_ff_expert=14336), vocab 32000, sliding-window attention
(window 4096), rope_theta=1e6.
"""
from repro_torch.configs.base import BLOCK_LOCAL, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    ffn_type="swiglu",
    pattern=(BLOCK_LOCAL,),
    window=4096,
    rope_theta=1e6,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336),
)
