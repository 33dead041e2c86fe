"""OLMoE-1B-7B [arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924].

16L, d_model=2048, 16 heads (kv=16, i.e. MHA, head_dim=128), MoE with 64
experts top-8 (d_ff_expert=1024, SwiGLU), vocab 50304, full attention,
QK-norm.
"""
from repro_torch.configs.base import BLOCK_ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    ffn_type="swiglu",
    pattern=(BLOCK_ATTN,),
    qk_norm=True,
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024),
)
