"""RWKV6-3B "Finch" [arXiv:2404.05892; hf:RWKV/rwkv-6-world-3b].

32L, d_model=2560 (attention-free; 40 WKV heads of 64), channel-mix
d_ff=8960, vocab 65536, data-dependent decay (ddlerp token-shift + decay
LoRA).
"""
from repro_torch.configs.base import BLOCK_RWKV, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,                 # 2560 / rwkv_head_dim
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    ffn_type="sq_relu",         # rwkv channel-mix uses squared relu
    pattern=(BLOCK_RWKV,),
    rwkv_head_dim=64,
)
