"""Minitron-8B [arXiv:2407.14679; hf:nvidia/Minitron-8B-Base].

Pruned Nemotron-4: 32L, d_model=4096, 32 heads (GQA kv=8, head_dim=128),
squared-ReLU MLP d_ff=16384, vocab 256000, full attention, untied embeddings.
"""
from repro_torch.configs.base import BLOCK_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    ffn_type="sq_relu",
    pattern=(BLOCK_ATTN,),
)
