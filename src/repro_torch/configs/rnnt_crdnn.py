"""The paper's own architecture: SpeechBrain Librispeech RNN-T recipe.

CRDNN encoder (2 CNN blocks, 4 bi-LSTM layers of 512/dir, 2 DNN layers to
1024) + prediction network (256-d embedding, 1-layer GRU 512) + joint
network (single linear fusing 1024-d representations into 1000 BPE units).
"""
from repro_torch.configs.base import ModelConfig, RNNTConfig

CONFIG = ModelConfig(
    name="rnnt-crdnn",
    family="rnnt",
    n_layers=4,
    d_model=1024,
    n_heads=1,
    n_kv_heads=1,
    head_dim=1024,
    d_ff=1024,
    vocab_size=1000,
    rnnt=RNNTConfig(),
)
