"""Config dataclasses of the PyTorch port.

A copy of the reference's ``repro/configs/base.py`` restricted to what
the RNN-T training + PGM selection path reads: the field names, defaults
and the smoke reduction are the reference's, so a config built here and
one built there describe the same model and run.  Fields of later slices
(mesh, compression, fault guard, MoE/LM extras) are not carried yet.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class RNNTConfig:
    """Paper's own architecture: SpeechBrain Librispeech transducer recipe.

    CRDNN encoder (2 CNN blocks -> 4 bi-LSTM layers -> 2 DNN layers),
    prediction net (embedding + 1-layer GRU), joint = single linear
    projecting 1024-d fused representation to 1000 BPE vocab.
    """

    n_feats: int = 80
    cnn_channels: Tuple[int, int] = (64, 128)
    lstm_layers: int = 4
    lstm_hidden: int = 512           # per direction
    dnn_dim: int = 1024
    pred_embed: int = 256
    pred_hidden: int = 512
    joint_dim: int = 1024
    vocab_size: int = 1000           # BPE units + blank
    time_reduction: int = 4          # cnn striding
    # vocab-chunk size of the fused loss's streamed logsumexp/backward
    # (0: auto-tuned at engine build, <0: one chunk of the whole vocab)
    loss_vocab_chunk: int = 0

    def n_params(self) -> int:
        n = 0
        c_in = 1
        for c in self.cnn_channels:
            n += c_in * c * 9 + c
            c_in = c
        d_in = self.cnn_channels[-1] * (self.n_feats // 4)
        for _ in range(self.lstm_layers):
            n += 2 * 4 * (d_in * self.lstm_hidden + self.lstm_hidden ** 2
                          + self.lstm_hidden)
            d_in = 2 * self.lstm_hidden
        n += d_in * self.dnn_dim + self.dnn_dim * self.dnn_dim
        n += self.vocab_size * self.pred_embed
        n += 3 * (self.pred_embed * self.pred_hidden + self.pred_hidden ** 2)
        n += (self.dnn_dim + self.pred_hidden) * self.joint_dim
        n += self.joint_dim * self.vocab_size
        return n


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description (the RNN-T family only in this slice)."""

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    rnnt: Optional[RNNTConfig] = None

    def n_params(self) -> int:
        if self.rnnt is None:
            raise NotImplementedError(
                f"{self.name}: only the rnnt family is ported")
        return self.rnnt.n_params()


@dataclass(frozen=True)
class PGMConfig:
    """Paper hyper-parameters (§5): selection interval R, partitions D,
    warm-start epochs, subset fraction, OMP regularization/tolerance."""

    subset_fraction: float = 0.3
    n_partitions: int = 8            # D; paper: 7 (100H) / 50 (960H)
    select_every: int = 5            # R
    warm_start_epochs: int = 2
    val_matching: bool = False       # 'Val' flag (noisy/robust mode)
    lam: float = 0.5                 # l2 reg on weights (lambda)
    eps: float = 1e-10               # OMP stopping tolerance
    sketch_dim_h: int = 64           # tensor-JL sketch dims
    sketch_dim_v: int = 64
    use_sketch: bool = True          # False -> exact last-layer gradients
    nonneg_weights: bool = True      # clip OMP weights at 0


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 1.0
    optimizer: str = "sgd"           # sgd | adamw
    momentum: float = 0.0
    weight_decay: float = 0.0
    grad_clip: float = 5.0
    epochs: int = 30
    # newbob: anneal lr by `anneal_factor` when the relative validation
    # improvement drops below `improvement_threshold`
    anneal_factor: float = 0.8
    improvement_threshold: float = 0.0025
    seed: int = 0
    pgm: PGMConfig = field(default_factory=PGMConfig)


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """The reference's tiny same-family variant (CPU tests)."""
    kw = dict(n_layers=min(cfg.n_layers, 2), d_model=64, n_heads=4,
              n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
              head_dim=16, d_ff=128, vocab_size=277)
    if cfg.rnnt is not None:
        kw["rnnt"] = RNNTConfig(
            n_feats=8, cnn_channels=(4, 8), lstm_layers=1, lstm_hidden=16,
            dnn_dim=32, pred_embed=16, pred_hidden=16, joint_dim=32,
            vocab_size=37,
        )
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)
