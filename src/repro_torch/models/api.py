"""Model bundle of the port: the RNN-T family (the reference's
``models/api.py:_build_rnnt``).

The bundle is the surface the trainer and the PGM core build on:
``init_params``, the per-example loss (transducer NLL divided by
``max(u_len, 1)``), the weighted training loss and the last-layer head.
Batches are dicts of tensors on the params' device with the reference's
keys (``feats``, ``feat_lens``, ``tokens``, ``token_lens``, ``weights``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.rnnt_loss import rnnt_loss_fused
from repro_torch.models import rnnt as rnnt_mod

Batch = Dict[str, torch.Tensor]


def _weighted(per_ex: torch.Tensor, batch: Batch) -> Tuple[torch.Tensor, Dict]:
    """Weighted mean of the per-example losses; a batch without
    ``weights`` counts every example once."""
    w = batch.get("weights")
    w = (torch.ones_like(per_ex) if w is None else w.to(torch.float32))
    loss = torch.sum(per_ex * w) / torch.clamp(torch.sum(w), min=1e-9)
    aux = torch.zeros((), device=per_ex.device)
    total = loss + aux
    return total, {"loss": loss, "aux_loss": aux, "total_loss": total}


@dataclasses.dataclass(frozen=True)
class RNNTBundle:
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.family != "rnnt" or self.cfg.rnnt is None:
            raise ValueError(f"{self.cfg.name}: the port carries the rnnt "
                             f"family only")

    def init_params(self, gen: torch.Generator, device: torch.device):
        return rnnt_mod.init_params(self.cfg, gen, device)

    def t_lens(self, batch: Batch) -> torch.Tensor:
        """Encoder frames per example: ``max(feat_lens // 4, 1)``."""
        return torch.clamp(batch["feat_lens"].long()
                           // self.cfg.rnnt.time_reduction, min=1)

    def per_example_nll(self, params, batch: Batch) -> torch.Tensor:
        ze, zp = rnnt_mod.joint_factors(params, self.cfg, batch["feats"],
                                        batch["tokens"])
        return rnnt_loss_fused(ze, zp, params["joint"]["w_out"],
                               batch["tokens"], self.t_lens(batch),
                               batch["token_lens"],
                               vocab_chunk=self.cfg.rnnt.loss_vocab_chunk)

    def per_example_loss(self, params, batch: Batch) -> torch.Tensor:
        return self.per_example_nll(params, batch) / torch.clamp(
            batch["token_lens"].to(torch.float32), min=1.0)

    def loss_fn(self, params, batch: Batch) -> Tuple[torch.Tensor, Dict]:
        return _weighted(self.per_example_loss(params, batch), batch)

    def head_weight(self, params) -> torch.Tensor:
        return params["joint"]["w_out"]


def build_model(cfg: ModelConfig) -> RNNTBundle:
    return RNNTBundle(cfg)
