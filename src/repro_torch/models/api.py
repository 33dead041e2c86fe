"""Model bundles of the port: the RNN-T family (the reference's
``models/api.py:_build_rnnt``) and text decoder LMs (``_build_lm`` for
text-only models: dense attention stacks and RWKV6 stacks).

A bundle is the surface the trainer and the PGM core build on:
``init_params``, the per-example loss, the weighted training loss and the
last-layer head; the LM bundle also has ``final_hidden``, the hook of LM
stage A.  Batches are dicts of tensors on the params' device with the
reference's keys (RNN-T: ``feats``, ``feat_lens``, ``tokens``,
``token_lens``, ``weights``; LM: ``tokens``, ``loss_mask``, ``weights``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ATTN_KINDS, BLOCK_RWKV, ModelConfig
from repro_torch.core.rnnt_loss import rnnt_loss_fused
from repro_torch.models import rnnt as rnnt_mod
from repro_torch.models import transformer as tfm

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


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Per-example mean cross-entropy in fp32: logits (B,S,V), targets
    (B,S), mask (B,S) -> (B,).  The gold logit is gathered; the
    reference contracts a one-hot, which selects the same value."""
    lv = logits.to(torch.float32)
    logz = torch.logsumexp(lv, dim=-1)
    gold = torch.gather(lv, -1, targets.long()[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum(dim=-1) / torch.clamp(mask.sum(dim=-1), min=1.0)


@dataclasses.dataclass(frozen=True)
class LMBundle:
    """Text decoder LM (dense attention or RWKV6 stack): position i
    predicts token i+1."""

    cfg: ModelConfig

    def __post_init__(self):
        why = _unported(self.cfg)
        if why:
            raise NotImplementedError(
                f"{self.cfg.name}: {why} is not ported yet (ROADMAP.md "
                f"queue 1, other families)")

    def init_params(self, gen: torch.Generator, device: torch.device):
        return tfm.init_params(self.cfg, gen, device)

    def assemble(self, params, batch: Batch):
        """-> (embedded tokens (B,S,d), targets (B,S-1), mask (B,S-1))."""
        tokens = batch["tokens"]
        x = tfm.embed_tokens(params, self.cfg, tokens)
        targets = tokens[:, 1:]
        mask = batch.get("loss_mask")
        mask = (torch.ones(targets.shape, dtype=torch.float32,
                           device=tokens.device) if mask is None
                else mask[:, 1:].to(torch.float32))
        return x, targets, mask

    def final_hidden(self, params, batch: Batch):
        """-> (hidden states aligned with the next-token targets
        (B,S-1,d) in the compute dtype, targets, mask)."""
        x, targets, mask = self.assemble(params, batch)
        h = tfm.forward_hidden(params, self.cfg, x)
        return h[:, :-1], targets, mask

    def per_example_loss(self, params, batch: Batch) -> torch.Tensor:
        h, targets, mask = self.final_hidden(params, batch)
        return softmax_xent(tfm.unembed(params, self.cfg, h), targets, mask)

    def loss_fn(self, params, batch: Batch) -> Tuple[torch.Tensor, Dict]:
        return _weighted(self.per_example_loss(params, batch), batch)

    def head_weight(self, params) -> torch.Tensor:
        return tfm.head_weight(params, self.cfg)


def _unported(cfg: ModelConfig) -> str:
    """What of ``cfg`` the LM slices do not carry ('' when nothing): the
    ``dense`` family with attention blocks and the ``ssm`` family with
    RWKV6 blocks are ported; any other family (moe, hybrid, encdec,
    vlm), or blocks of another kind in either, are not."""
    allowed = {"dense": set(ATTN_KINDS), "ssm": {BLOCK_RWKV}}
    if cfg.family not in allowed:
        return f"the {cfg.family!r} family"
    odd = sorted(set(cfg.layer_kinds()) - allowed[cfg.family])
    return f"{odd} blocks in the {cfg.family!r} family" if odd else ""


def build_model(cfg: ModelConfig):
    """The bundle of ``cfg.family``: ``rnnt``, ``dense`` or ``ssm`` (RWKV6
    stacks); any other family raises ``NotImplementedError``."""
    if cfg.family == "rnnt":
        return RNNTBundle(cfg)
    return LMBundle(cfg)
