"""Per-batch training engine of the port (the reference's
``train/engine.py``: ``make_step_core`` on the single-device path,
``autotune_loss_vocab_chunk`` and ``HostEngine``, its parity oracle).

``HostEngine`` runs one step per host-assembled batch of the
(seed, epoch)-keyed plans, so its batch order is byte-identical to the
reference's.  The scanned, device-resident ``EpochEngine`` is later work.

The non-finite guard (``TrainConfig.nonfinite_guard``) checks each
step's loss and clipped gradient norm on the device and folds the result
into the optimizer's ``gate_step`` select, as the reference does: a
poisoned batch leaves params and optimizer state bit for bit as they
were, and a guarded run on finite data is bitwise the unguarded one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.chunking import auto_vocab_chunk
from repro_torch.data.pipeline import epoch_plan, subset_epoch_plan
from repro_torch.models.api import build_model
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.train.optim import clip_by_global_norm, make_update_for


def make_step_core(bundle, cfg: TrainConfig):
    """One weighted SGD step: ``step(params, opt_state, batch, lr,
    step_on=None) -> (params, opt_state, metrics)``.  Gradients come from
    autograd through the fused loss's analytic backward; the inputs are
    left untouched.  ``step_on`` (0-dim bool tensor) gates the update.

    With ``cfg.nonfinite_guard`` the step also gates on ``isfinite(loss)
    & isfinite(gnorm)`` (the clip's global norm: any NaN/Inf gradient
    leaf poisons it, and a finite tree whose norm overflows is gated off
    too), zeroes the metrics of a gated-off step and reports
    ``metrics["skipped"]``, whether a live step was suppressed.  Nothing
    is read back to the host."""
    _, opt_update = make_update_for(cfg)
    guard = bool(cfg.nonfinite_guard)

    def step(params, opt_state, batch, lr, step_on=None):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(live)
        with torch.enable_grad():
            total, metrics = bundle.loss_fn(live, batch)
            grad_leaves = torch.autograd.grad(total, leaves)
        by_id = {id(l): g for l, g in zip(leaves, grad_leaves)}
        grads = tree_map(lambda p: by_id[id(p)], live)
        # only `grads` holds the raw gradients now: rebinding it to the
        # clipped tree frees them before the update allocates new params
        del grad_leaves, by_id
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
            ok = step_on
            if guard:
                finite = torch.isfinite(total) & torch.isfinite(gnorm)
                ok = finite if step_on is None else step_on & finite
            params, opt_state = opt_update(params, grads, opt_state, lr,
                                           step_on=ok)
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["grad_norm"] = gnorm
            if ok is not None:
                metrics = {k: torch.where(ok, v, torch.zeros_like(v))
                           for k, v in metrics.items()}
            if guard:
                live = (torch.ones_like(finite) if step_on is None
                        else step_on)
                metrics["skipped"] = live & ~finite
        return params, opt_state, metrics

    return step


def autotune_loss_vocab_chunk(bundle, units, batch_units: int):
    """Resolve ``RNNTConfig.loss_vocab_chunk == 0`` ("auto") into the
    chunk width the reference picks for the same shapes (rows =
    ``B * (U+1) + joint_dim``, the shared ``auto_vocab_chunk`` budget),
    rebuilding the bundle only when that width is below the vocab.
    Returns ``(bundle, resolved_chunk)``; ``(bundle, None)`` for a bundle
    that is not RNN-T."""
    r = bundle.cfg.rnnt
    if bundle.cfg.family != "rnnt" or r is None:
        return bundle, None
    if r.loss_vocab_chunk != 0:
        return bundle, r.loss_vocab_chunk
    unit_size = int(units["tokens"].shape[1])
    U = int(units["tokens"].shape[2])
    rows = int(batch_units) * unit_size * (U + 1) + int(r.joint_dim)
    tuned = auto_vocab_chunk(rows, int(r.vocab_size))
    if tuned >= int(r.vocab_size):
        return bundle, tuned
    cfg_new = dataclasses.replace(
        bundle.cfg, rnnt=dataclasses.replace(r, loss_vocab_chunk=tuned))
    return build_model(cfg_new), tuned


def plan_live_steps(plan) -> np.ndarray:
    """Host-side mask of a plan's real (non-padding) rows: a row of ids
    -1 is padding, excluded from the epoch's mean loss."""
    return np.asarray(plan[0])[:, 0] >= 0


def to_device(units: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in units.items()}


class HostEngine:
    """The per-batch host loop: one step per host-assembled batch, one
    evaluation per validation unit.  Units are kept on the host (to
    assemble batches) and on the device (for selection rounds).

    ``plan_salt`` re-keys the batch plans: the divergence watchdog bumps
    it so that a rolled-back run replays on other batch orders
    (``seed + 1_000_003 * plan_salt``).  With the guard on,
    ``last_skipped`` holds the last epoch's per-step skip flags and
    ``last_n_skipped`` their count."""

    def __init__(self, bundle, cfg: TrainConfig, units: Dict[str, np.ndarray],
                 val_units: Optional[Dict[str, np.ndarray]] = None,
                 batch_units: int = 1,
                 device: torch.device = torch.device("cpu")):
        bundle, self.loss_vocab_chunk = autotune_loss_vocab_chunk(
            bundle, units, batch_units)
        self.bundle = bundle
        self.cfg = cfg
        self.device = device
        self.batch_units = int(batch_units)
        self.units_host = {k: np.asarray(v) for k, v in units.items()}
        self.units = to_device(self.units_host, device)
        self.val_units = (None if val_units is None
                          else to_device(val_units, device))
        self.n_units = int(self.units_host["tokens"].shape[0])
        self.unit_size = int(self.units_host["tokens"].shape[1])
        self.guard = bool(cfg.nonfinite_guard)
        self.plan_salt = 0
        self.last_skipped: Optional[np.ndarray] = None
        self.last_n_skipped: Optional[int] = None
        self._step = make_step_core(bundle, cfg)

    def _plan_seed(self) -> int:
        return self.cfg.seed + 1_000_003 * self.plan_salt

    def full_plan(self, epoch: int):
        idx = epoch_plan(self.n_units, self._plan_seed(), epoch,
                         self.batch_units)
        return idx, np.ones(idx.shape, np.float32)

    def subset_plan(self, indices, weights, epoch: int):
        return subset_epoch_plan(np.asarray(indices), np.asarray(weights),
                                 self._plan_seed(), epoch, self.batch_units)

    def epoch_cost(self, use_full: bool = False,
                   n_selected: Optional[int] = None) -> float:
        """Paper-style charge: the fraction of units trained on."""
        if use_full or n_selected is None:
            return 1.0
        return float(n_selected) / self.n_units

    def run_epoch(self, params, opt_state, lr, plan):
        """Every plan row, padding rows included (a row of ids -1 runs on
        the last unit with weight 0, as the reference's host loop runs
        it) -> (params, opt_state, each row's loss)."""
        losses, skipped = [], []
        for sel, w in zip(*plan):
            batch = {k: v[sel].reshape((-1,) + v.shape[2:])
                     for k, v in self.units_host.items()}
            batch["weights"] = batch["weights"] * np.repeat(w, self.unit_size)
            params, opt_state, metrics = self._step(
                params, opt_state, to_device(batch, self.device), lr)
            losses.append(float(metrics["loss"]))
            if self.guard:
                skipped.append(float(metrics["skipped"]))
        if self.guard:
            self.last_skipped = np.asarray(skipped, np.float32)
            self.last_n_skipped = int(sum(skipped))
        return params, opt_state, np.asarray(losses, np.float64)

    def validate(self, params) -> float:
        if self.val_units is None:
            return float("nan")
        n_val = int(self.val_units["tokens"].shape[0])
        with torch.no_grad():
            return float(np.mean([
                float(self.bundle.per_example_loss(
                    params, {k: v[i] for k, v in self.val_units.items()}
                ).mean()) for i in range(n_val)]))
