"""Selection units and (seed, epoch)-keyed batch plans.

A copy of the reference's numpy pipeline (``lm_units``, ``asr_units``,
``unit_durations``, ``epoch_plan``, ``subset_epoch_plan``): units are
fixed mini-batches (the paper's PerBatch granularity) stacked as
``(n_units, unit_size, ...)`` arrays, and every plan is a pure function
of ``(seed, epoch)``, so both packages see byte-identical batch orders.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.data.synthetic import ASRCorpus, LMCorpus


def lm_units(corpus: LMCorpus, unit_size: int) -> Dict[str, np.ndarray]:
    """-> dict with leading (n_units, unit_size, ...) arrays."""
    n = (corpus.tokens.shape[0] // unit_size) * unit_size
    toks = corpus.tokens[:n]
    lens = corpus.lengths[:n]
    S = toks.shape[1]
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.float32)
    nu = n // unit_size
    return {
        "tokens": toks.reshape(nu, unit_size, S).astype(np.int32),
        "loss_mask": mask.reshape(nu, unit_size, S),
        "weights": np.ones((nu, unit_size), np.float32),
    }


def asr_units(corpus: ASRCorpus, unit_size: int) -> Dict[str, np.ndarray]:
    n = (corpus.feats.shape[0] // unit_size) * unit_size
    nu = n // unit_size
    sh = lambda a: a[:n].reshape((nu, unit_size) + a.shape[1:])
    return {
        "feats": sh(corpus.feats).astype(np.float32),
        "feat_lens": sh(corpus.feat_lens).astype(np.int32),
        "tokens": sh(corpus.tokens).astype(np.int32),
        "token_lens": sh(corpus.token_lens).astype(np.int32),
        "weights": np.ones((nu, unit_size), np.float32),
    }


def unit_durations(units: Dict[str, np.ndarray]) -> np.ndarray:
    """Per-unit total duration (for the LargeOnly/LargeSmall baselines):
    frames for ASR units, loss-bearing tokens for LM units."""
    if "feat_lens" in units:
        return units["feat_lens"].sum(axis=1).astype(np.float32)
    return units["loss_mask"].sum(axis=(1, 2)).astype(np.float32)


def epoch_plan(n_units: int, seed: int, epoch: int,
               batch_units: int = 1) -> np.ndarray:
    """Full-data epoch schedule -> (n_steps, batch_units) int32 unit ids:
    a seeded shuffle of all units, remainder dropped."""
    order = np.random.default_rng((seed, epoch)).permutation(n_units)
    n_steps = n_units // batch_units
    return order[: n_steps * batch_units].reshape(
        n_steps, batch_units).astype(np.int32)


def subset_epoch_plan(indices, weights, seed: int, epoch: int,
                      batch_units: int = 1,
                      pad_to_steps: Optional[int] = None,
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Weighted-subset epoch schedule -> (unit ids, unit weights), each
    ``(n_steps, batch_units)``: drops -1 padding from the selection,
    shuffles the survivors with the (seed, epoch, 1) stream, drops the
    remainder; ``pad_to_steps`` pads with id -1 / weight 0 rows."""
    valid = np.asarray(indices) >= 0
    idx = np.asarray(indices)[valid]
    w = np.asarray(weights)[valid]
    order = np.random.default_rng((seed, epoch, 1)).permutation(len(idx))
    idx, w = idx[order], w[order]
    n_steps = len(idx) // batch_units
    shape = (n_steps, batch_units)
    plan_idx = idx[: n_steps * batch_units].reshape(shape).astype(np.int32)
    plan_w = w[: n_steps * batch_units].reshape(shape).astype(np.float32)
    if pad_to_steps is not None:
        if n_steps > pad_to_steps:
            raise ValueError(
                f"subset plan needs {n_steps} steps > pad_to_steps="
                f"{pad_to_steps}")
        n_pad = pad_to_steps - n_steps
        plan_idx = np.concatenate(
            [plan_idx, np.full((n_pad, batch_units), -1, np.int32)])
        plan_w = np.concatenate(
            [plan_w, np.zeros((n_pad, batch_units), np.float32)])
    return plan_idx, plan_w
