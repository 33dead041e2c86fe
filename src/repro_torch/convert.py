"""Weights across the two packages.

The reference's params are a pytree of arrays: nested dicts, and for the
decoder LMs tuples too (``stack.groups`` is a tuple of dicts stacked on a
leading layer axis, ``stack.tail`` a tuple of per-layer dicts).  The
port's params are the same tree of tensors, with the same keys, the same
sequences, the same stacked layout and the same (in, out) weight layouts,
so the conversion is a leafwise copy through numpy and nothing is
transposed.  An MoE layer's leaves cross the same way: ``moe.router``
(d, E), ``moe.w_in`` and ``moe.w_gate`` (E, d, d_ff_expert),
``moe.w_out`` (E, d_ff_expert, d), each stacked on its group's layer
axis.  The round trip is bit-exact.

Checkpoints cross the same way: both packages write the same format
(``train/checkpoint.py``), keyed by each leaf's ``keystr`` path, so
``checkpoint.restore(template=...)`` of either package restores the
other's checkpoint, and ``train_with_selection(resume=True)`` resumes
from it.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def from_numpy(tree: Any, device="cpu") -> Any:
    """Tree of numpy arrays -> the same tree of tensors on ``device``
    (dtypes kept)."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(from_numpy(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def to_numpy(tree: Any) -> Any:
    """Tree of tensors -> the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()
