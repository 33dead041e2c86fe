"""Initializers and params-dict helpers of the port.

``dense_init``/``embed_init`` are the reference's
(``models/common.py``) with a ``torch.Generator`` in place of a
``jax.random`` key.  Draws happen on the CPU generator and the result is
moved to the target device, so a seed gives the same parameters on the
CPU and on the card.  Params are nested dicts of tensors with the
reference's key layout and (in, out) weight layout.
"""
from __future__ import annotations

import math
from typing import List

import torch


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               device: torch.device, scale: float = 1.0) -> torch.Tensor:
    std = scale / math.sqrt(d_in)
    return (torch.randn((d_in, d_out), generator=gen) * std).to(device)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               device: torch.device) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen).to(device)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nested dict in sorted-key order (the order JAX
    flattens a dict pytree in)."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over nested dicts of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)
