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
axis.  An RG-LRU layer's ``rec`` leaves cross the same way: ``w_in``,
``w_gate_branch`` (d, w), ``conv_w`` (cw, w), ``conv_b``, ``ba``, ``bx``,
``lam`` (w,), ``wa``, ``wx`` (w, w) and ``w_out`` (w, d).  The round trip
is bit-exact.

Decode caches differ in one layout decision of the port (ROADMAP, the
cache layout): every leaf has the batch first, so a group leaf is (B,
n_groups, ...) where the reference's is (n_groups, B, ...), and an
attention cache's next position ``t`` is per row where the reference
keeps one a layer.  :func:`cache_from_numpy` moves a reference cache
(KV caches, RG-LRU ``h``/``conv``, RWKV6 ``S``/``x_tmix``/``x_cmix``)
into the port's layout.

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


def cache_from_numpy(cache: Any, device="cpu") -> Any:
    """The reference's LM decode cache (``{"groups": (...), "tail":
    (...)}`` of numpy arrays) -> the port's: each group leaf's layer axis
    moved behind the batch, each layer's ``t`` repeated over the rows;
    dtypes kept."""
    def move(entry, group: bool):
        B = next(np.shape(v)[1 if group else 0]
                 for k, v in entry.items() if k != "t")
        out = {}
        for k, v in entry.items():
            v = np.asarray(v)
            if k == "t":
                v = np.broadcast_to(v, (B,) + v.shape)
            elif group:
                v = np.moveaxis(v, 0, 1)
            out[k] = from_numpy(np.ascontiguousarray(v), device)
        return out

    return {"groups": tuple(move(e, True) for e in cache["groups"]),
            "tail": tuple(move(e, False) for e in cache["tail"])}
