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
``lam`` (w,), ``wa``, ``wx`` (w, w) and ``w_out`` (w, d).  The
encoder-decoder's tree crosses the same way: ``encoder`` and ``decoder``
dicts stacked on a leading layer axis (an encoder layer ``ln1``,
``attn``, ``ln2``, ``mlp``; a decoder layer ``ln1``, ``self``, ``lnx``,
``cross``, ``ln2``, ``mlp``), ``enc_norm``, ``final_norm``, ``embed``.
The round trip is bit-exact.

Decode caches differ in one layout decision of the port (ROADMAP, the
cache layout): every leaf has the batch first, so a group leaf is (B,
n_groups, ...) where the reference's is (n_groups, B, ...), and an
attention cache's next position ``t`` is per row where the reference
keeps one a layer.  :func:`cache_from_numpy` moves a reference cache
(KV caches, RG-LRU ``h``/``conv``, RWKV6 ``S``/``x_tmix``/``x_cmix``,
and the encoder-decoder's ``{"self", "ck", "cv"}``, every leaf stacked
layer-first) into the port's layout, and :func:`cache_to_numpy` back.

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
    (dtypes kept; a bfloat16 array, ``ml_dtypes``' type, crosses by its
    bits)."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(from_numpy(v, device) for v in tree)
    a = np.array(tree, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes        # numpy's bfloat16, only where one is asked
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_numpy(tree: Any) -> Any:
    """Tree of tensors -> the same tree of numpy arrays (a bfloat16 leaf
    as an ``ml_dtypes`` bfloat16 array, bit for bit)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    return _array(tree)


def _move(entry, group: bool, device):
    """One reference cache entry (a dict of arrays, and of dicts) -> the
    port's: a stacked leaf's layer axis behind the batch, ``t`` (one a
    layer) repeated over the rows."""
    B = next(np.shape(v)[1 if group else 0]
             for k, v in entry.items() if k != "t" and not isinstance(v, dict))
    out = {}
    for k, v in entry.items():
        if isinstance(v, dict):
            out[k] = _move(v, group, device)
            continue
        v = np.asarray(v)
        if k == "t":
            v = np.broadcast_to(v, (B,) + v.shape)
        elif group:
            v = np.moveaxis(v, 0, 1)
        out[k] = from_numpy(np.ascontiguousarray(v), device)
    return out


def _unmove(entry, group: bool):
    """``_move``'s inverse; a ``t`` must be one value over the rows."""
    out = {}
    for k, v in entry.items():
        if isinstance(v, dict):
            out[k] = _unmove(v, group)
            continue
        v = _array(v)
        if k == "t":
            if not (v == v[:1]).all():
                raise ValueError("the reference's cache keeps one t a "
                                 "layer: the rows' positions differ")
            v = v[0]
        elif group:
            v = np.moveaxis(v, 1, 0)
        out[k] = np.ascontiguousarray(v)
    return out


def cache_from_numpy(cache: Any, device="cpu") -> Any:
    """The reference's decode cache of numpy arrays -> the port's: an LM's
    ``{"groups": (...), "tail": (...)}`` (each group leaf's layer axis
    moved behind the batch) or an encoder-decoder's ``{"self", "ck",
    "cv"}`` (every leaf's); each layer's ``t`` repeated over the rows;
    dtypes kept."""
    if "self" in cache:
        return _move(cache, True, device)
    return {"groups": tuple(_move(e, True, device) for e in cache["groups"]),
            "tail": tuple(_move(e, False, device) for e in cache["tail"])}


def cache_to_numpy(cache: Any) -> Any:
    """``cache_from_numpy``'s inverse: the port's cache -> the reference's
    layout in numpy (every row of a layer at one position)."""
    if "self" in cache:
        return _unmove(cache, True)
    return {"groups": tuple(_unmove(e, True) for e in cache["groups"]),
            "tail": tuple(_unmove(e, False) for e in cache["tail"])}
