"""Cross-pod gradient compression on ``torch.distributed`` (the
reference's ``train/compress.py``).

Two compressors of the all-reduce-mean over the slow ``pod`` axis:

* bf16: the leaves are cast to bf16 *before* the reduce, so the wire
  carries bf16; the mean is taken in bf16 (a bf16 sum, then a bf16
  division by the pod count) and widened to fp32 after (ROADMAP hazard
  D3);
* top-k with error feedback (Stich et al. 2018): exactly ``k = max(int(
  size * k_frac), 1)`` entries of each whole leaf are sent (a threshold
  ``|g| >= kth`` would send more on ties, and the whole leaf when the
  k-th largest is 0): every entry above the k-th largest ``|g|``, then
  the entries equal to it in index order until k, which is the set
  JAX's ``top_k`` picks (ties to the lower index).  The rest is kept as
  the residual and added to the next step's gradient, so ``sent +
  new_err == g + old_err`` bit for bit (D2).  On a mesh's shards
  (``sharding/fsdp.py``) the k are those of the whole leaf (hazard S4):
  each rank's top candidates of its block, gathered over the leaf's
  storage group, give the k-th largest, and the first tied entries in
  the whole leaf's index order are found the same way, so a shard sends
  exactly its part of the whole leaf's selection.

``compressed_psum(grads, group, mode, err, k_frac, layouts)`` runs a
compressor into an all-reduce over a process group (the pod axis's
group); with ``group=None`` it runs over the default group.  A tree is
flattened into one buffer for the collective.  ``layouts`` (one a leaf,
None for a whole leaf) are the leaves' storage on a mesh.
"""
from __future__ import annotations

import math
from typing import Optional


import torch
import torch.distributed as dist

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten

MODES = ("none", "bf16", "topk")



def bf16_compress(g):
    return tree_map(lambda l: l.to(torch.bfloat16), g)


def _flat_index(lay, device) -> torch.Tensor:
    """The whole leaf's flat (C-order) index of each entry of this rank's
    block, in the block's C order."""
    idx = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for sl, n in reversed(list(zip(lay.mine, lay.shape))):
        ar = torch.arange(sl.start, sl.stop, dtype=torch.int64,
                          device=device) * stride
        idx = ar.reshape((-1,) + (1,) * idx.dim()) + idx
        stride *= n
    return idx.reshape(-1)


def _gathered(t: torch.Tensor, group) -> torch.Tensor:
    out = t.new_empty((dist.get_world_size(group) * t.numel(),))
    dist.all_gather_into_tensor(out, t.reshape(-1), group=group)
    return out


def _topk_mask(a: torch.Tensor, k: int, lay=None) -> torch.Tensor:
    """The entries of JAX's ``top_k(a, k)`` of the whole leaf (ties to the
    lower index) as a mask of ``a`` (flat): this rank's block of it on a
    mesh (``lay``).  A storage group of one holds the whole leaf, which
    takes the one-device route."""
    if lay is not None and len(lay.parts) == 1:
        lay = None
    kl = min(k, a.numel())
    cand = torch.topk(a, kl, sorted=False).values
    if lay is None:
        kth = cand.min()
        eq = a == kth
        need = k - (a > kth).sum()
        dt = torch.int32 if a.numel() < 2 ** 31 else torch.int64
        return (a > kth) | (eq & (torch.cumsum(eq, 0, dtype=dt) <= need))
    cand = _gathered(cand, lay.group)
    kth = torch.topk(cand, k, sorted=False).values.min()
    gt = a > kth
    eq = a == kth
    # every entry above the k-th is among some block's top kl
    need = k - (cand > kth).sum()
    gidx = _flat_index(lay, a.device)
    tied = torch.where(eq, gidx, torch.iinfo(torch.int64).max)
    first = _gathered(torch.topk(tied, kl, largest=False,
                                 sorted=False).values, lay.group)
    # the need-th smallest, read on the device (a captured step reads
    # nothing back)
    last = torch.sort(first).values.index_select(
        0, torch.clamp(need - 1, min=0).reshape(1))
    return gt | (eq & (gidx <= last) & (need > 0))


def topk_compress(g, err, k_frac: float = 0.05, layouts=None):
    """-> ``(sent, new_err)``: ``sent`` has the leaf's dense shape, zero
    off the k entries of largest ``|g + err|`` (JAX's tie order); the k
    of the whole leaf where ``layouts`` gives a leaf's storage on a mesh.
    ``new_err`` is the rest, exactly (0 on the support, ``g + err`` off
    it)."""
    leaves = tree_leaves(g)
    lays = [None] * len(leaves) if layouts is None else layouts

    def one(l, e, lay):
        flat = (l.to(torch.float32) + e).reshape(-1)
        n = flat.numel() if lay is None else math.prod(lay.shape)
        k = max(int(n * k_frac), 1)
        take = _topk_mask(torch.abs(flat), k, lay)
        sent = torch.where(take, flat, torch.zeros_like(flat))
        return sent.reshape(l.shape), (flat - sent).reshape(l.shape)

    out = [one(l, e, lay) for l, e, lay in zip(leaves, tree_leaves(err),
                                               lays)]
    return (tree_unflatten(g, [o[0] for o in out]),
            tree_unflatten(g, [o[1] for o in out]))


def init_error_state(params, n_pods: Optional[int] = None):
    """Zero error-feedback state mirroring ``params``; with ``n_pods``
    every leaf gains a leading pod dim (what the checkpoint holds under
    ``err``)."""
    lead = () if n_pods is None else (int(n_pods),)
    return tree_map(lambda p: torch.zeros(lead + tuple(p.shape),
                                          dtype=torch.float32,
                                          device=p.device), params)


def _mean(leaves, group, n: int, dtype):
    """All-reduce-mean of a list of leaves as one ``dtype`` buffer (the
    sum over the group, then a division by ``n`` in ``dtype``)."""
    flat = torch.cat([l.reshape(-1).to(dtype) for l in leaves])
    dist.all_reduce(flat, group=group)
    flat = flat / n
    out, at = [], 0
    for l in leaves:
        out.append(flat[at:at + l.numel()].reshape(l.shape))
        at += l.numel()
    return out


def compressed_psum(grads, group=None, mode: str = "bf16", err=None,
                    k_frac: float = 0.05, layouts=None):
    """All-reduce-mean ``grads`` over ``group`` with the ``mode``
    compressor -> ``(mean grads in fp32, new error state)``; ``err`` is
    used by ``topk`` only and returned as it is by the other modes."""
    if mode not in MODES:
        raise ValueError(mode)
    n = dist.get_world_size(group)
    leaves = tree_leaves(grads)
    if mode == "none":
        red = _mean(leaves, group, n, torch.float32)
        return tree_unflatten(grads, red), err
    if mode == "bf16":
        red = _mean(leaves, group, n, torch.bfloat16)
        return tree_unflatten(grads, [l.to(torch.float32) for l in red]), err
    sent, new_err = topk_compress(grads, err, k_frac, layouts)
    red = _mean(tree_leaves(sent), group, n, torch.float32)
    return tree_unflatten(grads, red), new_err
