"""Cross-pod gradient compression on ``torch.distributed`` (the
reference's ``train/compress.py``).

Two compressors of the all-reduce-mean over the slow ``pod`` axis:

* bf16: the leaves are cast to bf16 *before* the reduce, so the wire
  carries bf16; the mean is taken in bf16 (a bf16 sum, then a bf16
  division by the pod count) and widened to fp32 after (ROADMAP hazard
  D3);
* top-k with error feedback (Stich et al. 2018): exactly ``k = max(int(
  size * k_frac), 1)`` entries of each whole leaf are sent, chosen by
  ``torch.topk`` indices and a scatter (a threshold ``|g| >= kth`` would
  send more on ties, and the whole leaf when the k-th largest is 0); the
  rest is kept as the residual and added to the next step's gradient,
  so ``sent + new_err == g + old_err`` bit for bit (D2).  Which of tied
  entries ``torch.topk`` takes is not the order JAX's ``top_k`` takes:
  the count and the invariant are what hold.

``compressed_psum(grads, group, mode, err, k_frac)`` runs a compressor
into an all-reduce over a process group (the pod axis's group); with
``group=None`` it runs over the default group.  A tree is flattened into
one buffer for the collective.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten

MODES = ("none", "bf16", "topk")



def bf16_compress(g):
    return tree_map(lambda l: l.to(torch.bfloat16), g)


def topk_compress(g, err, k_frac: float = 0.05):
    """-> ``(sent, new_err)``: ``sent`` has the leaf's dense shape, zero
    off the k entries of largest ``|g + err|``; ``new_err`` is the rest,
    exactly (0 on the support, ``g + err`` off it)."""

    def one(l, e):
        flat = (l.to(torch.float32) + e).reshape(-1)
        k = max(int(flat.numel() * k_frac), 1)
        idx = torch.topk(torch.abs(flat), k, sorted=False).indices
        sent = torch.zeros_like(flat).index_copy_(0, idx, flat[idx])
        return sent.reshape(l.shape), (flat - sent).reshape(l.shape)

    out = [one(l, e) for l, e in zip(tree_leaves(g), tree_leaves(err))]
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
                    k_frac: float = 0.05):
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
    sent, new_err = topk_compress(grads, err, k_frac)
    red = _mean(tree_leaves(sent), group, n, torch.float32)
    return tree_unflatten(grads, red), new_err
