"""Vocab pad/reshape/validity chunking layout of the fused RNN-T loss.

The port of the reference's ``core/chunking.py``: the head is streamed
chunk by chunk so no ``(..., V)`` row is ever fully live.  The vocab
axis is zero-padded up to ``n_chunks * chunk`` and split into
``(n_chunks, chunk)`` with ``n_chunks`` in front; the validity mask marks
the real columns — consumers mask padded columns before any
softmax/logsumexp, since a zero-padded logit is a real score of 0.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

# One budget for the streamed (rows, chunk) slab, the reference's value,
# kept so the port resolves the same chunk width as the reference.
VMEM_BUDGET_BYTES = 8 * 1024 * 1024
LANE = 128


def resolve_vocab_chunk(V: int, chunk: int) -> int:
    """Effective chunk width: ``<= 0`` means one chunk of the whole
    vocab; larger-than-vocab requests are capped at ``V``."""
    return V if chunk <= 0 else min(int(chunk), V)


def auto_vocab_chunk(n_rows: int, V: int, *, dtype_bytes: int = 4,
                     budget_bytes: int = VMEM_BUDGET_BYTES,
                     lane: int = LANE) -> int:
    """``V`` when the whole ``(n_rows, V)`` slab fits the budget, else
    the largest lane-aligned chunk whose slab fits (at least one lane)."""
    n_rows = max(int(n_rows), 1)
    if n_rows * V * dtype_bytes <= budget_bytes:
        return V
    chunk = budget_bytes // (n_rows * dtype_bytes)
    chunk = max((chunk // lane) * lane, lane)
    return min(chunk, V)


def n_vocab_chunks(V: int, chunk: int) -> int:
    return -(-V // chunk)


def vocab_chunk_mask(V: int, chunk: int,
                     device: torch.device = torch.device("cpu")
                     ) -> torch.Tensor:
    """Column-validity mask ``(n_chunks, chunk)``."""
    nc = n_vocab_chunks(V, chunk)
    return (torch.arange(nc * chunk, device=device) < V).reshape(nc, chunk)


def chunk_vocab_axis(x: torch.Tensor, chunk: int, axis: int = -1
                     ) -> torch.Tensor:
    """Zero-pad ``x`` along ``axis`` to a multiple of ``chunk`` and split
    that axis into ``(n_chunks, chunk)`` with ``n_chunks`` moved to the
    front: ``(d, V)`` with ``axis=1`` -> ``(nc, d, chunk)``."""
    axis = axis % x.dim()
    V = x.shape[axis]
    nc = n_vocab_chunks(V, chunk)
    pad = [0, 0] * x.dim()
    pad[2 * (x.dim() - 1 - axis) + 1] = nc * chunk - V
    xp = F.pad(x, pad)
    xp = xp.reshape(x.shape[:axis] + (nc, chunk) + x.shape[axis + 1:])
    return xp.movedim(axis, 0)


def vocab_chunks(x: torch.Tensor, chunk: int, axis: int = -1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(chunked x, validity mask)`` in one call."""
    return (chunk_vocab_axis(x, chunk, axis),
            vocab_chunk_mask(x.shape[axis % x.dim()], chunk, x.device))
