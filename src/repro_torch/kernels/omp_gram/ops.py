"""Wrapper of the batched Gram kernel: CUDA tensors launch the Hopper
kernel (``csrc/omp_gram.cu``), CPU tensors take the plain version
(``ref.py``).  Consumed by ``core/pgm.py:partitioned_gm`` once per
selection round.

The kernel replaces the Pallas TPU kernel
``src/repro/kernels/omp_gram/kernel.py:omp_gram_batched``.  On the card it
is bound by latency at the stage-B path's tiny n and by operations from n
in the hundreds (the upper triangle's P·n·(n+1)·D fp32 FLOPs, no TF32).  It computes the
upper-triangle tiles only and writes each with its mirror (K is exactly
symmetric), in fp32 SIMT register tiles sized to n, and splits D across
blocks when the tiles alone cannot fill the card; a second kernel adds
the split partials in order (the note in the source has the details).
:func:`gram_plan` picks the tile and the split from (P, n, D) and the
card's SM count.

``omp_gram_batched_op.launches`` counts launches of the Gram kernel
(never plain-path calls; the partials' reduction rides on the same
count).  :func:`work` is its count for ``launch/op_analysis.py``, the
same on every route; fake or meta tensors (a dry run) take a shape-only
route that launches nothing.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.omp_gram.ref import omp_gram_batched_ref

NAME = "omp_gram"
BK = 32                  # D columns a pipeline step (csrc/omp_gram.cu)
BLOCKS_PER_SM = 2        # the kernel's __launch_bounds__ occupancy


class GramPlan(NamedTuple):
    tile: int            # output tile side: 32 (n <= 32) or 128
    n_side: int          # tiles along n
    n_tiles: int         # upper-triangle tiles (ti <= tj) a partition
    splits: int          # D slices, one block each per tile
    slice: int           # columns a slice (a multiple of BK)
    scratch: int         # floats of partial tiles (0 with one split)


def gram_plan(P: int, n: int, D: int, n_sm: int = 132) -> GramPlan:
    """The launch plan for a (P, n, D) Gram on a card of ``n_sm`` SMs: a
    tile sized to n, then as many D slices as keep P x tiles x splits
    blocks within one wave of ``BLOCKS_PER_SM`` blocks an SM (one slice
    when the tiles alone fill it)."""
    tile = 32 if n <= 32 else 128
    n_side = -(-n // tile)
    n_tiles = n_side * (n_side + 1) // 2
    steps = max(1, -(-D // BK))
    splits = max(1, min(steps, BLOCKS_PER_SM * n_sm // (P * n_tiles)))
    slice_ = -(-steps // splits) * BK
    splits = max(1, -(-D // slice_))
    scratch = splits * P * n_tiles * tile * tile if splits > 1 else 0
    return GramPlan(tile, n_side, n_tiles, splits, slice_, scratch)


def gram_tile(t: int, n_side: int):
    """Upper-triangle tile t -> (ti, tj), row by row, as the kernel
    walks them (``csrc/omp_gram.cu:tile_of``)."""
    ti = 0
    while t >= n_side - ti:
        t -= n_side - ti
        ti += 1
    return ti, ti + t


def work(P: int, n: int, D: int):
    """(FLOPs, bytes) of one (P, n, D) Gram: the upper triangle's
    P n (n+1) D FLOPs, g read and the (P, n, n) Grams written."""
    return P * n * (n + 1) * D, 4 * (P * n * D + P * n * n)


@functools.cache
def _launcher():
    fn = backend.library(NAME).omp_gram_batched_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def omp_gram_batched_op(g: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """(P, n, D) fp32 -> (P, n, n) fp32 per-partition Gram matrices.
    ``impl`` is ``PGMConfig.kernel_impl`` (``backend.use_kernel``:
    ``"xla"`` runs the plain version on the card)."""
    with backend.kernel_work(NAME, *work(*g.shape)):
        if backend.shape_only(g):
            return g.new_empty((g.shape[0], g.shape[1], g.shape[1]))
        if not backend.use_kernel(impl, g):
            return omp_gram_batched_ref(g)
        return _launch(g)


def _launch(g: torch.Tensor) -> torch.Tensor:
    backend.check_input(NAME, g, 3)
    P, n, D = g.shape
    out = torch.empty((P, n, n), dtype=torch.float32, device=g.device)
    if out.numel() == 0:
        return out
    if D == 0:
        return out.zero_()
    plan = gram_plan(P, n, D, _sm_count(g.device))
    part = (torch.empty(plan.scratch, dtype=torch.float32, device=g.device)
            if plan.scratch else None)
    status = _launcher()(g.data_ptr(), out.data_ptr(),
                         None if part is None else part.data_ptr(), P, n, D,
                         plan.tile, plan.splits, plan.slice,
                         backend.stream_handle(g.device))
    backend.check(NAME, status)
    omp_gram_batched_op.launches += 1
    return out


omp_gram_batched_op.launches = 0
