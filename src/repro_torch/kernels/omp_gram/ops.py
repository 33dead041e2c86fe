"""Wrapper of the batched Gram kernel: CUDA tensors launch the Hopper
kernel (``csrc/omp_gram.cu``), CPU tensors take the plain version
(``ref.py``).  Consumed by ``core/pgm.py:partitioned_gm`` once per
selection round.

The kernel replaces the Pallas TPU kernel
``src/repro/kernels/omp_gram/kernel.py:omp_gram_batched``.  On the card it
is bound by operations at large n (2·P·n²·D fp32 FLOPs) and by bytes at
the stage-B path's tiny n; it is a tiled fp32 SIMT GEMM (64 x 64 output
tiles, K-slices staged through shared memory, register accumulators, no
TF32), one grid z-slice per partition (the note in the source has the
details).

``omp_gram_batched_op.launches`` counts kernel launches (never
plain-path calls).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.omp_gram.ref import omp_gram_batched_ref

NAME = "omp_gram"


def _launcher():
    fn = backend.library(NAME).omp_gram_batched_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def omp_gram_batched_op(g: torch.Tensor) -> torch.Tensor:
    """(P, n, D) fp32 -> (P, n, n) fp32 per-partition Gram matrices."""
    if not backend.on_card(g):
        return omp_gram_batched_ref(g)
    backend.check_input(NAME, g, 3)
    P, n, D = g.shape
    out = torch.empty((P, n, n), dtype=torch.float32, device=g.device)
    if out.numel() == 0:
        return out
    status = _launcher()(g.data_ptr(), out.data_ptr(), P, n, D,
                         backend.stream_handle(g.device))
    backend.check(NAME, status)
    omp_gram_batched_op.launches += 1
    return out


omp_gram_batched_op.launches = 0
