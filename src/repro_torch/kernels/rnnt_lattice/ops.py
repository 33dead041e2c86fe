"""Wrapper of the RNN-T lattice kernel: CUDA tensors launch the Hopper
kernel (``csrc/rnnt_lattice.cu``), CPU tensors take the plain version
(``ref.py``).  Consumed by ``core/rnnt_loss.py`` for the alpha lattice of
every loss forward and the beta lattice of every backward.

The kernel replaces the Pallas TPU kernel
``src/repro/kernels/rnnt_lattice/kernel.py:rnnt_lattice``.  On the card it
is bound by latency, not bytes or operations: T dependent rows, each an
in-row scan.  So one warp owns one batch row and loops over T inside the
block; a ``cp.async`` ring keeps the next rows in shared memory
(:func:`ring_depth`); lane l owns ``q = ceil(U1 / 32)`` consecutive
columns, so a row is a sequential combine over the lane's columns, one
shuffle scan of the lanes' aggregates and a fix-up (the note in the
source has the details, :func:`lane_columns` the column split).

``rnnt_lattice_op.launches`` counts kernel launches (never plain-path
calls), so a run can show that its main path went through the kernel.
:func:`work` is its count for ``launch/op_analysis.py``, the same on
every route; fake or meta tensors (a dry run) take a shape-only route
that launches nothing.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.rnnt_lattice.ref import rnnt_lattice_ref

NAME = "rnnt_lattice"
WARP = 32
MAX_U1 = 12288
SMEM_MAX = 232448       # dynamic shared memory a block may take (H100)


def ring_depth(U1: int) -> int:
    """Rows the kernel's ring holds ahead (its ``ring_depth``): 16
    where the previous row and 16 slots of (mult, add, emit) fit in a
    block's shared memory, else the largest power of two that does (1 at
    ``MAX_U1``)."""
    for depth in (16, 8, 4, 2):
        if 4 * (-(-U1 // 4) * 4 + depth * 3 * U1) <= SMEM_MAX:
            return depth
    return 1


def lane_columns(U1: int):
    """[u0, u1) of each of the warp's 32 lanes: q = ceil(U1 / 32)
    consecutive columns a lane, empty past the row's end."""
    q = -(-U1 // WARP)
    return [(min(l * q, U1), min(l * q + q, U1)) for l in range(WARP)]


def work(cells: int):
    """(FLOPs, bytes) of one call over ``cells`` = T B U1 cells: a
    cell's two adds and two logaddexps of six operations each, its three
    inputs read and its output written (16 bytes)."""
    return 14 * cells, 16 * cells


def _launcher():
    fn = backend.library(NAME).rnnt_lattice_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rnnt_lattice_op(mult: torch.Tensor, add: torch.Tensor,
                    emit: torch.Tensor) -> torch.Tensor:
    """(T, B, U1) x3 fp32 -> lattice rows (T, B, U1) fp32."""
    with backend.kernel_work(NAME, *work(mult.numel())):
        if backend.shape_only(mult, add, emit):
            return torch.empty_like(mult)
        if not backend.on_card(mult, add, emit):
            return rnnt_lattice_ref(mult, add, emit)
        return _launch(mult, add, emit)


def _launch(mult, add, emit):
    for t in (mult, add, emit):
        backend.check_input(NAME, t, 3)
    if not (mult.shape == add.shape == emit.shape):
        raise ValueError(f"{NAME}: shapes differ: {tuple(mult.shape)}, "
                         f"{tuple(add.shape)}, {tuple(emit.shape)}")
    T, B, U1 = mult.shape
    if U1 > MAX_U1:
        raise ValueError(f"{NAME}: U1={U1} exceeds {MAX_U1}")
    out = torch.empty_like(mult)
    if out.numel() == 0:
        return out
    status = _launcher()(mult.data_ptr(), add.data_ptr(), emit.data_ptr(),
                         out.data_ptr(), T, B, U1,
                         backend.stream_handle(mult.device))
    backend.check(NAME, status)
    rnnt_lattice_op.launches += 1
    return out


rnnt_lattice_op.launches = 0
