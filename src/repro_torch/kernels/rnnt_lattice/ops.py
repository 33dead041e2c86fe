"""Wrapper of the RNN-T lattice kernel: CUDA tensors launch the Hopper
kernel (``csrc/rnnt_lattice.cu``), CPU tensors take the plain version
(``ref.py``).  Consumed by ``core/rnnt_loss.py`` for the alpha lattice of
every loss forward and the beta lattice of every backward.

The kernel replaces the Pallas TPU kernel
``src/repro/kernels/rnnt_lattice/kernel.py:rnnt_lattice``.  On the card it
is bound by latency, not bytes or operations: T dependent rows, each an
in-row scan.  So one warp owns one batch row, loops over T inside the
block, and scans each row with warp shuffles in 32-wide pieces with a
carried prefix (the note in the source has the details).

``rnnt_lattice_op.launches`` counts kernel launches (never plain-path
calls), so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.rnnt_lattice.ref import rnnt_lattice_ref

NAME = "rnnt_lattice"
# one warp per batch row keeps the previous row in (default, <= 48 KB)
# shared memory
MAX_U1 = 12288


def _launcher():
    fn = backend.library(NAME).rnnt_lattice_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rnnt_lattice_op(mult: torch.Tensor, add: torch.Tensor,
                    emit: torch.Tensor) -> torch.Tensor:
    """(T, B, U1) x3 fp32 -> lattice rows (T, B, U1) fp32."""
    if not backend.on_card(mult, add, emit):
        return rnnt_lattice_ref(mult, add, emit)
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
