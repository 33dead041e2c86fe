"""Wrapper of the fused grad-sketch kernel: CUDA tensors launch the Hopper
kernel (``csrc/grad_sketch.cu``), CPU tensors take the plain streamed
path (``core/lastlayer.py:streamed_er2`` and a segment contraction, the
reference's ``xla`` branch).  Consumed by ``core/lastlayer.py:
lm_unit_sketch`` once per unit of every LM selection round (stage A).

The kernel replaces the Pallas TPU kernel
``src/repro/kernels/grad_sketch/kernel.py:grad_sketch_units``.  On the
card it is bound by operations (one h.W product over the whole vocab).
It runs that product and p.R2 on the tensor cores as 3xTF32 (each
operand split into a TF32 hi and lo part, three products a pair, each K
slice into an fp32 accumulator of its own, which keeps fp32 accuracy):
128 x 128 tiles of ``wgmma`` fed by a ``cp.async`` ring, an online
softmax in the epilogue, p.R2 on ``mma.sync``; one pass over the vocab
split across blocks so one unit fills the card, and the partials merged
in a fixed order (the note in the source has the details).

The kernel reads the head as contiguous (V, d) rows, so on the card
``w`` must be the transpose of a contiguous (V, d) tensor: the tied
embedding's ``embed.w.t()`` is, an untied (d, V) head is copied by the
caller (``lm_unit_sketch``).

``grad_sketch_units_op.launches`` counts kernel launches (never
plain-path calls); ``grad_sketch_op`` is its U = 1 case.  :func:`work`
is its count for ``launch/op_analysis.py``, the same on every route;
fake or meta tensors (a dry run) take a shape-only route that launches
nothing.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.lastlayer import streamed_er2
from repro_torch.kernels import backend

NAME = "grad_sketch"
BM = BN = 128           # the kernel's row and vocab tiles
SLAB = 128              # rows of one block of the hr^T er2 contraction
TARGET_BLOCKS = 528     # blocks the vocab split aims at (4 waves of one
                        # 212 KB block on each of 132 SMs)
MAX_K2 = 512            # k2 is cut into chunks of 64 over the grid
PLAIN_VOCAB_CHUNK = 8192  # the CPU path's streaming width over the vocab


def _launcher():
    fn = backend.library(NAME).grad_sketch_units_launch
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def work(U: int, n: int, d: int, V: int, k1: int, k2: int):
    """(FLOPs, bytes) of one call: the function's four products h.W,
    p.R2, h.R1 and hr^T er2; h, w, r_h, r_v, targets and scale read
    once, the sketch written once."""
    flops = 2 * U * n * (d * V + V * k2 + d * k1 + k1 * k2)
    n_bytes = 4 * (U * n * d + d * V + d * k1 + V * k2 + 2 * U * n
                   + U * k1 * k2)
    return flops, n_bytes


def vocab_splits(U: int, n: int, V: int):
    """(splits, vocab tiles per split): enough splits of the vocab tiles
    that splits x row tiles x units reaches ``TARGET_BLOCKS``, none empty.
    A function of the shapes only, so a launch's summation order (and so
    its bits) does not depend on the card."""
    n_tiles = -(-V // BN)
    row_tiles = -(-n // BM)
    want = min(n_tiles, max(1, -(-TARGET_BLOCKS // (row_tiles * U))))
    per = -(-n_tiles // want)
    return -(-n_tiles // per), per


def _plain(h, w, r_h, r_v, targets, scale, vocab_chunk):
    U, n, d = h.shape
    k1, k2 = r_h.shape[1], r_v.shape[1]
    hf = h.reshape(-1, d).to(torch.float32)
    er2 = streamed_er2(hf, w, targets.reshape(-1).long(),
                       scale.reshape(-1).to(torch.float32), r_v,
                       vocab_chunk)
    hr = hf @ r_h.to(torch.float32)
    return torch.einsum("unk,unl->ukl", hr.reshape(U, n, k1),
                        er2.reshape(U, n, k2))


def grad_sketch_units_op(h: torch.Tensor, w: torch.Tensor,
                         r_h: torch.Tensor, r_v: torch.Tensor,
                         targets: torch.Tensor, scale: torch.Tensor,
                         vocab_chunk: int = PLAIN_VOCAB_CHUNK,
                         impl: str = "auto") -> torch.Tensor:
    """Per-unit fused sketch: h (U,n,d); w (d,V); r_h (d,k1); r_v (V,k2);
    targets, scale (U,n) -> (U, k1, k2) fp32.  ``vocab_chunk`` is the
    plain path's streaming width; the kernel tiles the vocab its own
    way.  ``impl`` is ``PGMConfig.kernel_impl`` (``backend.use_kernel``:
    ``"xla"`` runs the plain path on the card)."""
    U, n, d = h.shape
    V, k1, k2 = w.shape[-1], r_h.shape[-1], r_v.shape[-1]
    with backend.kernel_work(NAME, *work(U, n, d, V, k1, k2)):
        if backend.shape_only(h, w, r_h, r_v, targets, scale):
            return h.new_empty((U, k1, k2), dtype=torch.float32)
        if not backend.use_kernel(impl, h, w, r_h, r_v, targets, scale):
            return _plain(h, w, r_h, r_v, targets, scale, vocab_chunk)
        return _launch(h, w, r_h, r_v, targets, scale)


def _launch(h, w, r_h, r_v, targets, scale) -> torch.Tensor:
    backend.check_input(NAME, h, 3)
    wt = w.t()
    backend.check_input(NAME, wt, 2)
    backend.check_input(NAME, r_h, 2)
    backend.check_input(NAME, r_v, 2)
    backend.check_input(NAME, scale, 2)
    U, n, d = h.shape
    V, k1, k2 = wt.shape[0], r_h.shape[1], r_v.shape[1]
    if (wt.shape[1], r_h.shape[0], r_v.shape[0]) != (d, d, V) \
            or tuple(targets.shape) != (U, n) \
            or tuple(scale.shape) != (U, n) or V == 0:
        raise ValueError(f"{NAME}: inconsistent shapes h {tuple(h.shape)} "
                         f"w {tuple(w.shape)} r_h {tuple(r_h.shape)} r_v "
                         f"{tuple(r_v.shape)} targets "
                         f"{tuple(targets.shape)} scale "
                         f"{tuple(scale.shape)}")
    if targets.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{NAME}: targets must be int32/int64, got "
                        f"{targets.dtype}")
    if not 0 < k2 <= MAX_K2 or k1 <= 0:
        raise ValueError(f"{NAME}: sketch dims k1 {k1}, k2 {k2} outside "
                         f"(0, {MAX_K2}]")
    out = torch.empty((U, k1, k2), dtype=torch.float32, device=h.device)
    if n == 0 or U == 0:
        return out.zero_()
    # the reference's host-side precomputations (kernel.py:124-126)
    hr = (h @ r_h).contiguous()                                # (U, n, k1)
    rvt = r_v[targets.long().clamp(0, V - 1)].contiguous()     # (U, n, k2)
    S, per = vocab_splits(U, n, V)
    f32 = dict(dtype=torch.float32, device=h.device)
    m_part = torch.empty((S, U, n), **f32)
    s_part = torch.empty_like(m_part)
    er2_part = torch.empty((S, U, n, k2), **f32)
    er2 = torch.empty((U, n, k2), **f32)
    part = torch.empty((-(-n // SLAB), U, k1, k2), **f32)
    status = _launcher()(h.data_ptr(), wt.data_ptr(), r_v.data_ptr(),
                         hr.data_ptr(), rvt.data_ptr(), scale.data_ptr(),
                         m_part.data_ptr(), s_part.data_ptr(),
                         er2_part.data_ptr(), er2.data_ptr(),
                         part.data_ptr(), out.data_ptr(), U, n, d, V, k1,
                         k2, S, per, backend.stream_handle(h.device))
    backend.check(NAME, status)
    grad_sketch_units_op.launches += 1
    return out


grad_sketch_units_op.launches = 0


def grad_sketch_op(h, w, r_h, r_v, targets, scale,
                   impl: str = "auto") -> torch.Tensor:
    """h (N,d); targets, scale (N,) -> the (k1, k2) sketch: the U = 1
    case of ``grad_sketch_units_op`` (whose counter it moves)."""
    return grad_sketch_units_op(h[None], w, r_h, r_v, targets[None],
                                scale[None], impl=impl)[0]
