"""Wrapper of the sliding-window attention kernels: CUDA tensors launch
the Hopper kernels (``csrc/swa_attn.cu``, the backward in
``csrc/swa_attn_bwd.cu``), CPU tensors take the plain
band gather (``ref.py``).  Consumed by ``models/attention.py:_mha_band``,
the branch every local layer of a training or prefill forward with ``S >
window + 1024`` takes.

The forward kernel replaces the Pallas TPU kernel
``src/repro/kernels/swa_attn/kernel.py:swa_attn``.  It is bound by
operations on the card (4 hd FLOP per (query, key) pair of the band).
bf16 inputs (the serving path) run on the tensor cores: one block per
(q tile of 192 rows, head, batch), three warpgroups of ``wgmma`` products
with fp32 accumulation over the 64-key tiles the window reaches, a
producer warp loading K/V tiles by TMA into a ring of shared-memory
stages, an fp32 online softmax, and p split into bf16 hi + lo for p . v
so that p keeps fp32 accuracy; at head dim 256 (recurrentgemma-9b) a
block takes 128 q rows in two warpgroups and a ring of 2 K/V stages, to
fit its registers and shared memory.  fp32 inputs run an fp32 SIMT body
(the note in the source has the details).  When autograd needs it, the
forward also writes each row's fp32 logsumexp; the output is the same
bits either way.

The backward kernel has no TPU counterpart: the reference differentiates
its XLA band gather with ``jax.grad``.  It computes the gradient of the
port's forward (p fp32 for p . v) and is bound by operations on the
card: 10 hd FLOP a (query, key) pair and query head at the bf16 peak.
bf16 inputs run four launches: each row's D = rowsum(dout * out) and lse
in log2 units; dq over each q tile's band; dk / dv over each key tile's
queries, one query head a block; and the in-order sum of the heads'
partial dk / dv from fp32 scratch, so nothing is summed by atomics and
two launches agree bit for bit.  The products run on ``wgmma`` with
their operands loaded by TMA from a producer warpgroup into a ring of
shared-memory stages (dq streams K and V under a resident q and dout
tile, dk / dv stream q, dout, lse and D under resident K and V); p and
ds are split into bf16 hi + lo, and where a block's two warpgroups split
the head dim of the outputs (dk / dv from head dim 128, dq at 256) each
computes the whole s and dp, so the tensor cores run 20-28 hd FLOP a
pair and head against the bound's 10.  fp32 inputs run an fp32 SIMT
body in three launches.

``_SWA`` is the one autograd function on both devices: its forward is
the kernel or ``swa_attn_fwd_ref``, its backward the kernel or
``swa_attn_bwd_ref``.  A card tensor always launches a kernel; a failed
build or launch raises, and nothing falls back to the plain version.

``swa_attn_op.launches`` counts forward launches and
``swa_attn_op.bwd_launches`` backward calls (four kernels each at bf16),
never plain-path calls.  :func:`work` and :func:`bwd_work` are their
counts for ``launch/op_analysis.py``, the same on every route; fake or
meta tensors (a dry run) take a shape-only route that launches nothing.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.swa_attn.ref import (attn_scale, swa_attn_bwd_ref,
                                              swa_attn_fwd_ref)

NAME = "swa_attn"
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def softmax_scale(hd: int) -> float:
    """The fp32 ``1/sqrt(hd)`` of ``ref.attn_scale`` as a Python float,
    read from its host tensor once a head dim (every head dim up to 512
    at import), so a step reads nothing back for it and an op count of
    a step does not depend on what ran before."""
    return float(attn_scale(hd))  # repro_torch: noqa[kernel-no-fallback] -- the softmax scale, a constant of hd, not a plain version


for _hd in range(1, 513):
    softmax_scale(_hd)
del _hd


def band_pairs(S: int, W: int) -> int:
    """(query, key) pairs of a causal window W over S tokens."""
    W = min(W, S)
    return W * (W + 1) // 2 + (S - W) * W


def work(q, k, v, window: int, with_lse: bool):
    """(FLOPs, bytes) of one forward: 4 hd FLOP a (query, key) pair of
    the band and query head (rows at full length); q, k and v read, the
    output (and lse) written."""
    B, S, KV, G, hd = q.shape
    esz = q.element_size()
    lse = 4 * B * S * KV * G if with_lse else 0
    return (4 * hd * band_pairs(S, window) * KV * G * B,
            esz * (2 * q.numel() + k.numel() + v.numel()) + lse)


def bwd_work(q, k, v, window: int):
    """(FLOPs, bytes) of one backward: 10 hd FLOP a pair and query head;
    q, k, v, out, dout and lse read, dq, dk and dv written."""
    B, S, KV, G, hd = q.shape
    return (10 * hd * band_pairs(S, window) * KV * G * B,
            q.element_size() * (4 * q.numel() + 2 * k.numel()
                                + 2 * v.numel()) + 4 * B * S * KV * G)


def _launcher():
    fn = backend.library(NAME).swa_attn_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _bwd_launcher():
    fn = backend.library("swa_attn_bwd").swa_attn_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _bwd_scratch(B: int, S: int, KV: int, G: int, hd: int, dtype) -> int:
    """fp32 floats of scratch the backward kernel takes at this shape."""
    fn = backend.library("swa_attn_bwd").swa_attn_bwd_scratch
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_longlong
    return fn(B, S, KV, G, hd, _DTYPES[dtype])


def _check(q, k, v, lengths, window: int) -> None:
    """What the kernels take: q, k, v of one dtype, the port's layout,
    a head dim they are built for, contiguous, per-row int32 lengths."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{NAME}: takes q, k, v all float32 or all "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 5 or k.dim() != 4:
        raise ValueError(f"{NAME}: expected q (B,S,KV,G,hd) and k/v "
                         f"(B,S,KV,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    B, S, KV, G, hd = q.shape
    if tuple(k.shape) != (B, S, KV, hd) or tuple(v.shape) != (B, S, KV, hd):
        raise ValueError(f"{NAME}: inconsistent shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if hd not in HEAD_DIMS or window < 1:
        raise ValueError(f"{NAME}: takes head dim in {HEAD_DIMS} and a "
                         f"window >= 1; got hd {hd}, window {window}")
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: expected contiguous tensors")
    if lengths is not None:
        if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,) \
                or not lengths.is_contiguous():
            raise ValueError(f"{NAME}: lengths must be a contiguous (B,) "
                             f"int32 tensor")
        backend.on_card(q, lengths)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(q, k, v, lengths, window: int, with_lse: bool = False):
    """One forward launch on card tensors -> (out, lse (B,S,KV,G) fp32
    when ``with_lse``, else None)."""
    _check(q, k, v, lengths, window)
    B, S, KV, G, hd = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((B, S, KV, G), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    status = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(lengths),
        out.data_ptr(), _ptr(lse), B, S, KV, G, hd, int(window),
        softmax_scale(hd), _DTYPES[q.dtype],
        backend.stream_handle(q.device))
    backend.check(NAME, status)
    swa_attn_op.launches += 1
    return out, lse


def swa_attn_bwd(q, k, v, out, lse, dout, window: int, lengths=None):
    """One backward on card tensors (its four kernel launches at bf16,
    three at fp32): the forward's inputs, its output and lse, and out's
    cotangent -> (dq, dk, dv) in the inputs' dtype."""
    _check(q, k, v, lengths, window)
    B, S, KV, G, hd = q.shape
    for name, t in (("out", out), ("dout", dout)):
        if t.dtype != q.dtype or t.shape != q.shape or not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be a contiguous tensor "
                             f"of q's shape and dtype")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, S, KV, G) \
            or not lse.is_contiguous():
        raise ValueError(f"{NAME}: lse must be a contiguous (B,S,KV,G) "
                         f"float32 tensor")
    backend.on_card(q, out, lse, dout)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    scratch = torch.empty(_bwd_scratch(B, S, KV, G, hd, q.dtype),
                          dtype=torch.float32, device=q.device)
    status = _bwd_launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), dout.data_ptr(), _ptr(lengths), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), B, S, KV, G, hd,
        int(window), softmax_scale(hd), _DTYPES[q.dtype],
        backend.stream_handle(q.device))
    backend.check(NAME, status)
    swa_attn_op.bwd_launches += 1
    return dq, dk, dv


class _SWA(torch.autograd.Function):
    """The band on both devices: the kernels on card tensors, the plain
    forward and backward on CPU ones, empty outputs of the right shapes
    on fake or meta ones.  The forward keeps lse only when a gradient is
    wanted."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, window):
        train = any(ctx.needs_input_grad[:3])
        with backend.kernel_work(NAME, *work(q, k, v, window, train)):
            if backend.shape_only(q, k, v):
                B, S, KV, G, _ = q.shape
                out = torch.empty_like(q)
                lse = q.new_empty((B, S, KV, G), dtype=torch.float32)
            elif backend.on_card(q, k, v):
                out, lse = _launch(q, k, v, lengths, window, with_lse=train)
            else:
                out, lse = swa_attn_fwd_ref(q, k, v, window=window,
                                            lengths=lengths)
        if train:
            ctx.save_for_backward(q, k, v, out, lse, lengths)
            ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, lengths = ctx.saved_tensors
        dout = dout.contiguous()
        with backend.kernel_work(NAME + "_bwd",
                                 *bwd_work(q, k, v, ctx.window)):
            if backend.shape_only(q, k, v, dout):
                grads = tuple(torch.empty_like(t) for t in (q, k, v))
            elif backend.on_card(q, k, v, dout):
                grads = swa_attn_bwd(q, k, v, out, lse, dout, ctx.window,
                                     lengths)
            else:
                grads = swa_attn_bwd_ref(q, k, v, out, lse, dout,
                                         window=ctx.window, lengths=lengths)
        return (*grads, None, None)


def swa_attn_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                window: int, lengths: torch.Tensor = None) -> torch.Tensor:
    """q (B,S,KV,G,hd), k/v (B,S,KV,hd), optional per-row valid lengths
    (B,) -> (B,S,KV,G,hd) in q's dtype: query s attends to the valid
    keys in (s - window, s]; rows at or past their length are zeros.
    Differentiable in q, k and v on both devices."""
    if not backend.shape_only(q, k, v):
        backend.on_card(q, k, v)
    return _SWA.apply(q, k, v, lengths, window)


swa_attn_op.launches = 0
swa_attn_op.bwd_launches = 0
