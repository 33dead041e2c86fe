"""Wrapper of the sliding-window attention kernel: CUDA tensors launch
the Hopper kernel (``csrc/swa_attn.cu``), CPU tensors take the plain band
gather (``ref.py:swa_attn_ref``).  Consumed by
``models/attention.py:_mha_band``, the branch every local layer of a
prefill (or forward) with ``S > window + 1024`` takes.

The kernel replaces the Pallas TPU kernel
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
(the note in the source has the details).

It computes the forward only, as the TPU kernel does.  Its autograd
function refuses a backward: training through the band on the card
needs a backward kernel (ROADMAP.md queue 1, item 7: long-context
training), and nothing falls back to the plain version.

``swa_attn_op.launches`` counts kernel launches (never plain-path
calls).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.swa_attn.ref import attn_scale, swa_attn_ref

NAME = "swa_attn"
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launcher():
    fn = backend.library(NAME).swa_attn_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, lengths, window: int) -> torch.Tensor:
    """One launch on card tensors, after checking what the kernel takes."""
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
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    status = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if lengths is None else lengths.data_ptr(), out.data_ptr(),
        B, S, KV, G, hd, int(window), float(attn_scale(hd)),
        _DTYPES[q.dtype], backend.stream_handle(q.device))
    backend.check(NAME, status)
    swa_attn_op.launches += 1
    return out


class _SWA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, lengths, window):
        return _launch(q, k, v, lengths, window)

    @staticmethod
    def backward(ctx, dout):
        raise NotImplementedError(
            f"{NAME}: the band attention has no backward kernel on the card "
            f"yet (ROADMAP.md queue 1, item 7: long-context training "
            f"through the band)")


def swa_attn_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                window: int, lengths: torch.Tensor = None) -> torch.Tensor:
    """q (B,S,KV,G,hd), k/v (B,S,KV,hd), optional per-row valid lengths
    (B,) -> (B,S,KV,G,hd) in q's dtype: query s attends to the valid
    keys in (s - window, s]; rows at or past their length are zeros."""
    if not backend.on_card(q, k, v):
        return swa_attn_ref(q, k, v, window=window, lengths=lengths)
    return _SWA.apply(q, k, v, lengths, window)


swa_attn_op.launches = 0
