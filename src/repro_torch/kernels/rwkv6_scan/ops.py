"""Wrapper of the RWKV6 WKV kernels: CUDA tensors launch the Hopper
kernels (``csrc/rwkv6_wkv.cu``, forward and backward), CPU tensors take
the plain chunk algebra (``ref.py:wkv_chunked_lw``) and its autograd.
Consumed by ``models/rwkv6.py:tmix_forward`` in every time-mix layer
whose sequence takes the chunked branch (S % 64 == 0 and S >= 128).

The forward kernels replace the Pallas TPU kernel
``src/repro/kernels/rwkv6_scan/kernel.py:rwkv6_wkv``; the backward
kernel replaces ``jax.grad`` of ``src/repro/models/rwkv6.py:wkv_chunked``
(the reference trains through that function by autodiff).  Both are
bound by bytes on the card.  The forward is three launches, parallel
over (lane, chunk) where the recurrence allows it (:func:`wkv_grid`):
each chunk's own state increment, an ordered scan over the chunks that
leaves the state at every chunk's start, then each chunk's output with
its pairwise decays factorised over sub-chunks of 16 tokens.  The
backward runs one block per (batch, head) lane, carrying dS from the
last chunk to the first and starting each chunk from the state the
forward saved at its start (the note in the source has the details).

``rwkv6_wkv_op.launches`` counts forward calls that launched the
kernels (one per forward, although a forward is three kernel launches)
and ``rwkv6_wkv_op.bwd_launches`` backward launches (never plain-path
calls); ``wkv_forward`` and ``wkv_backward`` are the two, which the
autograd function wraps.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.rwkv6_scan.ref import CHUNK, wkv_chunked_lw

NAME = "rwkv6_wkv"
MAX_N = 64              # head dim: the state and a chunk live in shared memory
MAX_C = 64              # chunk length
SUB = 16                # the forward's sub-chunk of exact pairwise decays
FWD_THREADS = 256       # threads of a forward block and of a scan block


def _fwd_launcher():
    fn = backend.library(NAME).rwkv6_wkv_fwd_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def wkv_grid(B: int, S: int, H: int, N: int, C: int):
    """The forward's launch grid, a function of the shapes only: (blocks
    of the per-chunk phases (a) and (c), one per (lane, chunk) in
    lane-major order; blocks of the scan (b), one thread per (lane, n, m)
    state entry)."""
    return B * H * (S // C), -(-(B * H * N * N) // FWD_THREADS)


def wkv_block(blk: int, H: int, n_chunks: int):
    """(batch, head, chunk) of a per-chunk block, as the kernels read
    ``blockIdx.x``."""
    lane, c = divmod(blk, n_chunks)
    return lane // H, lane % H, c


def subchunk_plan(C: int):
    """How phase (c) covers a chunk's strictly lower pairs (i, j < i), in
    the kernel's order: (the diagonal sub-blocks' pairs (i, j), each one
    thread's exact pairwise sum; the off-diagonal tasks (i, J, half),
    each the 8 columns 16 J + 8 half + 0..7 of row i, taken through the
    last token 16 J + 15 of sub-chunk J)."""
    nsub = -(-C // SUB)
    pairs, tasks = [], []
    for I in range(nsub):
        L = min(SUB, C - I * SUB)
        pairs += [(I * SUB + a, I * SUB + b)
                  for a in range(1, L) for b in range(a)]
        tasks += [(I * SUB + q // I, q % I, half)
                  for q in range(L * I) for half in (0, 1)]
    return pairs, tasks


def _bwd_launcher():
    fn = backend.library(NAME).rwkv6_wkv_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(r, k, v, lw, u, chunk: int) -> int:
    """Refuse what the kernels do not take, before a pointer is passed;
    -> the chunk C = min(chunk, S)."""
    for t in (r, k, v, lw):
        backend.check_input(NAME, t, 4)
    backend.check_input(NAME, u, 2)
    B, S, H, N = r.shape
    if any(tuple(t.shape) != (B, S, H, N) for t in (k, v, lw)) \
            or tuple(u.shape) != (H, N):
        raise ValueError(f"{NAME}: inconsistent shapes r {tuple(r.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} lw "
                         f"{tuple(lw.shape)} u {tuple(u.shape)}")
    C = min(chunk, S)
    if not (0 < N <= MAX_N and 0 < C <= MAX_C and S % C == 0):
        raise ValueError(f"{NAME}: takes head dim N <= {MAX_N} and a chunk "
                         f"C <= {MAX_C} dividing S; got N {N}, S {S}, "
                         f"chunk {chunk}")
    return C


def wkv_forward(r, k, v, lw, u, chunk: int, keep_states: bool):
    """One forward on card tensors (its three kernel launches) -> (y,
    final state, the states at each chunk's start (B H, S/C, N, N) or
    None).  The chunk states are the scan's buffer, so they are made
    either way and returned only when ``keep_states``."""
    C = _check(r, k, v, lw, u, chunk)
    B, S, H, N = r.shape
    y = torch.empty_like(r)
    s_out = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    states = torch.empty((B * H, S // C, N, N), dtype=torch.float32,
                         device=r.device)
    tot = torch.empty((B * H, S // C, N), dtype=torch.float32,
                      device=r.device)
    status = _fwd_launcher()(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
        u.data_ptr(), y.data_ptr(), s_out.data_ptr(), states.data_ptr(),
        tot.data_ptr(), B, S, H, N, C, backend.stream_handle(r.device))
    backend.check(NAME, status)
    rwkv6_wkv_op.launches += 1
    return y, s_out, (states if keep_states else None)


def wkv_backward(r, k, v, lw, u, states, dy, ds, chunk: int):
    """One launch of the backward kernel: the forward's inputs and chunk
    states, and the cotangents of y and of the final state -> (dr, dk,
    dv, dlw, du), du summed over the batch."""
    C = _check(r, k, v, lw, u, chunk)
    B, S, H, N = r.shape
    backend.check_input(NAME, dy, 4)
    backend.check_input(NAME, ds, 4)
    backend.check_input(NAME, states, 4)
    if tuple(dy.shape) != (B, S, H, N) or tuple(ds.shape) != (B, H, N, N) \
            or tuple(states.shape) != (B * H, S // C, N, N):
        raise ValueError(f"{NAME}: inconsistent cotangent or state shapes "
                         f"dy {tuple(dy.shape)} ds {tuple(ds.shape)} "
                         f"states {tuple(states.shape)}")
    dr, dk, dv, dlw = (torch.empty_like(r) for _ in range(4))
    du_lane = torch.empty((B, H, N), dtype=torch.float32, device=r.device)
    status = _bwd_launcher()(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
        u.data_ptr(), states.data_ptr(), dy.data_ptr(), ds.data_ptr(),
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlw.data_ptr(),
        du_lane.data_ptr(), B, S, H, N, C, backend.stream_handle(r.device))
    backend.check(NAME, status)
    rwkv6_wkv_op.bwd_launches += 1
    return dr, dk, dv, dlw, du_lane.sum(dim=0)


class _WKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, lw, u, chunk):
        keep = any(ctx.needs_input_grad[:5])
        y, s_out, states = wkv_forward(r, k, v, lw, u, chunk, keep)
        if keep:
            ctx.save_for_backward(r, k, v, lw, u, states)
        ctx.chunk = chunk
        return y, s_out

    @staticmethod
    def backward(ctx, dy, ds):
        r, k, v, lw, u, states = ctx.saved_tensors
        grads = wkv_backward(r, k, v, lw, u, states, dy.contiguous(),
                             ds.contiguous(), ctx.chunk)
        return (*grads, None)


def rwkv6_wkv_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lw: torch.Tensor, u: torch.Tensor, chunk: int = CHUNK):
    """r, k, v, lw (B,S,H,N) fp32, lw = log(clip(w, 1e-8, 1)); u (H,N)
    -> (y (B,S,H,N) fp32, final state (B,H,N,N)), from a zero initial
    state, differentiable in r, k, v, lw and u."""
    if not backend.on_card(r, k, v, lw, u):
        B, S, H, N = r.shape
        s0 = torch.zeros((B, H, N, N), dtype=torch.float32)
        return wkv_chunked_lw(r, k, v, lw, u, s0, chunk)
    return _WKV.apply(r, k, v, lw, u, chunk)


rwkv6_wkv_op.launches = 0
rwkv6_wkv_op.bwd_launches = 0
