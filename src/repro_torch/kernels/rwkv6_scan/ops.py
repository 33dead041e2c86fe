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
backward is three launches of the same shape (:func:`wkv_bwd_grid`):
each chunk's increment of the state gradient, an ordered reverse scan
over the chunks that leaves the gradient of the state after every chunk,
then each chunk's dr, dk, dv, dlw and du partial from its start state
(the forward's) and that gradient, its 64-wide products on the tensor
cores in 3xTF32 (the note in the source has the details).

``rwkv6_wkv_op.launches`` counts forward calls that launched the
kernels (one per forward, although a forward is three kernel launches)
and ``rwkv6_wkv_op.bwd_launches`` backward calls (one per backward, also
three kernel launches; never plain-path calls); ``wkv_forward`` and
``wkv_backward`` are the two, which the autograd function wraps.  On
the CPU ``_WKVPlain`` wraps the plain chunk algebra the same way (its
backward is autograd of that algebra, as before), so both routes have
one forward and one backward call; :func:`work` and :func:`bwd_work`
are their counts for ``launch/op_analysis.py``, the same on every
route.  Fake or meta tensors (a dry run) take a shape-only route that
launches nothing.
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


def work(B: int, S: int, H: int, N: int, C: int):
    """(FLOPs, bytes) of one forward: 4 N^2 FLOP a (token, head); r, k,
    v, lw and u read, y, the final state and the chunk states written."""
    bshn, bhnn = B * S * H * N, B * H * N * N
    n_states = B * H * (S // C) * N * N
    return 4 * N * N * B * S * H, 4 * (5 * bshn + H * N + bhnn + n_states)


def bwd_work(B: int, S: int, H: int, N: int, C: int):
    """(FLOPs, bytes) of one backward: 8 N^2 FLOP a (token, head)
    (dy S^T, r^T dy, v dS^T, k dS); r, k, v, lw, u, dy, the state's
    cotangent and the chunk states read, dr, dk, dv, dlw and du
    written."""
    bshn, bhnn = B * S * H * N, B * H * N * N
    n_states = B * H * (S // C) * N * N
    return (8 * N * N * B * S * H,
            4 * (5 * bshn + H * N + bhnn + n_states + 4 * bshn + H * N))


def _dims(r, chunk: int):
    B, S, H, N = r.shape
    return B, S, H, N, min(chunk, S)


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


def wkv_bwd_grid(B: int, S: int, H: int, N: int, C: int):
    """The backward's launch grid, a function of the shapes only: (blocks
    of the increment phase (a), one per (lane, chunk c >= 1), lane-major;
    blocks of the reverse scan (b), one thread per (lane, n, m) state
    entry; blocks of the gradient phase (c), one per (lane, chunk))."""
    nC = S // C
    return (B * H * (nC - 1), -(-(B * H * N * N) // FWD_THREADS),
            B * H * nC)


def wkv_bwd_inc_block(blk: int, H: int, n_chunks: int):
    """(batch, head, chunk) of an increment block (a), as the kernel reads
    ``blockIdx.x``: chunk 0's increment is never read, so it has none."""
    lane, c = divmod(blk, n_chunks - 1)
    return lane // H, lane % H, c + 1


def bwd_grad_smem(C: int, N: int) -> int:
    """Bytes of shared memory a gradient block (c) takes: four chunk-row
    arrays and two of the larger of chunk rows, the state and the
    pairwise matrix, each row padded to a multiple of 4 floats plus 4,
    six vectors of up to 64 and two (sub-chunk, channel) tables of sums
    (the source's ``bwd_layout`` and launcher)."""
    pn, pc = -(-N // 4) * 4 + 4, -(-C // 4) * 4 + 4
    return 4 * (4 * C * pn + 2 * max(C, N) * max(pn, pc)
                + 4 * MAX_N + 2 * MAX_C + 2 * (MAX_C // SUB) * MAX_N)


def _bwd_launcher():
    fn = backend.library(NAME).rwkv6_wkv_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 \
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
    """One backward on card tensors (its three kernel launches): the
    forward's inputs and chunk states, and the cotangents of y and of the
    final state -> (dr, dk, dv, dlw, du), du's partials (one a lane and
    chunk) summed over the batch and the chunks in a fixed order."""
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
    nC = S // C
    # scratch: the gradient of the state after every chunk (first each
    # chunk's increment), each chunk's total decay
    dstates = torch.empty((B * H, nC, N, N), dtype=torch.float32,
                          device=r.device)
    tot = torch.empty((B * H, nC, N), dtype=torch.float32, device=r.device)
    du_part = torch.empty((B, H, nC, N), dtype=torch.float32,
                          device=r.device)
    status = _bwd_launcher()(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
        u.data_ptr(), states.data_ptr(), dy.data_ptr(), ds.data_ptr(),
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlw.data_ptr(),
        du_part.data_ptr(), dstates.data_ptr(), tot.data_ptr(), B, S, H, N,
        C, backend.stream_handle(r.device))
    backend.check(NAME, status)
    rwkv6_wkv_op.bwd_launches += 1
    return dr, dk, dv, dlw, du_part.sum(dim=(0, 2))


class _WKV(torch.autograd.Function):
    """The kernels on card tensors; empty outputs of the right shapes on
    fake or meta ones (a dry run)."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u, chunk):
        ctx.set_materialize_grads(False)
        keep = any(ctx.needs_input_grad[:5])
        dims = _dims(r, chunk)
        with backend.kernel_work(NAME, *work(*dims)):
            if backend.shape_only(r, k, v, lw, u):
                B, S, H, N, C = dims
                y, s_out = torch.empty_like(r), r.new_empty((B, H, N, N))
                states = r.new_empty((B * H, S // C, N, N)) if keep else None
            else:
                y, s_out, states = wkv_forward(r, k, v, lw, u, chunk, keep)
        if keep:
            ctx.save_for_backward(r, k, v, lw, u, states)
        ctx.chunk = chunk
        return y, s_out

    @staticmethod
    def backward(ctx, dy, ds):
        r, k, v, lw, u, states = ctx.saved_tensors
        with backend.kernel_work(NAME + "_bwd",
                                 *bwd_work(*_dims(r, ctx.chunk))):
            # an output autograd did not reach has no cotangent: zeros
            dy = torch.zeros_like(r) if dy is None else dy
            B, _, H, N = r.shape
            ds = r.new_zeros((B, H, N, N)) if ds is None else ds
            if backend.shape_only(r, dy):
                grads = tuple(torch.empty_like(t) for t in (r, k, v, lw, u))
            else:
                grads = wkv_backward(r, k, v, lw, u, states, dy.contiguous(),
                                     ds.contiguous(), ctx.chunk)
        return (*grads, None)


class _WKVPlain(torch.autograd.Function):
    """The plain chunk algebra on CPU tensors, from a zero initial state:
    its forward records its own graph, its backward is autograd of that
    graph (the same operations as autograd of the algebra itself), each
    counted as one call of the kernel it stands for."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u, chunk):
        ctx.set_materialize_grads(False)
        ctx.dims = _dims(r, chunk)
        B, S, H, N = r.shape
        ins = [t.detach().requires_grad_(need)
               for t, need in zip((r, k, v, lw, u), ctx.needs_input_grad)]
        with backend.kernel_work(NAME, *work(*ctx.dims)), \
                torch.enable_grad():
            s0 = torch.zeros((B, H, N, N), dtype=torch.float32)
            outs = wkv_chunked_lw(*ins, s0, chunk)
        if any(ctx.needs_input_grad[:5]):
            ctx.graph = (ins, outs)
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, dy, ds):
        ins, outs = ctx.graph
        del ctx.graph
        pairs = [(o, g) for o, g in zip(outs, (dy, ds))
                 if g is not None and o.requires_grad]
        want = [t for t in ins if t.requires_grad]
        with backend.kernel_work(NAME + "_bwd", *bwd_work(*ctx.dims)):
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], want, [g for _, g in pairs],
                allow_unused=True) if pairs else [None] * len(want))
        grads = [next(got) if t.requires_grad else None for t in ins]
        return (*grads, None)


def rwkv6_wkv_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lw: torch.Tensor, u: torch.Tensor, chunk: int = CHUNK):
    """r, k, v, lw (B,S,H,N) fp32, lw = log(clip(w, 1e-8, 1)); u (H,N)
    -> (y (B,S,H,N) fp32, final state (B,H,N,N)), from a zero initial
    state, differentiable in r, k, v, lw and u."""
    if not backend.shape_only(r, k, v, lw, u) and \
            not backend.on_card(r, k, v, lw, u):
        return _WKVPlain.apply(r, k, v, lw, u, chunk)
    return _WKV.apply(r, k, v, lw, u, chunk)


rwkv6_wkv_op.launches = 0
rwkv6_wkv_op.bwd_launches = 0
