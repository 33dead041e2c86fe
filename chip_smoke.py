#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

run from the root of a checkout, on a machine with one NVIDIA H100.  It
imports no JAX and nothing of the JAX package, and runs in phases; any
failure exits non-zero, and no phase catches an error and carries on:

1. environment: the card's name and power limit; TF32 off everywhere
   (``cudnn.allow_tf32`` defaults to True, which would put the CRDNN
   convolutions in TF32) and cuDNN on its deterministic algorithms;
2. build: the five CUDA kernels from the checkout's sources, one
   ``nvcc`` per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the same
   card tensors, at the main paths' shapes and at ragged edge shapes,
   with times (CUDA events), the plain version's time, a PyTorch library
   call's time where one computes the same function, and the least time
   the card could take (bytes over 3.35 TB/s, operations over the peak
   of the inputs' type: fp32 67 TFLOP/s, bf16 989 TFLOP/s, H100 SXM);
   the lattice at ten row widths from 1 to 12,288 (ring depths 16, 8
   and 1), twice bitwise, its time a row printed;
   the Gram at stage B's (4, 4, 4096) and at (8, 512, 4096), twice
   bitwise and exactly symmetric, timed in turns with ``torch.bmm``; the
   grad-sketch kernel also launched twice on the same inputs, which
   must agree bit for bit, timed in turns with its plain version, its
   rate printed against two bounds (the fp32 FMA route and the 3xTF32
   tensor-core route it takes); the RWKV6 WKV kernels (forward and
   backward) against the plain chunk algebra and its autograd, twice
   bitwise, at the RWKV path's shape and the reference kernel tests'
   shapes, at decays in (0.4, 0.99), of 1e-6, at the 1e-8 clip and
   mixed by channel, one chunk (S = C) and C = 32, with the forward's and
   the backward's three launches timed apart; the
   sliding-window attention kernel (bf16 on the tensor cores, fp32 on
   the SIMT body) at the serving path's prefill shape and at edge shapes
   of both bodies, twice bitwise, timed in turns with
   ``scaled_dot_product_attention`` under the band mask as its library
   time, its rate printed against both the function's FLOPs and the
   tensor cores' (p . v runs twice, p split into bf16 hi + lo);
4. agreement: one full-width ``rnnt-crdnn`` unit, and one unit each of
   ``starcoder2-3b`` and ``rwkv6-3b`` at full width with 2 layers in
   fp32, through the kernels on the card against the same unit through
   the plain versions on the CPU (per-example loss, the stage-A gradient
   or sketch, and for RWKV one layer's time-mix gradients), the RNN-T
   unit's fused backward twice on the card with the same dw_out bits,
   the RNN-T unit's whole training gradient twice, every leaf bit for
   bit; and the 2-layer ``starcoder2-3b`` served on a 6,144-token prompt (the band
   branch), prefill and 8 teacher-forced greedy decode steps, card
   against CPU;
5. main path, RNN-T: ``train_with_selection(method="pgm")`` at the full
   width of ``rnnt-crdnn`` on a synthetic corpus -- warm start, then a PGM
   round (stage A + stage B) before each subset epoch, each round's time
   printed; the same path again with the same seed, its launches counted
   apart, which must print the same losses and pick the same subsets and
   weights; then two stage-A rounds on the trained params, timed, with
   whether their unit vectors agree bit for bit and whether they pick
   the same subsets (so also after the LM and RWKV profiles);
6. profile, RNN-T: one training step under ``torch.profiler`` (host wall
   time, device busy time, the kernels that take the most of it);
7. serving, RNN-T: ``rnnt-crdnn`` at full width (random weights; the
   3-epoch model emits only blanks) in the slot engine (streaming greedy
   transducer search) on 8 utterances, token for token against
   ``rnnt_greedy_reference`` on the card;
8. main path, LM: the same loop on ``starcoder2-3b`` at full width and
   depth (30 layers, d_model 3072, vocab 49152, bf16 compute, fp32 master
   weights) on a synthetic corpus of 512-token examples, with the peak of
   device memory;
9. profile, LM: one training step of that model, as in 6;
10. serving, LM: the same params (the training path's optimizer state
   freed) served at full depth: ``generate`` on 2 prompts of 8,192
   tokens, then ``SlotEngine`` with 4 slots on the launcher's 8
   requests of 4,136-7,581 tokens (5 through the band kernel, 3 through
   the kv-block flash branch), 32 new tokens each; every completion's
   first token against ``generate`` on its prompt alone; one decode scan
   and one prefill of the 2 x 8,192 prompts under the profiler;
11. main path, RWKV: the same loop on ``rwkv6-3b`` at full width and
   depth (32 layers, d_model 2560, 40 WKV heads of 64, vocab 65536, bf16
   compute, fp32 master weights), with the peak of device memory;
12. profile, RWKV: one training step of that model, as in 6.

Each main path runs with its kernels' launch counters set to 0 just
before and read just after, and fails if a kernel of the path was never
launched.  The script ends with a JSON line of per-kernel numbers (one
row per kernel and main path, so the Gram, which all three training
paths run, has three, and the grad sketch, which both LM paths run,
two), the card's name and power limit as ``nvidia-smi`` prints them, and
the line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
FP32_FLOP_PER_S = 67e12            # H100 SXM fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12           # H100 SXM bf16 dense tensor cores
TF32_FLOP_PER_S = 495e12           # H100 SXM TF32 dense tensor cores
NEG = -1e30

# main-path corpus: T = 32 * 16 = 512 frames -> T' = 128, U + 1 = 33
CORPUS = dict(n_examples=64, n_feats=80, vocab_size=1000, min_tokens=16,
              max_tokens=32, frames_per_token=16, noise_fraction=0.25,
              snr_db=5.0)
N_VAL = 16
UNIT_SIZE = 4
# LM main path: make_lm_corpus(0, 64, 512, 49152) in units of 4 (16 units),
# validation make_lm_corpus(7, 16, 512, 49152) (4 units), as the launcher
# builds them for --n 64 --seq 512
LM_N = 64
LM_SEQ = 512
# grad-sketch shapes: the LM main path's stage-A unit (U, n, d, V, k1, k2)
# with n = 4 * 511 tokens, and ragged ones (n and V off every tile, k1 !=
# k2, several units, an all-zero scale row set in unit 1)
SKETCH_MAIN = (1, UNIT_SIZE * (LM_SEQ - 1), 3072, 49152, 64, 64)
# the RWKV path's stage-A unit: rwkv6-3b's d 2560, vocab 65536
SKETCH_RWKV = (1, UNIT_SIZE * (LM_SEQ - 1), 2560, 65536, 64, 64)
SKETCH_EDGES = ((1, 1, 1, 1, 1, 1), (1, 17, 16, 64, 8, 8),
                (3, 130, 72, 1001, 24, 40), (2, 65, 33, 4099, 64, 100),
                (4, 511, 256, 8195, 70, 64), (2, 300, 128, 1000, 32, 72))

# WKV shapes (B, S, H, N, C, decay): the RWKV main path's time-mix, and the
# reference kernel tests' (tests/test_kernels.py), with decays in (0.4,
# 0.99), all 1e-6, all at the 1e-8 clip, or mixed by channel (the clip,
# 0.999 and (0.4, 0.99)); then one chunk (S = C) and C = 32 at N = 64
WKV_MAIN = (UNIT_SIZE, LM_SEQ, 40, 64, 64, None)
WKV_EDGES = ((2, 64, 2, 16, 16, None), (1, 128, 3, 32, 32, None),
             (2, 96, 1, 8, 32, None), (1, 64, 2, 64, 64, None),
             (1, 64, 1, 8, 16, 1e-6), (1, 128, 2, 64, 64, 1e-8),
             (2, 128, 2, 64, 64, "mixed"), (1, 96, 1, 16, 32, "mixed"),
             (2, 32, 2, 16, 32, "mixed"), (1, 128, 2, 64, 32, 1e-8))
# lattice row widths: the reference kernel tests' and the transducer's,
# then 257, the first past the 16-row ring (1,186) and the largest the
# wrapper takes (12,288, a ring of one row)
LATTICE_U1 = (1, 2, 5, 17, 33, 65, 129, 257, 1186, 12288)


# sliding-window attention (B, S, KV, G, hd, window, dtype, lengths): the
# serving path's prefill shape (starcoder2-3b, one 8,192-token prompt),
# then S off the 64-row tile and off 1024, a window below the tile, a
# window above S, per-row lengths at B 2, fp32; then the bf16 tensor-core
# body's edges: S off its 192-row q tile and off 128 (129, 1100), windows
# off its 64-key tile (1, 63, 200), every head dim, per-row lengths of 1
# and S, of S - 1 and 70
SWA_MAIN = (1, 8192, 2, 12, 128, 4096, "bfloat16", None)
SWA_EDGES = ((1, 1100, 2, 12, 128, 256, "bfloat16", None),
             (1, 300, 2, 3, 64, 16, "bfloat16", None),
             (1, 200, 1, 2, 32, 512, "bfloat16", None),
             (2, 1500, 2, 4, 128, 700, "bfloat16", (1500, 1033)),
             (2, 777, 2, 2, 16, 100, "float32", (5, 777)),
             (1, 2048, 2, 12, 128, 1024, "float32", None),
             (1, 129, 2, 3, 128, 200, "bfloat16", None),
             (1, 1100, 1, 4, 16, 63, "bfloat16", None),
             (1, 1100, 2, 2, 32, 1, "bfloat16", None),
             (1, 1100, 1, 3, 64, 200, "bfloat16", None),
             (2, 700, 2, 2, 128, 300, "bfloat16", (1, 700)),
             (2, 700, 1, 3, 64, 63, "bfloat16", (699, 70)))
# serving: the agreement prompt, and the full-depth run's prompts
SERVE_AGREE_S = 6144
SERVE_AGREE_STEPS = 8
SERVE_PROMPT = 8192
SERVE_NEW = 32
SERVE_SLOTS = 4
SERVE_REQUESTS = 8
# RNN-T serving: the launcher's utterances of 256-512 frames
RNNT_SERVE_FRAMES = 512
RNNT_MAX_SYMBOLS = 8


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean time of one call on the card (CUDA events over ``reps``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_ops: float, flop_per_s: float = FP32_FLOP_PER_S):
    """(least ms, what bounds it) for the card's published peaks; the
    operations at the peak of the inputs' type (fp32 unless given)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lattice_inputs(torch, T, B, U1, seed, dev):
    g = torch.Generator().manual_seed(seed)
    mult = torch.randn(T, B, U1, generator=g)
    add = torch.where(torch.rand(T, B, U1, generator=g) < 0.3,
                      torch.randn(T, B, U1, generator=g),
                      torch.tensor(NEG))
    emit = torch.randn(T, B, U1, generator=g)
    emit[:, :, 0] = NEG
    return [x.to(dev).contiguous() for x in (mult, add, emit)]


def lattice_err(torch, got, want):
    """Hold the kernel at atol 1e-4 / rtol 1e-5 (cells that stay at NEG
    agree to fp32 rounding at 1e30); the reported error is over the
    reachable cells (> NEG / 2)."""
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    live = want > NEG / 2
    require(bool(torch.equal(live, got > NEG / 2)),
            "rnnt_lattice: reachable cells differ")
    return float((got - want)[live].abs().max()) if bool(live.any()) else 0.0


def gram_err(torch, got, want):
    """Two fp32 summation orders over D: held at 1e-4 of max |K|."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    require(err <= 1e-4 * scale, f"omp_gram: max abs err {err} > 1e-4 * "
                                 f"{scale}")
    return err


def sketch_inputs(torch, U, n, d, V, k1, k2, seed, dev):
    """Logits of std 4 (the head scaled by 4/sqrt(d)), so the softmax is
    peaked and its p.R2 term carries a good part of the sketch; the head
    is passed as the (d, V) view of a contiguous (V, d) tensor, as the
    tied embedding gives it; unit 1 (when there is one) has scale 0."""
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(U, n, d, generator=g)
    wt = torch.randn(V, d, generator=g) * (4 / math.sqrt(d))
    rh = torch.randn(d, k1, generator=g)
    rv = torch.randn(V, k2, generator=g)
    t = torch.randint(0, V, (U, n), generator=g, dtype=torch.int32)
    s = torch.rand(U, n, generator=g) + 0.5
    if U > 1:
        s[1] = 0.0
    h, wt, rh, rv, t, s = (x.to(dev) for x in (h, wt, rh, rv, t, s))
    return [h, wt.t(), rh, rv, t, s]


def sketch_err(torch, op, ref, ins):
    """Two launches on the same inputs agree bitwise; the kernel agrees
    with the plain version within 1e-4 of its largest entry, and within
    1e-4 of the largest entry of the vocab pass's own part hr^T (p R2)
    scale (the target term R2[t], indexed outside the kernel, can dwarf
    it).  -> (max abs err, err / largest entry, err / largest vocab-part
    entry)."""
    got = op(*ins)
    again = op(*ins)
    torch.cuda.synchronize()
    require(bool(torch.equal(got, again)),
            "grad_sketch: two launches on the same inputs differ")
    want = ref(*ins)
    h, _, rh, rv, t, s = ins
    vocab = want + torch.einsum("unk,unl->ukl", h @ rh,
                                rv[t.long()] * s[..., None])
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    v_scale = float(vocab.abs().max())
    require(err <= 1e-4 * scale and err <= 1e-4 * v_scale,
            f"grad_sketch {tuple(ins[0].shape)}: max abs err {err} > 1e-4 "
            f"* {scale} (sketch) or 1e-4 * {v_scale} (vocab part)")
    if ins[0].shape[0] > 1:
        require(not bool(got[1].any()), "grad_sketch: a zero-scale unit "
                                        "has a non-zero sketch")
    return (err, err / scale if scale else 0.0,
            err / v_scale if v_scale else 0.0)


def sketch_row(torch, op, ref, shape, seed, dev, tag):
    """The grad-sketch kernel at one main path's stage-A shape (one unit):
    its error (``sketch_err``), its and the plain version's distance from
    the same function in float64, kernel and plain version timed in
    turns, and two
    bounds: the fp32 FMA route (every product at the fp32 peak) and the
    3xTF32 route the kernel takes (h.W and p.R2 three times over at the
    TF32 tensor-core peak, h.R1 and hr^T er2 at the fp32 peak), each the
    larger of its operations time and the bytes time.  -> (err, kernel
    ms, plain ms, the lesser bound, what bounds it)."""
    ins = sketch_inputs(torch, *shape, seed=seed, dev=dev)
    err, rel, vrel = sketch_err(torch, op, ref, ins)
    # both against the same function in float64 (the reference's formula)
    h, w, rh, rv, t, s = ins
    hh = h[0].double()
    p = torch.softmax(hh @ w.double(), dim=-1)
    p[torch.arange(p.shape[0], device=dev), t[0].long()] -= 1.0
    truth = (hh @ rh.double()).t() @ ((p * s[0].double()[:, None])
                                      @ rv.double())
    del hh, p
    t_scale = float(truth.abs().max())
    k64 = float((op(*ins)[0].double() - truth).abs().max()) / t_scale
    p64 = float((ref(*ins)[0].double() - truth).abs().max()) / t_scale
    runs = []
    for _ in range(2):
        runs.append(cuda_ms(torch, lambda: op(*ins), reps=10))
        runs.append(cuda_ms(torch, lambda: ref(*ins), reps=5))
    k_ms, p_ms = (runs[0] + runs[2]) / 2, (runs[1] + runs[3]) / 2
    U, n, d, V, k1, k2 = shape
    # inputs h, w, r_h, r_v, targets, scale read once, the sketch written
    # once; what the function needs: h.W, p.R2, h.R1 and hr^T er2
    big = 2 * U * n * d * V + 2 * U * n * V * k2
    small = 2 * U * n * d * k1 + 2 * U * n * k1 * k2
    n_bytes = 4 * (U * n * d + d * V + d * k1 + V * k2 + 2 * U * n
                   + U * k1 * k2)
    fp32_ms, fp32_by = bound(n_bytes, big + small)
    t_ops = (3 * big / TF32_FLOP_PER_S + small / FP32_FLOP_PER_S) * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    tf32_ms, tf32_by = ((t_ops, "operations") if t_ops >= t_bytes
                        else (t_bytes, "bytes"))
    print(f"[kernels] grad_sketch {tag} {shape}: max_abs_err {err:.3e} "
          f"({rel:.1e} of the largest entry, {vrel:.1e} of the vocab "
          f"part's; against float64, kernel {k64:.2e} and plain {p64:.2e} "
          f"of the largest entry) "
          f"kernel_ms {k_ms:.4f} ({runs[0]:.4f}, {runs[2]:.4f}) "
          f"plain_ms {p_ms:.4f} ({runs[1]:.4f}, {runs[3]:.4f}); kernel / "
          f"plain {k_ms / p_ms:.3f}; library_ms none; bound_ms fp32 FMA "
          f"route {fp32_ms:.4f} ({fp32_by}), 3xTF32 route {tf32_ms:.4f} "
          f"({tf32_by}); achieved {(big + small) / k_ms / 1e9:.2f} TFLOP/s "
          f"on the function's {(big + small) / 1e9:.1f} GFLOP "
          f"({fp32_ms / k_ms:.3f} of the fp32 bound), "
          f"{3 * big / k_ms / 1e9:.2f} TFLOP/s of TF32 tensor work on "
          f"3 x {big / 1e9:.1f} GFLOP ({tf32_ms / k_ms:.3f} of the 3xTF32 "
          f"bound)", flush=True)
    del ins
    return (err, k_ms, p_ms) + min((fp32_ms, fp32_by), (tf32_ms, tf32_by))


def leaf_names(tree, prefix: str = ""):
    """Names of a params tree's leaves in ``tree_leaves`` order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def rnnt_run_record(hist):
    """What one RNN-T main path printed: every epoch's train and val loss
    and every round's indices and weights, for a same-seed comparison."""
    return (list(hist.train_loss), list(hist.val_loss),
            [(s["epoch"], list(s["indices"]), list(s["weights"]))
             for s in hist.selections])


def kernel_times(torch, fn, reps: int):
    """Mean device time of each kernel that ``fn`` launches, over ``reps``
    calls under ``torch.profiler`` after a warm-up call -> {name: ms}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = ev.self_cuda_time_total
        out[ev.key] = dt / 1e3 / reps
    return out


def stage_a_rounds(torch, bundle, params, units, val_units, pgm_cfg, dev,
                   tag):
    """Two selection rounds on the same params and projections: stage A
    (a unit vector for every training and validation unit), timed on the
    host clock after a synchronize, then stage B.  Prints each round's
    stage-A time, whether the two rounds' unit vectors agree bit for bit
    and whether they pick the same subsets -> (bitwise equal, same
    subsets)."""
    from repro_torch.core.lastlayer import make_proj_for, units_gradients
    from repro_torch.core.pgm import _stage_b, _val_target
    from repro_torch.train.engine import to_device

    us, vs = to_device(units, dev), to_device(val_units, dev)
    proj = make_proj_for(bundle, torch.Generator().manual_seed(0),
                         pgm_cfg.sketch_dim_h, pgm_cfg.sketch_dim_v, dev)
    rounds = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        g = units_gradients(bundle, params, us, proj)
        gv = units_gradients(bundle, params, vs, proj)
        torch.cuda.synchronize()
        secs = time.time() - t0
        sel = _stage_b(g, pgm_cfg, _val_target(gv, g.shape[0], pgm_cfg)
                       if pgm_cfg.val_matching else None)
        rounds.append((g, gv, sel.indices.cpu().tolist(),
                       sel.weights.cpu().tolist(), secs))
    (g1, gv1, i1, w1, s1), (g2, gv2, i2, w2, s2) = rounds
    require(bool(torch.isfinite(g1).all()), f"stage A {tag}: non-finite")
    bitwise = bool(torch.equal(g1, g2) and torch.equal(gv1, gv2))
    diff = float((g1 - g2).abs().max() / g1.abs().max())
    same = i1 == i2 and w1 == w2
    print(f"[stage A {tag}] {g1.shape[0]} training + {gv1.shape[0]} "
          f"validation units a round: {s1:.3f} s, {s2:.3f} s (host clock); "
          f"unit vectors bitwise equal across the two rounds: {bitwise} "
          f"(max diff {diff:.2e} of the largest entry); same subsets and "
          f"weights: {same}", flush=True)
    return bitwise, same


def wkv_decays(torch, B, S, H, N, w, g):
    """Decays in (0.4, 0.99) (``w`` None), all ``w``, or ``"mixed"``: by
    channel n, n % 3 == 0 below the 1e-8 clip, 1 at 0.999, 2 in (0.4,
    0.99)."""
    ww = torch.rand(B, S, H, N, generator=g) * 0.59 + 0.4
    if w == "mixed":
        n = torch.arange(N) % 3
        return torch.where(n == 0, 1e-9, torch.where(n == 1, 0.999, ww))
    return ww if w is None else torch.full((B, S, H, N), w)


def wkv_inputs(torch, B, S, H, N, w, seed, dev):
    """r, k, v standard normal; decays from ``wkv_decays``; u of scale
    0.1; lw = log(clip(w)); cotangents for y and the final state."""
    from repro_torch.kernels.rwkv6_scan.ref import log_decay
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn(B, S, H, N, generator=g) for _ in range(3))
    ww = wkv_decays(torch, B, S, H, N, w, g)
    u = torch.randn(H, N, generator=g) * 0.1
    cy = torch.randn(B, S, H, N, generator=g)
    cs = torch.randn(B, H, N, N, generator=g) * 0.1
    return ([x.to(dev) for x in (r, k, v, log_decay(ww), u)],
            (cy.to(dev), cs.to(dev)))


def wkv_plain(torch, r, k, v, lw, u, C):
    from repro_torch.kernels.rwkv6_scan.ref import wkv_chunked_lw
    B, _, H, N = r.shape
    return wkv_chunked_lw(r, k, v, lw, u,
                          torch.zeros(B, H, N, N, device=r.device), C)


def wkv_err(torch, op, shape, dev):
    """Forward and backward through ``op`` (the kernels) against autograd
    of the plain chunk algebra on the same card tensors, with cotangents
    on y and on the final state; two runs bitwise equal; each of y,
    state, dr, dk, dv, dlw, du within 1e-4 of its largest entry (at
    decays of 1e-6, dlw within 1e-5 of the largest dr entry: its true
    entries lie below the fp32 rounding of the terms that cancel in it)
    -> {name: (max abs err, scale)}."""
    B, S, H, N, C, w = shape
    ins, (cy, cs) = wkv_inputs(torch, B, S, H, N, w, seed=S + N, dev=dev)

    def run(fn):
        xs = [x.clone().requires_grad_(True) for x in ins]
        y, s = fn(*xs, C)
        (torch.sum(y * cy) + torch.sum(s * cs)).backward()
        return [y.detach(), s.detach()] + [x.grad for x in xs]

    got, again = run(op), run(op)
    torch.cuda.synchronize()
    want = run(lambda *a: wkv_plain(torch, *a))
    errs = {}
    for name, a, b, c in zip(("y", "state", "dr", "dk", "dv", "dlw", "du"),
                             got, again, want):
        require(bool(torch.isfinite(a).all()),
                f"rwkv6_wkv {shape}: non-finite {name}")
        require(bool(torch.equal(a, b)),
                f"rwkv6_wkv {shape}: two launches differ in {name}")
        tiny = name == "dlw" and w is not None
        scale = float((want[2] if tiny else c).abs().max())
        err = float((a - c).abs().max())
        require(err <= (1e-5 if tiny else 1e-4) * scale,
                f"rwkv6_wkv {shape}: {name} max abs err {err} against "
                f"scale {scale}")
        errs[name] = (err, scale)
    return errs


def swa_inputs(torch, B, S, KV, G, hd, dtype, lengths, seed, dev):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, KV, G, hd, generator=g)
    k, v = (torch.randn(B, S, KV, hd, generator=g) for _ in range(2))
    dt = getattr(torch, dtype)
    lens = (None if lengths is None
            else torch.tensor(lengths, dtype=torch.int32, device=dev))
    return [x.to(device=dev, dtype=dt) for x in (q, k, v)], lens


def swa_err(torch, op, ref, shape, dev):
    """Two launches on the same inputs agree bitwise, and the kernel
    agrees with the plain band gather on the same card tensors -> (max
    abs err, the largest share of its bar that an element takes).  Both
    compute in fp32 and differ only in the order of their sums.  At bf16
    both then round to bf16, so each element is held to one bf16 ulp of
    its own value, ``2**-7 |want| + 1e-5``; at fp32 the output is held to
    1e-5 of its largest entry (and to 1e-4, the reference tests' bar)."""
    B, S, KV, G, hd, W, dtype, lengths = shape
    (q, k, v), lens = swa_inputs(torch, B, S, KV, G, hd, dtype, lengths,
                                 seed=S + hd, dev=dev)
    got = op(q, k, v, window=W, lengths=lens)
    again = op(q, k, v, window=W, lengths=lens)
    torch.cuda.synchronize()
    require(bool(torch.equal(got, again)),
            f"swa_attn {shape}: two launches on the same inputs differ")
    want = ref(q, k, v, window=W, lengths=lens).float()
    diff = (got.float() - want).abs()
    if dtype == "float32":
        bar = torch.full_like(want, min(1e-4, 1e-5 * float(want.abs().max())))
    else:
        bar = 2.0 ** -7 * want.abs() + 1e-5
    margin = float((diff / bar).max())
    err = float(diff.max())
    require(bool(torch.isfinite(got).all()) and margin <= 1.0,
            f"swa_attn {shape}: an element is {margin:.2f} x its bar "
            f"(max abs err {err})")
    return err, margin


def band_pairs(S: int, W: int) -> int:
    """(query, key) pairs of a causal window W over S tokens."""
    return sum(min(s + 1, W) for s in range(S))


def serve_agreement(torch, bundle, p_cpu, dev, tree_map) -> None:
    """The 2-layer model served on one SERVE_AGREE_S-token prompt on the
    card (band kernel) and on the CPU (plain band gather): last logits
    within 1e-4 of their largest entry, the cache's k/v within 1e-5 of
    theirs, then SERVE_AGREE_STEPS greedy decode steps teacher-forced with
    the CPU's tokens, logits held to the same bar at every step, argmaxes
    equal wherever the CPU's top-2 margin exceeds 10x that bar."""
    V = bundle.cfg.vocab_size
    prompt = torch.randint(0, V, (1, SERVE_AGREE_S), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(3))
    runs = {}
    fed = []
    for where in ("cpu", "cuda"):
        on = torch.device("cpu") if where == "cpu" else dev
        p = tree_map(lambda x: x.to(on), p_cpu)
        t0 = time.time()
        with torch.no_grad():
            logits, cache = bundle.prefill(
                p, {"tokens": prompt.to(on)},
                cache_len=SERVE_AGREE_S + SERVE_AGREE_STEPS)
            # copies: decode writes the cache in place
            kv = [x.to("cpu", torch.float32, copy=True)
                  for grp in cache["groups"]
                  for name, x in sorted(grp.items()) if name in ("k", "v")]
            steps = [logits.float().cpu()[0]]
            for i in range(SERVE_AGREE_STEPS):
                if where == "cpu":
                    fed.append(int(torch.argmax(steps[-1])))
                tok = torch.tensor([fed[i]], dtype=torch.int32, device=on)
                logits, cache = bundle.decode(p, cache, tok)
                steps.append(logits.float().cpu()[0])
        if where == "cuda":
            torch.cuda.synchronize()
        runs[where] = (steps, kv, time.time() - t0)
        del p, cache
    kv_rel = max(float((a - b).abs().max() / b.abs().max())
                 for a, b in zip(runs["cuda"][1], runs["cpu"][1]))
    worst, forks = 0.0, 0
    for i, (a, b) in enumerate(zip(runs["cuda"][0], runs["cpu"][0])):
        require(bool(torch.isfinite(a).all()), f"serve step {i}: non-finite")
        bar = 1e-4 * float(b.abs().max())
        err = float((a - b).abs().max())
        worst = max(worst, err / float(b.abs().max()))
        require(err <= bar, f"serve agreement step {i}: logits err {err} "
                            f"> {bar}")
        top2 = torch.topk(b, 2).values
        if float(top2[0] - top2[1]) > 10 * bar:
            require(int(torch.argmax(a)) == int(torch.argmax(b)),
                    f"serve agreement step {i}: argmax differs")
        else:
            forks += 1
    require(kv_rel <= 1e-5, f"serve agreement: cache k/v err {kv_rel} of "
                            f"the largest entry > 1e-5")
    print(f"[agree] starcoder2-3b served at full width, 2 layers, fp32, one "
          f"prompt of {SERVE_AGREE_S} (band) + {SERVE_AGREE_STEPS} "
          f"teacher-forced decode steps: logits err at most {worst:.2e} of "
          f"the largest entry, cache k/v err {kv_rel:.2e} of their "
          f"largest entry, {SERVE_AGREE_STEPS + 1 - forks} of "
          f"{SERVE_AGREE_STEPS + 1} argmaxes held (the rest within 10x the "
          f"bar of a tie) (card {runs['cuda'][2]:.1f} s vs CPU "
          f"{runs['cpu'][2]:.1f} s)", flush=True)


def rnnt_trace(torch, bundle, params, feats, L, max_symbols):
    """The greedy transducer search of ``rnnt_greedy_reference`` with
    each decision's (frame, symbol, top-2 margin, largest |logit|)."""
    from repro_torch.models import rnnt as rnnt_mod
    dev = params["joint"]["w_out"].device
    with torch.no_grad():
        enc = rnnt_mod.encode(params, bundle.cfg,
                              torch.as_tensor(feats, device=dev))
        g, h = rnnt_mod.pred_start(params, bundle.cfg, 1, enc.dtype, dev)
        out = []
        for t in range(min(max(L // bundle.cfg.rnnt.time_reduction, 1),
                           enc.shape[1])):
            for _ in range(max_symbols):
                logits = rnnt_mod.joint_step(params, enc[:, t], g)[0]
                top2 = torch.topk(logits, 2).values
                k = int(torch.argmax(logits))
                out.append((t, k, float(top2[0] - top2[1]),
                            float(logits.abs().max())))
                if k == rnnt_mod.BLANK_ID:
                    break
                g, h = rnnt_mod.pred_step(
                    params, bundle.cfg, torch.tensor([k], device=dev), h)
    return out


def serve_rnnt(torch, np, bundle, params) -> None:
    """The slot engine on 8 launcher utterances against the non-streaming
    greedy search on the card, token for token; where they part, the
    decisions between the last shared token and the next are printed,
    and the phase fails unless the smallest top-2 margin among them is
    below 1e-5 of the largest |logit|."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve.engine import SlotEngine, rnnt_greedy_reference
    cfg = bundle.cfg
    max_new = RNNT_SERVE_FRAMES // cfg.rnnt.time_reduction * RNNT_MAX_SYMBOLS
    reqs = make_requests(cfg, SERVE_REQUESTS, RNNT_SERVE_FRAMES, max_new,
                         seed=0)
    eng = SlotEngine(bundle, params, n_slots=SERVE_SLOTS,
                     max_new_tokens=max_new, max_prompt_len=RNNT_SERVE_FRAMES,
                     sync_every=4, max_symbols=RNNT_MAX_SYMBOLS)
    torch.cuda.synchronize()
    t0 = time.time()
    comps = eng.run(reqs)
    wall = time.time() - t0
    require(len(comps) == SERVE_REQUESTS
            and all(c.status == "ok" for c in comps),
            "RNN-T serving: not every request completed")
    got = {c.uid: c.tokens for c in comps}
    n_tok, parted = 0, 0
    for r in reqs:
        L = r.inputs["feats"].shape[0]
        feats = np.zeros((1, eng.bucket_for(r), cfg.rnnt.n_feats), np.float32)
        feats[0, :L] = r.inputs["feats"]
        want = rnnt_greedy_reference(bundle, params, feats, np.asarray([L]),
                                     max_symbols=RNNT_MAX_SYMBOLS)[0]
        n_tok += len(want)
        if got[r.uid] == want:
            continue
        parted += 1
        u = next((i for i, (a, b) in enumerate(zip(got[r.uid], want))
                  if a != b), min(len(got[r.uid]), len(want)))
        trace = rnnt_trace(torch, bundle, params, feats, L, RNNT_MAX_SYMBOLS)
        emitted, window = 0, []
        for step, (t, k, margin, big) in enumerate(trace):
            if emitted >= u:
                window.append((step, t, margin, big))
            if k != 0:
                emitted += 1
                if emitted > u:
                    break
        step, t, margin, big = min(window, key=lambda w: w[2])
        print(f"[serve rnnt] request {r.uid} parts from the reference after "
              f"{u} tokens: decision {step} (frame {t}), top-2 margin "
              f"{margin:.3e}, largest |logit| {big:.3e}", flush=True)
        require(margin < 1e-5 * big, f"RNN-T serving: request {r.uid} "
                                     f"parts at a margin of {margin}")
    print(f"[serve rnnt] rnnt-crdnn slot engine ({SERVE_SLOTS} slots, "
          f"{SERVE_REQUESTS} utterances of {RNNT_SERVE_FRAMES // 2}-"
          f"{RNNT_SERVE_FRAMES} frames): {wall:.2f} s, "
          f"{SERVE_REQUESTS / wall:.1f} req/s, {n_tok} tokens; "
          f"{SERVE_REQUESTS - parted} of {SERVE_REQUESTS} token for token "
          f"equal to rnnt_greedy_reference on the card", flush=True)


def serve_lm(torch, bundle, params, dev, swa_op, other_ops):
    """The full-depth serving run: ``generate`` on 2 prompts of
    SERVE_PROMPT, then the slot engine on the launcher's requests; the
    band kernel's launches are counted over the two and must be 30 for
    every prefill with S > window + 1024 -> (launches, a summary)."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve.engine import SlotEngine, generate
    cfg = bundle.cfg
    V = cfg.vocab_size
    band_at = cfg.window + 1024
    prompts = torch.randint(0, V, (2, SERVE_PROMPT), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1)
                            ).to(dev)
    reqs = make_requests(cfg, SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW, seed=0)
    lens = [len(r.inputs["tokens"]) for r in reqs]
    n_band = 1 + sum(L > band_at for L in lens)
    for op in other_ops:
        op.launches = 0
    swa_op.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    toks, st = generate(bundle, params, prompts, SERVE_NEW)
    require(toks.shape == (2, SERVE_NEW), "generate: wrong shape")
    eng = SlotEngine(bundle, params, n_slots=SERVE_SLOTS,
                     max_new_tokens=SERVE_NEW, max_prompt_len=SERVE_PROMPT,
                     sync_every=4, seed=0)
    t0 = time.time()
    comps = eng.run(reqs)
    wall = time.time() - t0
    launches = swa_op.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(all(op.launches == 0 for op in other_ops),
            "the serving path launched a training-path kernel")
    require(launches == cfg.n_layers * n_band,
            f"swa_attn launched {launches} times, not {cfg.n_layers} x "
            f"{n_band} band prefills")
    require(len(comps) == SERVE_REQUESTS
            and all(c.status == "ok" and len(c.tokens) == SERVE_NEW
                    for c in comps), "slot engine: not 8 x 32 tokens")
    require(all(0 <= t < V for c in comps for t in c.tokens)
            and bool(((toks >= 0) & (toks < V)).all()), "token out of range")
    lat = sorted(c.latency_s for c in comps)
    print(f"[serve lm] generate B=2 x {SERVE_PROMPT} + {SERVE_NEW}: prefill "
          f"{st.prefill_s * 1e3:.1f} ms ({st.prefill_tokens_per_s:.0f} tok/s),"
          f" decode {st.decode_s * 1e3:.1f} ms / {st.decode_steps} steps "
          f"({st.decode_tokens} live tok, {st.tokens_per_s:.1f} tok/s)",
          flush=True)
    print(f"[serve lm] SlotEngine {SERVE_SLOTS} slots on {SERVE_REQUESTS} "
          f"requests (lengths {lens}, {n_band - 1} through the band, the "
          f"rest through flash), {SERVE_NEW} new tokens each: {wall:.2f} s "
          f"wall, {SERVE_REQUESTS / wall:.2f} req/s, "
          f"{SERVE_REQUESTS * SERVE_NEW / wall:.1f} tok/s, p50 latency "
          f"{lat[len(lat) // 2] * 1e3:.0f} ms, {eng.n_decode_dispatches} "
          f"decode scans; swa_attn launches {launches}; peak device memory "
          f"{peak_gb:.2f} GB (torch.cuda.max_memory_allocated)", flush=True)
    # first tokens: the same B = 1 prefill shapes and kernels as generate
    # on the prompt alone, so bitwise the same
    for c in comps:
        prompt = torch.from_numpy(reqs[c.uid].inputs["tokens"])[None].to(dev)
        alone, _ = generate(bundle, params, prompt, 1)
        require(int(alone[0, 0]) == c.tokens[0],
                f"request {c.uid}: first token {c.tokens[0]} != generate's "
                f"{int(alone[0, 0])}")
    print(f"[serve lm] every completion's first token equals generate on its "
          f"prompt alone", flush=True)
    # where a decode micro-step's time goes: one scan over the 4 slots
    # (every slot now dead, so each micro-step is computed with its
    # cache writes masked, the same work as a live one)
    profile_call(torch, eng._decode_scan, "serve",
                 f"one decode scan ({eng.sync_every} micro-steps x "
                 f"{SERVE_SLOTS} slots, {cfg.n_layers} layers, caches of "
                 f"{cfg.window} slots)")
    # where the prefill's time goes: generate's 2 x SERVE_PROMPT prompts
    # with one new token (the prefill and its first token, no decode)
    profile_call(torch, lambda: generate(bundle, params, prompts, 1),
                 "serve", f"one prefill (generate, B=2 x {SERVE_PROMPT}, "
                 f"1 new token)")
    return launches


def profile_call(torch, fn, tag: str, what: str) -> None:
    """``fn()`` once under ``torch.profiler`` after a warm-up call: host
    wall time, summed kernel time (device busy share), and the kernels
    that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()                                                # warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue                            # host-side op records
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = ev.self_cuda_time_total
        rows.append((dt / 1e3, ev.count, ev.key))
    busy_ms = sum(r[0] for r in rows)
    n_kernels = sum(r[1] for r in rows)
    print(f"[profile {tag}] {what}: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), {n_kernels} "
          f"device ops", flush=True)
    for dt, count, key in sorted(rows, reverse=True)[:8]:
        print(f"[profile {tag}]   {dt:8.3f} ms  x{count:<6d} {key[:80]}",
              flush=True)


def profile_step(torch, bundle, tc, units, dev, params, tag) -> None:
    """One training step on one unit under the profiler."""
    from repro_torch.train.engine import make_step_core, to_device
    from repro_torch.train.optim import make_update_for

    opt_state = make_update_for(tc)[0](params)
    step = make_step_core(bundle, tc)
    batch = to_device({k: v[0] for k, v in units.items()}, dev)
    profile_call(torch, lambda: step(params, opt_state, batch, tc.lr), tag,
                 f"one training step (B={UNIT_SIZE})")


def main() -> None:
    clock = [time.time()]

    def mark(phase: str) -> None:
        now = time.time()
        print(f"[time] {phase}: {now - clock[0]:.1f} s", flush=True)
        clock[0] = now

    require((SRC / "repro_torch" / "kernels" / "backend.py").is_file(),
            f"the port's sources are not beside this script ({SRC})")
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")

    from repro_torch.configs import get_config
    from repro_torch.configs.base import PGMConfig, TrainConfig
    from repro_torch.core.lastlayer import rnnt_joint_grad, units_gradients
    from repro_torch.core.sketch import make_projections
    from repro_torch.data.pipeline import asr_units
    from repro_torch.data.synthetic import make_asr_corpus
    from repro_torch.kernels import backend
    from repro_torch.kernels.grad_sketch.ops import grad_sketch_units_op
    from repro_torch.kernels.grad_sketch.ref import grad_sketch_units_ref
    from repro_torch.launch.train import make_units_for
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.kernels.omp_gram.ops import omp_gram_batched_op
    from repro_torch.kernels.omp_gram.ref import omp_gram_batched_ref
    from repro_torch.kernels.rnnt_lattice.ops import (ring_depth,
                                                      rnnt_lattice_op)
    from repro_torch.kernels.rnnt_lattice.ref import rnnt_lattice_ref
    from repro_torch.kernels.rwkv6_scan.ops import (rwkv6_wkv_op,
                                                    wkv_backward, wkv_forward)
    from repro_torch.kernels.swa_attn.ops import swa_attn_op
    from repro_torch.kernels.swa_attn.ref import swa_attn_ref
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import train_with_selection

    # -- 1. environment -------------------------------------------------
    dev = backend.resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    backend.fp32_numerics()
    require(not torch.backends.cudnn.allow_tf32
            and not torch.backends.cuda.matmul.allow_tf32,
            "TF32 still on")
    print(f"[env] {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | TF32 off "
          f"(matmul, cuDNN), matmul precision "
          f"{torch.get_float32_matmul_precision()}", flush=True)

    mark("environment")

    # -- 2. build -------------------------------------------------------
    t0 = time.time()
    paths = backend.build()
    print(f"[build] {len(paths)} kernels in {time.time() - t0:.1f} s "
          f"(nvcc sm_90a)", flush=True)
    for name, log in backend.BUILD_LOG.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"[build] {name}: {'; '.join(regs)}", flush=True)

    mark("build")

    # -- 3. kernels against their plain versions ------------------------
    cfg = get_config("rnnt-crdnn")
    r = cfg.rnnt
    T_main = CORPUS["max_tokens"] * CORPUS["frames_per_token"] // 4
    U1_main = CORPUS["max_tokens"] + 1
    lat_shape = (T_main, UNIT_SIZE, U1_main)
    for T in (1, 9):
        for U1 in LATTICE_U1:
            ins = lattice_inputs(torch, T, 3, U1, seed=U1, dev=dev)
            got, again = rnnt_lattice_op(*ins), rnnt_lattice_op(*ins)
            torch.cuda.synchronize()
            require(bool(torch.equal(got, again)),
                    f"rnnt_lattice ({T}, 3, {U1}): two launches differ")
            lattice_err(torch, got, rnnt_lattice_ref(*ins))
    print(f"[kernels] rnnt_lattice edge shapes T in (1, 9), U1 in "
          f"{LATTICE_U1} (ring depths "
          f"{sorted({ring_depth(u) for u in LATTICE_U1}, reverse=True)}): "
          f"ok, two launches bitwise equal", flush=True)
    ins = lattice_inputs(torch, *lat_shape, seed=0, dev=dev)
    got, again = rnnt_lattice_op(*ins), rnnt_lattice_op(*ins)
    torch.cuda.synchronize()
    require(bool(torch.equal(got, again)),
            f"rnnt_lattice {lat_shape}: two launches differ")
    lat_err = lattice_err(torch, got, rnnt_lattice_ref(*ins))
    lat_ms = cuda_ms(torch, lambda: rnnt_lattice_op(*ins), reps=200)
    lat_plain = cuda_ms(torch, lambda: rnnt_lattice_ref(*ins), reps=5)
    cells = math.prod(lat_shape)
    # per cell: 2 adds and 2 logaddexps of 6 ops (max, sub, abs, exp,
    # log1p, add); 3 inputs read, 1 output written
    lat_bound, lat_by = bound(16 * cells, 14 * cells)
    print(f"[kernels] rnnt_lattice {lat_shape}: max_abs_err {lat_err:.3e} "
          f"kernel_ms {lat_ms:.4f} ({lat_ms * 1e3 / lat_shape[0]:.3f} us a "
          f"row, ring of {ring_depth(lat_shape[2])}) plain_ms "
          f"{lat_plain:.4f} library_ms none bound_ms {lat_bound:.6f} "
          f"({lat_by}); two launches bitwise equal", flush=True)

    n_units = CORPUS["n_examples"] // UNIT_SIZE
    P_main = 4
    D_sk = 64 * 64
    gram_rows = {}
    for shape in ((P_main, n_units // P_main, D_sk), (8, 512, 4096)):
        g = torch.randn(*shape, generator=torch.Generator().manual_seed(1)
                        ).to(dev)
        got, again = omp_gram_batched_op(g), omp_gram_batched_op(g)
        torch.cuda.synchronize()
        require(bool(torch.equal(got, again)),
                f"omp_gram {shape}: two launches on the same inputs differ")
        require(bool(torch.equal(got, got.transpose(1, 2))),
                f"omp_gram {shape}: K is not exactly symmetric")
        err = gram_err(torch, got, omp_gram_batched_ref(g))
        P, n, D = shape
        reps = 50 if n >= 256 else 500
        gt = g.transpose(1, 2)
        # kernel and library in turns, twice; the plain version once
        k_ms, l_ms = [], []
        for _ in range(2):
            k_ms.append(cuda_ms(torch, lambda: omp_gram_batched_op(g), reps))
            l_ms.append(cuda_ms(torch, lambda: torch.bmm(g, gt), reps))
        p_ms = cuda_ms(torch, lambda: omp_gram_batched_ref(g), reps)
        k_ms, l_ms = sum(k_ms) / 2, sum(l_ms) / 2
        # K is symmetric: the function needs its upper triangle only,
        # n (n + 1) / 2 entries of 2 D FLOPs a partition
        g_ops = P * n * (n + 1) * D
        b_ms, b_by = bound(4 * (P * n * D + P * n * n), g_ops)
        gram_rows[shape] = (err, k_ms, p_ms, l_ms, b_ms, b_by)
        print(f"[kernels] omp_gram {shape}: max_abs_err {err:.3e} kernel_ms "
              f"{k_ms:.4f} plain_ms {p_ms:.4f} library_ms (torch.bmm) "
              f"{l_ms:.4f} (kernel / library {k_ms / l_ms:.3f}) bound_ms "
              f"{b_ms:.6f} ({b_by}) achieved {g_ops / k_ms / 1e9:.2f} "
              f"TFLOP/s (counting the upper triangle); two launches bitwise "
              f"equal, K exactly symmetric", flush=True)

    for shape in SKETCH_EDGES:
        sketch_err(torch, grad_sketch_units_op, grad_sketch_units_ref,
                   sketch_inputs(torch, *shape, seed=sum(shape), dev=dev))
    print(f"[kernels] grad_sketch edge shapes (U, n, d, V, k1, k2) in "
          f"{SKETCH_EDGES}: ok, two launches bitwise equal", flush=True)
    # the LM path's stage-A unit (tied head), then the RWKV path's (untied)
    sk_err, sk_ms, sk_plain, sk_bound, sk_by = sketch_row(
        torch, grad_sketch_units_op, grad_sketch_units_ref, SKETCH_MAIN, 0,
        dev, "lm")
    skr_err, skr_ms, skr_plain, skr_bound, skr_by = sketch_row(
        torch, grad_sketch_units_op, grad_sketch_units_ref, SKETCH_RWKV, 1,
        dev, "rwkv")

    for shape in WKV_EDGES:
        wkv_err(torch, rwkv6_wkv_op, shape, dev)
    print(f"[kernels] rwkv6_wkv forward + backward edge shapes (B, S, H, N, "
          f"C, decay) in {WKV_EDGES}: ok, two launches bitwise equal",
          flush=True)
    wkv_errs = wkv_err(torch, rwkv6_wkv_op, WKV_MAIN, dev)
    B, S, H, N, C, _ = WKV_MAIN
    ins, (cy, cs) = wkv_inputs(torch, B, S, H, N, None, seed=0, dev=dev)
    wkv_ms = cuda_ms(torch, lambda: wkv_forward(*ins, C, True), reps=20)
    wkv_ms_nostate = cuda_ms(torch, lambda: wkv_forward(*ins, C, False),
                             reps=20)
    # the forward is three launches: each chunk's state increment, the
    # scan over chunks, each chunk's output
    phases = kernel_times(torch, lambda: wkv_forward(*ins, C, True), 20)
    print("[kernels] rwkv6_wkv forward phases (device ms a launch, "
          "torch.profiler): " + ", ".join(
              f"{re.search(r'wkv_[a-z]+_kernel', k).group(0)} {v:.4f}"
              for k, v in phases.items()
              if re.search(r"wkv_(chunk|scan|out)_kernel", k)), flush=True)
    _, _, states = wkv_forward(*ins, C, True)
    wkvb_ms = cuda_ms(torch, lambda: wkv_backward(*ins, states, cy, cs, C),
                      reps=20)
    # the backward is three launches: each chunk's increment of the state
    # gradient, the reverse scan over chunks, each chunk's gradients
    phases = kernel_times(
        torch, lambda: wkv_backward(*ins, states, cy, cs, C), 20)
    print("[kernels] rwkv6_wkv backward phases (device ms a launch, "
          "torch.profiler): " + ", ".join(
              f"{re.search(r'wkv_bwd_[a-z]+_kernel', k).group(0)} {v:.4f}"
              for k, v in phases.items()
              if re.search(r"wkv_bwd_[a-z]+_kernel", k)), flush=True)
    with torch.no_grad():
        wkv_plain_ms = cuda_ms(torch, lambda: wkv_plain(torch, *ins, C),
                               reps=5)
    xs = [x.clone().requires_grad_(True) for x in ins]
    y_p, s_p = wkv_plain(torch, *xs, C)
    wkvb_plain_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        (y_p, s_p), xs, (cy, cs), retain_graph=True), reps=5)
    del xs, y_p, s_p, states
    # what the function needs: r, k, v, lw, u read once; y, the final
    # state and the chunk states the backward takes written once; the
    # recurrence's k^T v and r S, 4 N^2 FLOP a (token, head).  Backward:
    # r, k, v, lw, u, dy, d(state), the chunk states read, dr, dk, dv, dlw
    # and du written; dy S^T, r^T dy, v dS^T, k dS: 8 N^2 FLOP.
    bshn, bhnn = B * S * H * N, B * H * N * N
    n_states = B * H * (S // C) * N * N
    wkv_bound, wkv_by = bound(
        4 * (4 * bshn + H * N + bshn + bhnn + n_states), 4 * N * N * B * S * H)
    wkvb_bound, wkvb_by = bound(
        4 * (5 * bshn + H * N + bhnn + n_states + 4 * bshn + H * N),
        8 * N * N * B * S * H)
    wkv_rel = {k: e / sc if sc else 0.0 for k, (e, sc) in wkv_errs.items()}
    wkv_abs = max(wkv_errs[k][0] for k in ("y", "state"))
    wkvb_abs = max(wkv_errs[k][0] for k in ("dr", "dk", "dv", "dlw", "du"))
    print(f"[kernels] rwkv6_wkv {WKV_MAIN[:5]}: forward err "
          f"(y {wkv_rel['y']:.1e}, state {wkv_rel['state']:.1e} of the "
          f"largest entry) kernel_ms {wkv_ms:.4f} (without the chunk states "
          f"{wkv_ms_nostate:.4f}) plain_ms {wkv_plain_ms:.4f} library_ms "
          f"none bound_ms {wkv_bound:.4f} ({wkv_by})", flush=True)
    print(f"[kernels] rwkv6_wkv_bwd {WKV_MAIN[:5]}: err "
          + ", ".join(f"{k} {wkv_rel[k]:.1e}"
                      for k in ("dr", "dk", "dv", "dlw", "du"))
          + f" of the largest entry; kernel_ms {wkvb_ms:.4f} plain_ms "
          f"{wkvb_plain_ms:.4f} (autograd of the plain version) library_ms "
          f"none bound_ms {wkvb_bound:.4f} ({wkvb_by})", flush=True)
    del ins, cy, cs

    # (B, S, KV, G, hd, window, dtype, lengths): max abs err, and the
    # largest share of its bar that an element takes; the main shape in
    # fp32, then in bf16 last, whose error the kernels line reports
    for shape in SWA_EDGES + (SWA_MAIN[:6] + ("float32", None), SWA_MAIN):
        swa_abs, swa_margin = swa_err(torch, swa_attn_op, swa_attn_ref,
                                      shape, dev)
        print(f"[kernels] swa_attn {shape}: max abs err {swa_abs:.3e}, "
              f"{swa_margin:.3f} of the bar at most; two launches bitwise "
              f"equal", flush=True)
    B, S, KV, G, hd, W, dtype, _ = SWA_MAIN
    (q, k, v), _ = swa_inputs(torch, B, S, KV, G, hd, dtype, None, seed=0,
                              dev=dev)
    # the library yardstick, timed only: PyTorch's SDPA on (B, H, S, hd)
    # with k, v repeated over the group and the band as a boolean mask
    H = KV * G
    qh = q.reshape(B, S, H, hd).transpose(1, 2).contiguous()
    kh, vh = (x.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
              for x in (k, v))
    pos = torch.arange(S, device=dev)
    band = ((pos[:, None] - pos[None, :]) >= 0) \
        & ((pos[:, None] - pos[None, :]) < W)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        lib = sdpa(qh, kh, vh, attn_mask=band)
        lib_err = float((lib.transpose(1, 2).reshape(q.shape).float()
                         - swa_attn_op(q, k, v, window=W).float()).abs().max())
        # kernel and library in turns, twice; the plain version once
        swa_runs, lib_runs = [], []
        for _ in range(2):
            swa_runs.append(cuda_ms(
                torch, lambda: swa_attn_op(q, k, v, window=W), reps=20))
            lib_runs.append(cuda_ms(
                torch, lambda: sdpa(qh, kh, vh, attn_mask=band), reps=5))
        swa_plain = cuda_ms(torch, lambda: swa_attn_ref(q, k, v, window=W),
                            reps=3)
    swa_ms, swa_lib = sum(swa_runs) / 2, sum(lib_runs) / 2
    del qh, kh, vh, band, lib
    # what the function needs: q, k, v read once and o written once (bf16);
    # q.k and p.v over the band's pairs, 4 hd FLOP a pair and head, at the
    # bf16 tensor-core peak since the inputs are bf16.  The bf16 kernel
    # runs p.v twice (p split into bf16 hi + lo): 6 hd FLOP a pair on the
    # tensor cores
    swa_ops = 4 * hd * band_pairs(S, W) * H * B
    swa_tc_ops = swa_ops * 3 // 2
    swa_bound, swa_by = bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                              swa_ops, BF16_FLOP_PER_S)
    print(f"[kernels] swa_attn {SWA_MAIN[:7]}: max_abs_err {swa_abs:.3e} "
          f"({swa_margin:.3f} of the one-ulp bar) "
          f"kernel_ms {swa_ms:.4f} ({swa_runs[0]:.4f}, {swa_runs[1]:.4f}) "
          f"plain_ms {swa_plain:.4f} library_ms "
          f"(scaled_dot_product_attention, band mask; max abs diff to the "
          f"kernel {lib_err:.3e}) {swa_lib:.4f} ({lib_runs[0]:.4f}, "
          f"{lib_runs[1]:.4f}); kernel / library {swa_ms / swa_lib:.3f}; "
          f"bound_ms {swa_bound:.4f} ({swa_by}, bf16 peak; "
          f"{swa_ops / FP32_FLOP_PER_S * 1e3:.3f} ms at the fp32 peak) "
          f"achieved {swa_ops / swa_ms / 1e9:.2f} TFLOP/s on the function's "
          f"{swa_ops / 1e9:.1f} GFLOP, {swa_tc_ops / swa_ms / 1e9:.2f} on the "
          f"{swa_tc_ops / 1e9:.1f} GFLOP the tensor cores run", flush=True)
    del q, k, v

    mark("kernels")

    # -- 4. agreement: one full-width unit, card kernels vs CPU plain ----
    bundle = build_model(cfg)
    corpus = make_asr_corpus(0, **CORPUS)
    val_corpus = make_asr_corpus(7, N_VAL, **{
        k: v for k, v in CORPUS.items()
        if k not in ("n_examples", "noise_fraction", "snr_db")})
    units = asr_units(corpus, UNIT_SIZE)
    val_units = asr_units(val_corpus, UNIT_SIZE)
    params_cpu = bundle.init_params(torch.Generator().manual_seed(0),
                                    torch.device("cpu"))
    params_dev = {k: {kk: vv.to(dev) for kk, vv in v.items()}
                  for k, v in params_cpu.items()}
    unit = {k: torch.as_tensor(v[0]) for k, v in units.items()}
    out = {}
    for where, p in (("cpu", params_cpu), ("cuda", params_dev)):
        u = {k: v.to(p["joint"]["w_out"].device) for k, v in unit.items()}
        with torch.no_grad():
            loss = bundle.per_example_loss(p, u)
        out[where] = (loss.cpu(), rnnt_joint_grad(bundle, p, u).cpu())
        if where == "cuda":
            # the fused backward twice: the same dw_out bits (its label
            # columns are summed by a product, not an atomic scatter)
            again = rnnt_joint_grad(bundle, p, u).cpu()
            require(bool(torch.equal(again, out["cuda"][1])),
                    "rnnt-crdnn: two fused backwards give different dw_out "
                    "bits")
    require(out["cuda"][0].shape == (UNIT_SIZE,)
            and bool(torch.isfinite(out["cuda"][0]).all())
            and bool(torch.isfinite(out["cuda"][1]).all()),
            "non-finite full-width loss or gradient on the card")
    loss_rel = float(((out["cuda"][0] - out["cpu"][0]).abs()
                      / out["cpu"][0].abs()).max())
    grad_rel = float((out["cuda"][1] - out["cpu"][1]).abs().max()
                     / out["cpu"][1].abs().max())
    print(f"[agree] rnnt-crdnn unit (B={UNIT_SIZE}, T'={T_main}, "
          f"U+1={U1_main}, V={r.vocab_size}): loss rel err {loss_rel:.2e}, "
          f"dw_out rel err {grad_rel:.2e} (card kernels vs CPU plain); "
          f"dw_out of two fused backwards on the card bitwise equal",
          flush=True)
    require(loss_rel < 1e-4 and grad_rel < 1e-3,
            "card and CPU disagree on the full-width unit")
    # F3: the whole training gradient twice from the same params and
    # batch, every leaf equal bit for bit (with cudnn.deterministic False
    # the convolution leaves differed from run to run)
    ub = {k: v.to(dev) for k, v in unit.items()}
    full = []
    for _ in range(2):
        live = tree_map(lambda x: x.detach().requires_grad_(True), params_dev)
        total, _ = bundle.loss_fn(live, ub)
        full.append(torch.autograd.grad(total, tree_leaves(live)))
    torch.cuda.synchronize()
    names = leaf_names(params_dev)
    differ = [n for n, a, b in zip(names, *full) if not torch.equal(a, b)]
    require(len(full[0]) == len(names)
            and all(bool(torch.isfinite(g).all()) for g in full[0]),
            "rnnt-crdnn: non-finite training gradient on the card")
    print(f"[agree] rnnt-crdnn training gradient twice on the card: "
          f"{len(names)} leaves, {len(names) - len(differ)} bitwise equal"
          f"{'; differ: ' + str(differ) if differ else ''} "
          f"(cudnn.deterministic {torch.backends.cudnn.deterministic}, "
          f"benchmark {torch.backends.cudnn.benchmark})", flush=True)
    require(not differ, f"rnnt-crdnn: the training gradient is not bitwise "
                        f"repeatable in {differ}")
    del full, live, total, ub

    lm_cfg = get_config("starcoder2-3b")
    cfg2 = dataclasses.replace(lm_cfg, n_layers=2, compute_dtype="float32")
    lm2 = build_model(cfg2)
    lm_units, lm_val = make_units_for(lm_cfg, n=LM_N, seq=LM_SEQ, noise=0.0)
    gen = torch.Generator().manual_seed(0)
    p_cpu = lm2.init_params(gen, torch.device("cpu"))
    proj_cpu = make_projections(gen, lm_cfg.d_model, lm_cfg.vocab_size)
    unit = {k: torch.as_tensor(v[:1]) for k, v in lm_units.items()}
    out = {}
    for where in ("cpu", "cuda"):
        on = torch.device("cpu") if where == "cpu" else dev
        p = tree_map(lambda x: x.to(on), p_cpu)
        pr = type(proj_cpu)(*(x.to(on) for x in proj_cpu))
        u = {k: v.to(on) for k, v in unit.items()}
        t_a = time.time()
        with torch.no_grad():
            loss = lm2.per_example_loss(p, {k: v[0] for k, v in u.items()})
        sk = units_gradients(lm2, p, u, pr)
        out[where] = (loss.cpu(), sk.cpu(), time.time() - t_a)
        del p
    require(bool(torch.isfinite(out["cuda"][0]).all())
            and bool(torch.isfinite(out["cuda"][1]).all()),
            "non-finite LM loss or sketch on the card")
    loss_rel = float(((out["cuda"][0] - out["cpu"][0]).abs()
                      / out["cpu"][0].abs()).max())
    unit_rel = float((out["cuda"][1] - out["cpu"][1]).abs().max()
                   / out["cpu"][1].abs().max())
    print(f"[agree] starcoder2-3b unit at full width, 2 layers, fp32 "
          f"(B={UNIT_SIZE}, S={LM_SEQ}, V={lm_cfg.vocab_size}): loss rel "
          f"err {loss_rel:.2e}, stage-A sketch err {unit_rel:.2e} of its "
          f"largest entry (card {out['cuda'][2]:.1f} s vs CPU "
          f"{out['cpu'][2]:.1f} s)", flush=True)
    require(loss_rel < 1e-4 and unit_rel < 1e-3,
            "card and CPU disagree on the full-width LM unit")
    serve_agreement(torch, lm2, p_cpu, dev, tree_map)
    del p_cpu, lm2

    rw_cfg = get_config("rwkv6-3b")
    cfg3 = dataclasses.replace(rw_cfg, n_layers=2, compute_dtype="float32")
    rw2 = build_model(cfg3)
    rw_units, rw_val = make_units_for(rw_cfg, n=LM_N, seq=LM_SEQ, noise=0.0)
    gen = torch.Generator().manual_seed(0)
    p_cpu = rw2.init_params(gen, torch.device("cpu"))
    proj_cpu = make_projections(gen, rw_cfg.d_model, rw_cfg.vocab_size)
    unit = {k: torch.as_tensor(v[:1]) for k, v in rw_units.items()}
    out = {}
    for where in ("cpu", "cuda"):
        on = torch.device("cpu") if where == "cpu" else dev
        p = tree_map(lambda x: x.detach().to(on).requires_grad_(True),
                     p_cpu)
        pr = type(proj_cpu)(*(x.to(on) for x in proj_cpu))
        u = {k: v.to(on) for k, v in unit.items()}
        t_a = time.time()
        # per-example loss and its mean's gradient in one pass (the
        # weighted loss with unit weights)
        loss = rw2.per_example_loss(p, {k: v[0] for k, v in u.items()})
        loss.mean().backward()
        tm = p["stack"]["groups"][0]["tmix"]
        grads = {k: v.grad[0].cpu() for k, v in tm.items()}
        if where == "cuda":
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
        sk = units_gradients(rw2, p, u, pr)
        if where == "cuda":
            # stage A copies the untied (d, V) head to (V, d) rows once a
            # unit (671 MB at full width); the copy must not outlive it
            torch.cuda.synchronize()
            kept = torch.cuda.memory_allocated() - held
            require(kept < 1e6, f"stage A kept {kept} bytes on the card "
                                f"after the unit")
        out[where] = (loss.detach().cpu(), sk.cpu(), grads,
                      time.time() - t_a)
        # the loss's graph holds the leaves (and their grads) alive
        del p, tm, loss, sk, pr, u
    require(bool(torch.isfinite(out["cuda"][0]).all())
            and bool(torch.isfinite(out["cuda"][1]).all())
            and all(bool(torch.isfinite(g).all())
                    for g in out["cuda"][2].values()),
            "non-finite RWKV loss, sketch or gradient on the card")
    loss_rel = float(((out["cuda"][0] - out["cpu"][0]).abs()
                      / out["cpu"][0].abs()).max())
    unit_rel = float((out["cuda"][1] - out["cpu"][1]).abs().max()
                     / out["cpu"][1].abs().max())
    tmix_rel = {k: float((g - out["cpu"][2][k]).abs().max()
                         / out["cpu"][2][k].abs().max())
                for k, g in out["cuda"][2].items()}
    worst = max(tmix_rel, key=tmix_rel.get)
    print(f"[agree] rwkv6-3b unit at full width, 2 layers, fp32 "
          f"(B={UNIT_SIZE}, S={LM_SEQ}, V={rw_cfg.vocab_size}): loss rel "
          f"err {loss_rel:.2e}, stage-A sketch err {unit_rel:.2e} of its "
          f"largest entry, layer-0 time-mix gradients' err at most "
          f"{tmix_rel[worst]:.2e} of a leaf's largest entry ({worst}; "
          f"decay_base {tmix_rel['decay_base']:.2e}, bonus "
          f"{tmix_rel['bonus']:.2e}) (card {out['cuda'][3]:.1f} s vs CPU "
          f"{out['cpu'][3]:.1f} s)", flush=True)
    require(loss_rel < 1e-4 and unit_rel < 1e-3 and tmix_rel[worst] < 1e-3,
            "card and CPU disagree on the full-width RWKV unit")
    del p_cpu, rw2, out

    mark("agreement")

    # -- 5. main path ---------------------------------------------------
    tc = TrainConfig(lr=0.5, optimizer="sgd", epochs=3, seed=0,
                     pgm=PGMConfig(subset_fraction=0.5, n_partitions=P_main,
                                   select_every=1, warm_start_epochs=1,
                                   val_matching=True))
    print(f"[main] rnnt-crdnn ({cfg.n_params() / 1e6:.1f}M params) on "
          f"{n_units} units of {UNIT_SIZE} utterances (T={CORPUS['max_tokens'] * CORPUS['frames_per_token']}, "
          f"U<={CORPUS['max_tokens']}), {N_VAL} validation utterances, "
          f"{tc.epochs} epochs, warm start {tc.pgm.warm_start_epochs}, "
          f"{P_main} partitions, subset {tc.pgm.subset_fraction}", flush=True)
    rnnt_lattice_op.launches = 0
    omp_gram_batched_op.launches = 0
    grad_sketch_units_op.launches = 0
    swa_attn_op.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    hist = train_with_selection(
        bundle, units, tc, method="pgm", val_units=val_units, device="cuda",
        log_fn=lambda s: print(f"[main +{time.time() - t0:.1f}s] {s}",
                               flush=True))
    torch.cuda.synchronize()
    main_s = time.time() - t0
    launches = {"rnnt_lattice": rnnt_lattice_op.launches,
                "omp_gram": omp_gram_batched_op.launches}
    require(grad_sketch_units_op.launches == 0
            and swa_attn_op.launches == 0,
            "the RNN-T path launched an LM kernel")
    for s in hist.selections:
        print(f"[main] selection at epoch {s['epoch']}: indices "
              f"{s['indices']} weights "
              f"{[round(w, 4) for w in s['weights']]} ({s['seconds']:.3f} s, "
              f"stage A + B)", flush=True)
    print(f"[main] {main_s:.1f} s; launches {launches}", flush=True)
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the main path was never launched: {launches}")
    require(len(hist.selections) == 2 and len(hist.train_loss) == tc.epochs,
            "the main path did not run its selection rounds and epochs")
    require(all(np.isfinite(hist.train_loss))
            and all(np.isfinite(hist.val_loss)), "non-finite loss")
    require(all(len(s["indices"]) == n_units // 2 for s in hist.selections),
            "selection budget")

    # F3: the same main path again, same seed, its launches counted apart
    # from the first run's: every epoch's losses and every round's subset
    # and weights must come out the same
    first = rnnt_run_record(hist)
    rnnt_lattice_op.launches = 0
    omp_gram_batched_op.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    hist2 = train_with_selection(
        bundle, units, tc, method="pgm", val_units=val_units, device="cuda",
        log_fn=lambda s: print(f"[main again +{time.time() - t0:.1f}s] {s}",
                               flush=True))
    torch.cuda.synchronize()
    again_launches = {"rnnt_lattice": rnnt_lattice_op.launches,
                      "omp_gram": omp_gram_batched_op.launches}
    same_run = rnnt_run_record(hist2) == first
    print(f"[main again] the RNN-T main path a second time with seed "
          f"{tc.seed}: {time.time() - t0:.1f} s; launches {again_launches}; "
          f"every epoch's train and val loss and every round's indices and "
          f"weights equal to the first run's: {same_run}", flush=True)
    require(same_run, f"two RNN-T main paths of one seed differ: "
                      f"{first} against {rnnt_run_record(hist2)}")
    del hist2

    # two stage-A rounds on the trained params (outside the counted run)
    stage_a_rounds(torch, bundle, hist.final_params, units, val_units, tc.pgm,
                   dev, "rnnt")

    mark("main path, RNN-T")

    # -- 6. where a training step's time goes (outside the counted run) --
    profile_step(torch, bundle, tc, units, dev, hist.final_params, "rnnt")

    mark("profile, RNN-T")

    # -- 7. serving, RNN-T: streaming greedy search ---------------------
    # random weights: the 3-epoch model of phase 5 emits only blanks on
    # these utterances, which would hold nothing token for token
    del hist
    serve_rnnt(torch, np, bundle,
               bundle.init_params(torch.Generator().manual_seed(1), dev))

    mark("serving, RNN-T")

    # -- 8. main path, LM: starcoder2-3b at full width and depth ---------
    lm = build_model(lm_cfg)
    n_lm = LM_N // UNIT_SIZE
    # lr 0.05, not the launcher's 0.5: from this random init (embedding
    # std 1, tied head) SGD at 0.5 raised the validation loss at full
    # depth on the card (PERF.md, section 6)
    tc_lm = TrainConfig(lr=0.05, optimizer="sgd", epochs=3, seed=0,
                        pgm=PGMConfig(subset_fraction=0.5,
                                      n_partitions=P_main, select_every=1,
                                      warm_start_epochs=1,
                                      val_matching=True))
    print(f"[main lm] starcoder2-3b ({lm_cfg.n_params() / 1e9:.2f}B params, "
          f"{lm_cfg.n_layers} layers, d_model {lm_cfg.d_model}, "
          f"{lm_cfg.compute_dtype} compute, fp32 master weights) on {n_lm} "
          f"units of {UNIT_SIZE} x {LM_SEQ} tokens, "
          f"{lm_val['tokens'].shape[0] * UNIT_SIZE} validation examples, "
          f"{tc_lm.epochs} epochs, warm start 1, {P_main} partitions, "
          f"subset 0.5", flush=True)
    omp_gram_batched_op.launches = 0
    grad_sketch_units_op.launches = 0
    rnnt_lattice_op.launches = 0
    swa_attn_op.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    hist = train_with_selection(
        lm, lm_units, tc_lm, method="pgm", val_units=lm_val, device="cuda",
        log_fn=lambda s: print(f"[main lm +{time.time() - t0:.1f}s] {s}",
                               flush=True))
    torch.cuda.synchronize()
    lm_s = time.time() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lm_launches = {"grad_sketch": grad_sketch_units_op.launches,
                   "omp_gram": omp_gram_batched_op.launches}
    for s in hist.selections:
        print(f"[main lm] selection at epoch {s['epoch']}: indices "
              f"{s['indices']} weights "
              f"{[round(w, 4) for w in s['weights']]} ({s['seconds']:.3f} s, "
              f"stage A + B)", flush=True)
    print(f"[main lm] {lm_s:.1f} s, of which {hist.wall_time:.1f} s after "
          f"the init; launches {lm_launches}; "
          f"peak device memory {peak_gb:.2f} GB "
          f"(torch.cuda.max_memory_allocated)", flush=True)
    require(all(v > 0 for v in lm_launches.values()),
            f"a kernel of the LM path was never launched: {lm_launches}")
    require(rnnt_lattice_op.launches == 0,
            "the LM path launched the RNN-T lattice kernel")
    require(len(hist.selections) == 2 and len(hist.train_loss) == 3,
            "the LM path did not run its selection rounds and epochs")
    require(all(np.isfinite(hist.train_loss))
            and all(np.isfinite(hist.val_loss)), "non-finite LM loss")
    require(all(len(s["indices"]) == n_lm // 2 for s in hist.selections),
            "LM selection budget")

    mark("main path, LM")

    # -- 9. where an LM training step's time goes ------------------------
    profile_step(torch, lm, tc_lm, lm_units, dev, hist.final_params, "lm")
    stage_a_rounds(torch, lm, hist.final_params, lm_units, lm_val, tc_lm.pgm,
                   dev, "lm")

    mark("profile, LM")

    # -- 10. serving, LM: the same params at full depth ------------------
    lm_params = hist.final_params
    del hist
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[serve lm] starcoder2-3b at full width and depth "
          f"({lm_cfg.n_layers} layers, window {lm_cfg.window}, {lm_cfg.compute_dtype} compute "
          f"over the trained fp32 params; ring KV caches of "
          f"{lm_cfg.window} slots)", flush=True)
    swa_launches = serve_lm(torch, lm, lm_params, dev, swa_attn_op,
                            (rnnt_lattice_op, omp_gram_batched_op,
                             grad_sketch_units_op, rwkv6_wkv_op))
    del lm_params

    mark("serving, LM")

    # -- 11. main path, RWKV: rwkv6-3b at full width and depth -----------
    gc.collect()
    torch.cuda.empty_cache()
    rw = build_model(rw_cfg)
    n_rw = LM_N // UNIT_SIZE
    print(f"[main rwkv] rwkv6-3b (n_params {rw_cfg.n_params():,} by the "
          f"reference's formula, {rw_cfg.n_layers} layers, d_model "
          f"{rw_cfg.d_model}, {rw_cfg.n_heads} WKV heads of "
          f"{rw_cfg.rwkv_head_dim}, d_ff {rw_cfg.d_ff}, vocab "
          f"{rw_cfg.vocab_size}, {rw_cfg.compute_dtype} compute, fp32 master "
          f"weights) on {n_rw} units of {UNIT_SIZE} x {LM_SEQ} tokens, "
          f"{rw_val['tokens'].shape[0] * UNIT_SIZE} validation examples, "
          f"{tc_lm.epochs} epochs, warm start 1, {P_main} partitions, "
          f"subset 0.5, lr {tc_lm.lr}", flush=True)
    omp_gram_batched_op.launches = 0
    grad_sketch_units_op.launches = 0
    rnnt_lattice_op.launches = 0
    rwkv6_wkv_op.launches = 0
    rwkv6_wkv_op.bwd_launches = 0
    swa_attn_op.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    hist = train_with_selection(
        rw, rw_units, tc_lm, method="pgm", val_units=rw_val, device="cuda",
        log_fn=lambda s: print(f"[main rwkv +{time.time() - t0:.1f}s] {s}",
                               flush=True))
    torch.cuda.synchronize()
    rw_s = time.time() - t0
    rw_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rw_launches = {"rwkv6_wkv": rwkv6_wkv_op.launches,
                   "rwkv6_wkv_bwd": rwkv6_wkv_op.bwd_launches,
                   "grad_sketch": grad_sketch_units_op.launches,
                   "omp_gram": omp_gram_batched_op.launches}
    n_leaves = sum(t.numel() for t in tree_leaves(hist.final_params))
    for s in hist.selections:
        print(f"[main rwkv] selection at epoch {s['epoch']}: indices "
              f"{s['indices']} weights "
              f"{[round(w, 4) for w in s['weights']]} ({s['seconds']:.3f} s, "
              f"stage A + B)", flush=True)
    print(f"[main rwkv] {rw_s:.1f} s, of which {hist.wall_time:.1f} s after "
          f"the init; {n_leaves:,} params counted from the leaves; launches "
          f"{rw_launches}; peak device memory {rw_peak_gb:.2f} GB "
          f"(torch.cuda.max_memory_allocated)", flush=True)
    require(all(v > 0 for v in rw_launches.values()),
            f"a kernel of the RWKV path was never launched: {rw_launches}")
    require(rnnt_lattice_op.launches == 0,
            "the RWKV path launched the RNN-T lattice kernel")
    require(len(hist.selections) == 2 and len(hist.train_loss) == 3,
            "the RWKV path did not run its selection rounds and epochs")
    require(all(np.isfinite(hist.train_loss))
            and all(np.isfinite(hist.val_loss)), "non-finite RWKV loss")
    require(all(len(s["indices"]) == n_rw // 2 for s in hist.selections),
            "RWKV selection budget")

    mark("main path, RWKV")

    # -- 12. where an RWKV training step's time goes ---------------------
    profile_step(torch, rw, tc_lm, rw_units, dev, hist.final_params, "rwkv")
    stage_a_rounds(torch, rw, hist.final_params, rw_units, rw_val, tc_lm.pgm,
                   dev, "rwkv")
    del hist

    mark("profile, RWKV")
    g_err, g_ms, g_plain, g_lib, g_bound, g_by = \
        gram_rows[(P_main, n_units // P_main, D_sk)]
    print(f"[launches] RNN-T path {launches}, LM path {lm_launches}, RWKV "
          f"path {rw_launches}, serving path {{'swa_attn': {swa_launches}}}",
          flush=True)
    # one row per kernel and main path, "launches" from that path's run;
    # the Gram's stage-B shape (4, 4, 4096) is the same on both paths
    gram = {"name": "omp_gram_batched", "route": "cuda",
            "source": "src/repro_torch/kernels/omp_gram/csrc/omp_gram.cu",
            "replaces": "src/repro/kernels/omp_gram/kernel.py:54",
            "max_abs_err": g_err, "ms": g_ms, "plain_ms": g_plain,
            "bound_ms": g_bound, "bound_by": g_by, "library_ms": g_lib}
    kernels = [
        {"name": "rnnt_lattice", "path": "rnnt", "route": "cuda",
         "source": "src/repro_torch/kernels/rnnt_lattice/csrc/rnnt_lattice.cu",
         "replaces": "src/repro/kernels/rnnt_lattice/kernel.py:71",
         "launches": launches["rnnt_lattice"], "max_abs_err": lat_err,
         "ms": lat_ms, "plain_ms": lat_plain, "bound_ms": lat_bound,
         "bound_by": lat_by, "library_ms": None},
        dict(gram, path="rnnt", launches=launches["omp_gram"]),
        dict(gram, path="lm", launches=lm_launches["omp_gram"]),
        {"name": "grad_sketch_units", "path": "lm", "route": "cuda",
         "source": "src/repro_torch/kernels/grad_sketch/csrc/grad_sketch.cu",
         "replaces": "src/repro/kernels/grad_sketch/kernel.py:128",
         "launches": lm_launches["grad_sketch"], "max_abs_err": sk_err,
         "ms": sk_ms, "plain_ms": sk_plain, "bound_ms": sk_bound,
         "bound_by": sk_by, "library_ms": None},
        dict(gram, path="rwkv", launches=rw_launches["omp_gram"]),
        {"name": "grad_sketch_units", "path": "rwkv", "route": "cuda",
         "source": "src/repro_torch/kernels/grad_sketch/csrc/grad_sketch.cu",
         "replaces": "src/repro/kernels/grad_sketch/kernel.py:128",
         "launches": rw_launches["grad_sketch"], "max_abs_err": skr_err,
         "ms": skr_ms, "plain_ms": skr_plain, "bound_ms": skr_bound,
         "bound_by": skr_by, "library_ms": None},
        {"name": "rwkv6_wkv", "path": "rwkv", "route": "cuda",
         "source": "src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_wkv.cu",
         "replaces": "src/repro/kernels/rwkv6_scan/kernel.py:88",
         "launches": rw_launches["rwkv6_wkv"], "max_abs_err": wkv_abs,
         "ms": wkv_ms, "plain_ms": wkv_plain_ms, "bound_ms": wkv_bound,
         "bound_by": wkv_by, "library_ms": None},
        {"name": "rwkv6_wkv_bwd", "path": "rwkv", "route": "cuda",
         "source": "src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_wkv.cu",
         "replaces": "jax.grad of src/repro/models/rwkv6.py:wkv_chunked",
         "launches": rw_launches["rwkv6_wkv_bwd"], "max_abs_err": wkvb_abs,
         "ms": wkvb_ms, "plain_ms": wkvb_plain_ms, "bound_ms": wkvb_bound,
         "bound_by": wkvb_by, "library_ms": None},
        {"name": "swa_attn", "path": "serve", "route": "cuda",
         "source": "src/repro_torch/kernels/swa_attn/csrc/swa_attn.cu",
         "replaces": "src/repro/kernels/swa_attn/kernel.py:79",
         "launches": swa_launches, "max_abs_err": swa_abs, "ms": swa_ms,
         "plain_ms": swa_plain, "bound_ms": swa_bound, "bound_by": swa_by,
         "library_ms": swa_lib},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
