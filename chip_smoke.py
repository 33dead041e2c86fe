#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

run from the root of a checkout, on a machine with one NVIDIA H100.
``python3 chip_smoke.py --phase N`` (N in 15 to 22) runs phases 1
and 2, then phase N's kernel rows and phase N alone (phase 15 after the
RNN-T run on the scan engine it is held against, phase 21 after the
resident RNN-T run without a group that 21a is held to, phase 22 after
phases 20 and 21, whose steps it reads), and prints the
card's name and power limit and the phase's launch counts; it is for trying a
phase, and the contract below holds for the whole run only.  It
imports no JAX and nothing of the JAX package, and runs in phases; any
failure exits non-zero, and no phase catches an error and carries on:

1. environment: the card's name and power limit; TF32 off everywhere
   (``cudnn.allow_tf32`` defaults to True, which would put the CRDNN
   convolutions in TF32) and cuDNN on its deterministic algorithms;
2. build: the six CUDA sources of the checkout (the band's backward
   its own), one ``nvcc`` per source, all started together;
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
   tensor-core route it takes), at both LM units' shapes and at the LM
   resident path's chunk of 4 units; the RWKV6 WKV kernels (forward and
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
   tensor cores' (p . v runs twice, p split into bf16 hi + lo); the
   band's backward kernel (phase 20) at the same edge shapes and at the
   training shapes of phase 20, 18c and gemma3-27b, the forward that
   writes lse bitwise the serving forward, two backward launches bitwise
   equal, against the plain backward and autograd of the plain forward,
   timed in turns with SDPA's backward under the band mask; then the
   shapes phase 16 gives them: the band at gemma3-27b's prefill (B 2 x S
   8,192 x 16 KV heads x G 2, window 1024) and the grad sketch at the
   stage-A units of gemma-7b, minitron-8b and gemma3-27b (V 256,000 and
   262,144, d 3,072 to 5,376); and the shapes phase 17 gives them (see
   17);
4. agreement: one full-width ``rnnt-crdnn`` unit, and one unit each of
   ``starcoder2-3b`` and ``rwkv6-3b`` at full width with 1 layer in
   fp32 (the CPU side of a deeper unit costs the script's time budget), through the kernels on the card against the same unit through
   the plain versions on the CPU (per-example loss, the stage-A gradient
   or sketch, and for RWKV one layer's time-mix gradients), the RNN-T
   unit's fused backward twice on the card with the same dw_out bits,
   the RNN-T unit's whole training gradient twice, every leaf bit for
   bit; and the 1-layer ``starcoder2-3b`` served on a 6,144-token prompt (the band
   branch), prefill and 8 teacher-forced greedy decode steps, card
   against CPU;
5. main path, RNN-T: ``train_with_selection(method="pgm")`` at the full
   width of ``rnnt-crdnn`` on a synthetic corpus -- warm start, then a PGM
   round (stage A + stage B) before each subset epoch, each round's time
   printed (no same-seed repeat here: those of 15a, 18c, 19a and 20b
   and phase 4's two gradients hold F3); then a stage-A round on the
   trained params, timed (after the LM and RWKV profiles two rounds,
   with whether their unit vectors agree bit for bit and whether they
   pick the same subsets);
6. the reference's own loop (``examples/train_asr_pgm.py`` and the
   reference's host engine), beside phase 5's first run: (a) the same
   config at ``REPEAT_EPOCHS`` epochs with a checkpoint directory,
   preempted after epoch 0 (a manifest with ``extra.preempted``), then
   resumed: the remaining epoch's losses and round's subsets and weights
   bitwise those of phase 5's first run, its launches counted; then the
   newest checkpoint corrupted, and ``restore_latest_intact`` falls back
   to the one before; (b) a guarded AdamW epoch with a NaN weight at step 5:
   one step skipped, params and optimizer state bitwise unchanged across
   it; (c) the dense loss (``loss_impl="dense"``, no kernel) against the
   fused one on one full-width unit, per-example loss within 1e-4 and
   every gradient within 1e-3 of its largest entry; (d) an
   exact-gradient PGM round on the trained params, and the Gram at its
   (4, 4, 1,024,000) twice bitwise, against its plain version, timed in
   turns with ``torch.bmm``; (e) ``greedy_decode`` and
   ``token_error_rate`` on the 16 validation utterances, card against
   CPU (the trained params, then phase 8's random weights, which emit),
   with the smallest top-2 margin (the twin ``python -m
   repro_torch.examples.train_asr_pgm`` runs in 14d, on the scan
   engine);
7. profile, RNN-T: one training step under ``torch.profiler`` (host wall
   time, device busy time, the kernels that take the most of it), its
   counted lattice launches equal to its traced lattice kernels;
8. serving, RNN-T: ``rnnt-crdnn`` at full width (random weights; the
   3-epoch model emits only blanks) in the slot engine (streaming greedy
   transducer search) on 8 utterances, token for token against
   ``rnnt_greedy_reference`` on the card;
9. main path, LM: the same loop on ``starcoder2-3b`` at full width and
   depth (30 layers, d_model 3072, vocab 49152, bf16 compute, fp32 master
   weights) on a synthetic corpus of 512-token examples, with the peak of
   device memory;
10. profile, LM: one training step of that model, as in 7;
11. serving, LM: the same params (the training path's optimizer state
   freed) served at full depth: ``generate`` on 2 prompts of 8,192
   tokens, then ``SlotEngine`` with 4 slots on the launcher's 8
   requests of 4,136-7,581 tokens (5 through the band kernel, 3 through
   the kv-block flash branch), 32 new tokens each; every completion's
   first token against ``generate`` on its prompt alone; one decode scan
   and one prefill of the 2 x 8,192 prompts under the profiler;
12. main path, RWKV: the same loop on ``rwkv6-3b`` at full width and
   depth (32 layers, d_model 2560, 40 WKV heads of 64, vocab 65536, bf16
   compute, fp32 master weights), with the peak of device memory;
13. profile, RWKV: one training step of that model, as in 7;
14. the scanned epoch engine (``engine="scan"``: one captured CUDA graph
   of the training step, replayed once a plan row; phases 5, 6, 9 and 12
   run ``engine="host"``): (a) phase 5's RNN-T main path through it
   (15a repeats it with one seed), with phase
   5's subsets and weights and
   losses within rtol 1e-3 (whether bitwise equal printed), one capture
   a run; then on a fresh engine (phase 7's eager step under the profiler
   having shown its counted launches equal to its traced lattice
   kernels) a full epoch whose counters see per-step launches x (warm-up
   steps + the capture), three rows replayed against the same rows
   without the graph (bitwise), two padding rows through the graph
   (state bitwise held), and ``TRACE_ROWS`` (3) rows of an epoch
   replayed under the profiler (a whole epoch's trace took ~85 s of host
   time beside an H100 80GB HBM3 at 700 W): the step graph's lattice
   kernel nodes (read through the driver, ``graph_kernels``) x rows equal
   to per-step launches x rows, the trace holding the kernel, the
   counters unchanged (a replay makes no host call), its wall and busy
   time a step beside phase 7's eager step;
   (b) the same loop's first ``REPEAT_EPOCHS`` epochs with
   ``epoch_chunk=2`` against (a)'s; (c)
   ``starcoder2-3b`` and ``rwkv6-3b`` at full width with 2 layers, 2
   epochs, host engine against scan engine (same subsets, losses within
   1e-3), then the checks of (a) on a fresh engine with an eager step
   of its own traced (the WKV forward and backward kernels traced per
   step x rows); (d) ``python -m
   repro_torch.examples.train_asr_pgm --engine scan --epoch-chunk 2``,
   its selection and TER lines;
15. resident selection (``resident_selection=True``: stage A of a round
   one captured CUDA graph a unit corpus, of one chunk at a cursor over
   the resident units, replayed a chunk at a time every round): (a)
   phase 14a's run with it, twice with one seed, bitwise equal, with
   14a's subsets and weights (1e-4) and losses (rtol 1e-3), 2 captures
   a run and none after the first round, each round's time and stage A
   alone printed; (b) on its trained params a fresh selector against
   host ``units_gradients`` (1e-5 of the largest entry, the same
   selection), two replays bitwise, stage A and a round timed, the
   replayed stage A of the validation corpus under the profiler (a whole
   round's trace took ~55 s of host time beside an H100 80GB HBM3 at 700
   W): the graph's lattice kernel nodes x replays 2 a unit, the trace
   holding the kernel, the counters unchanged; (c) ``starcoder2-3b`` at
   full width and 6 of its 30 layers (``LM_RESIDENT_LAYERS``) on
   the scan engine with resident selection, 2 epochs, its peak device
   memory, then (b)'s checks, and ``chunk_units=4`` against 1 (1e-5 of
   each unit vector's largest entry; the kernel counted once a chunk);
   (d) ``rwkv6-3b`` at full width with 2 layers, (b)'s checks on a
   replayed round, its graphs' WKV forward nodes x replays a unit x
   layer; (e) an injected failure of the
   ``"cuda"`` route raises out of the round, no round degraded;
16. the reference's other dense archs and examples: (a) ``gemma3-27b`` at
   full width and 31 of its 62 layers (``GEMMA3_SERVE_LAYERS``; 14.2B
   of its 27.0B params) served from bf16 weights drawn on
   the card layer by layer (no fp32 masters, which would not fit at full
   depth): ``generate`` on 2 x 8,192 prompts and ``SlotEngine``
   (4 slots) on the launcher's 8 requests, 32 new tokens each, the band
   kernel once a local layer a prefill, the peak device memory; (b) at
   full width with 6 layers, the bundle's prefill of 3,072 tokens and 16
   greedy decode steps from fp32 masters and from their
   ``serving_params``, every logit bitwise equal; (c) ``gemma3-27b``,
   ``gemma-7b`` and ``minitron-8b`` at full width and 2 layers each
   (their fp32 masters at full depth would not fit one card for
   training) trained 2 epochs on the scan engine with resident
   selection, each run's peak memory, then resident against host stage
   A on the trained params (P7); (d) the twins of the reference's
   quickstart and ``train_lm_pgm`` (``--n 32 --epochs 4``) on the card,
   ``--selection-kernels`` auto against xla: auto launches the grad
   sketch and the Gram, xla neither, losses within 1e-3;
17. the MoE family (ROADMAP hazards M1-M6): (a) ``olmoe-1b-7b`` at full
   width and depth (16 layers, 64 experts top-8, 6.92B params) served
   from bf16 weights drawn on the card layer by layer: ``generate`` on
   2 x 2,048 prompts and ``SlotEngine`` (4 slots) on the launcher's 8
   requests at ``--prompt-len 2048`` (power-of-two buckets, each slot
   prefill one MoE group), the peak device memory; at full width and one
   layer, fp32 masters against their ``serving_params``, prefill and 16
   greedy decode steps, every logit bitwise equal; (b) ``mixtral-8x7b``
   at full width and 21 of its 32 layers (the peak held to 72 GB):
   ``generate`` on 2 x 8,192 (the band kernel once a local layer) and
   ``SlotEngine`` at ``--prompt-len 2048`` (exact lengths); (c)
   ``olmoe-1b-7b`` and ``mixtral-8x7b`` at 2 layers, full width,
   trained 2 epochs on the scan engine with resident rounds and
   ``moe_router_term``, then resident stage A against host
   (P7) and at ``chunk_units`` 1 each unit's head block bitwise the
   head-only vector, each run's round time and peak; (e) one ``olmoe``
   prefill and one eager step of each arch under the profiler, the
   device time split into the dispatch/combine einsums, the expert
   GEMMs, attention and the rest.  Phase 3 holds (d), the kernels at
   phase 17's shapes: the grad sketch at both archs' stage-A units, the
   Gram at their router-term D (12,288 and 5,120, M6) and the band at
   ``mixtral-8x7b``'s prefill (2, 8192, 8, 4, 128, 4096) against SDPA;
18. recurrent-state serving and the hybrid family (ROADMAP S10, RG1-RG5):
   (a) ``recurrentgemma-9b`` (26 RG-LRU and 12 local layers, 9.40B
   params) and (b) ``rwkv6-3b`` at full width and depth served from bf16
   weights drawn on the card: ``generate`` on 2 x 8,192 (the band at
   head dim 256 once a local layer; the WKV forward once a time-mix
   layer) and ``SlotEngine`` (2 slots) on 4 requests whose lengths are
   not powers of two (``recurrentgemma-9b`` at exact lengths,
   ``rwkv6-3b`` in power-of-two buckets, its pads through the WKV
   kernel), each completion token for token against ``generate`` on its
   prompt alone, unpadded; the peak memory; (c) ``recurrentgemma-9b`` at
   full width and 3 layers (one group) trained 2 epochs at S 4,096, the
   reference's training length, past the band's start at 3,072 (the
   band's backward at head dim 256, group remat; units of 1) on
   the scan engine with resident rounds, twice with one seed (losses,
   the round and every final leaf's bits equal), resident stage A
   against host (P7); (e) one ``recurrentgemma-9b`` prefill
   and one eager step under the profiler, the RG-LRU scan's device share
   from its ``rglru.scan`` / ``rglru.scan_bwd`` ranges.  Phase 3 holds
   (d): the band at head dim 256 (edge shapes, then (2, 8192, 1, 16, 256,
   2048) in fp32 and bf16, the bf16 timed against SDPA), the WKV forward
   at ``rwkv6-3b``'s prefill with pad rows (the padded row's state
   bitwise its live prefix's), the grad sketch at ``recurrentgemma-9b``'s
   stage-A unit (V 256,000) and its stage-B Gram;
19. the encoder-decoder and VLM families (ROADMAP ED1-ED4, V1-V2, S11):
   (a) ``seamless-m4t-medium`` (12 encoder + 12 decoder layers, 615M
   params) and (b) ``paligemma-3b`` (18 layers behind 256 patches, 2.51B
   params) at full width and depth trained 2 epochs under PGM on the
   scan engine with resident rounds, on 16 units of 4 stacked from the
   bundle's ``make_batch`` (seamless at S 1,024: 512 frames and 512
   tokens; paligemma at S 768: 256 patches and 512 tokens; n = 2,044 a
   stage-A unit), seamless twice with one seed (losses, the round and
   every final leaf's bits equal), each run's peak memory, then resident
   stage A against host (P7); (c) each trained model served through
   ``generate`` from its serving weights (bf16, greedy, 32 new tokens):
   4 requests of 1,024 frames and 16 prompt tokens, 4 of 256 patches and
   512 tokens; (d) S11 at full width and depth in fp32: a paligemma-3b
   decode step after a prefill, its cache sized ``n_prefix + Sp + new``,
   within 1e-3 of a full forward's largest entry, and sized ``Sp + new``
   (the reference's) not; (e) each at full width with one layer (one
   encoder and one decoder layer) in fp32 on one example of 256 frames
   or patches and 256 tokens, card against CPU: per-example loss, the
   stage-A sketch, the prefill and 8 teacher-forced decode steps, at
   phase 4's bars.  Phase 3 holds the grad sketch at both archs'
   stage-A units (V 256,206 and 257,216, off the 128-wide vocab tile);
20. long-context training through the band (ROADMAP item 7, hazards
   B1-B5): (a) ``starcoder2-3b`` at full width and depth (30 layers,
   3.03B params) trained under PGM at S 8,192, past the band's start at
   5,120, with group remat, on the scan engine with resident rounds: 8
   units and 2 validation units of 2 x 8,192 tokens, the warm start and
   one round, subset 0.5; its peak memory, the step graph's band
   forward and backward nodes (two forwards a local layer, the
   recompute, and one backward) x its replays, exact, and one replayed
   step under the profiler (wall time, busy share); (b) the same at 2
   layers (``LONG_REPEAT_LAYERS``) twice with one seed, bitwise, and
   resident stage A against host (P7); (c) one step at 6 layers with
   remat on and off: loss and every gradient leaf bitwise equal, the
   remat peak lower; (d) one layer at fp32 (TF32 off) on one example of
   6,144 tokens, card against CPU, per-example loss and every gradient
   leaf at phase 4's bars.  Phase 3 holds the band's backward and the
   grad sketch at phase 20's stage-A unit (n = 2 x 8,191);
21. distribution on ``torch.distributed`` (ROADMAP hazards D1-D8) at
   world size 1, the card's one rank in an NCCL group on a (1, 1) ``data
   x pod`` mesh: (a) phase 15a's RNN-T path (scan engine, resident
   rounds, stage B sharded over ``data``) twice at ``REPEAT_EPOCHS``
   epochs, bitwise each other and 15a's run without a group over those
   epochs, the collectives issued inside the step's
   capture counted (NCCL enqueues no kernel in a group of one), its
   captures and replays counted; (b) ``starcoder2-3b`` at full width
   and 2 layers, S 512, through the pod step in ``none``, ``bf16`` and
   ``topk`` beside the plain step, each replayed step timed, its peak
   (top-k's fp32 residuals), one top-k step traced for the collectives'
   share; on the full-width leaves (the 49,152 x 3,072 embedding
   included) top-k sends exactly the k largest of a real gradient plus
   the run's residuals, ``sent + new_err == g + err`` bitwise; a
   resident round on the mesh (grad sketch, Gram); (c) two ranks sharing
   the card over gloo (spawned at the phase's start, waiting), the host
   engine, eager: a resident round on the seed's params and the first 2
   steps from them against one device's;
22. the contracts' card side and the roofline (ROADMAP item 11): graphs
   built through the driver with a host node and a device-to-host memcpy
   node refused by ``assert_graph_device_only``, ``no_host_sync`` raising
   on ``.item()`` and on a stream's ``synchronize()``; the dry run
   (``repro_torch/launch/dryrun.py``, fake CUDA tensors) of 20a's step and
   21b's plain step: each step's MFU (model FLOPs, 6 N D, over its wall
   time over 989 TFLOP/s), its useful ratio (model FLOPs over the op
   count), its roofline bound, and the dry run's memory floor against
   the measured peak (20a's must not exceed it).

The contracts (``repro_torch/analysis/contracts.py``) hold on the runs
above: phase 11's slot pool is updated in place across its admits and
decodes; in phase 14 no capture follows the first (the second epoch,
the 3- and 2-row plans, the traced rows), the params and optimizer
buffers stay in place, the replay loops run under ``no_host_sync`` and
the step graph is device-only; in phase 15 every stage A after a
corpus's capture captures nothing, reads nothing back and keeps the
selector's buffers in place, and every stage-A graph is device-only; in
phase 21 the captured step's collectives run at fp32 (``none``), the pod
mean at bf16 once a step in ``bf16``, every collective over the pod
axis's group.  Phase 2 holds the driver's graph node types against the
toolkit's ``cuda.h``.

Phases 9, 12 and 15c draw their 3B models' initial weights with a
generator on the card (the host generator took ~20 s a model).

Each main path runs with its kernels' launch counters set to 0 just
before and read just after, and fails if a kernel of the path was never
launched.  The script ends with a JSON line of per-kernel numbers (one
row per kernel and main path: the Gram, which all three training paths
run, has three and a fourth for phase 6's exact stage B, and the grad
sketch, which both LM paths run, two; then one row per kernel and scan
path of phase 14, ``rnnt-scan``, ``lm-scan`` and ``rwkv-scan``: a kernel
of the captured step with the launches of ``TRACE_ROWS`` replayed rows
(its graph's kernel nodes x the replays) and,
as ``counted``, its scan run's count (the warm-up steps and the
capture), a kernel outside the step with its scan run's count; then
one row per kernel and resident path of phase 15, ``rnnt-resident``,
``lm-resident``, ``rwkv-resident`` and ``lm-resident-chunk4``: a kernel
inside the stage-A graphs with the instances one replayed round ran
(for ``rnnt-resident``, one replayed stage A of the validation corpus;
the graphs' kernel nodes x their replays) and, as ``counted``, the selector's warm-up and capture launches,
stage B's Gram with its count; then phase 16's rows: the band kernel at
gemma3-27b's prefill with its serving launches, and for each dense arch's
resident run the grad sketch at its stage-A unit and the Gram, with the
run's counts; then phase 17's: the band at mixtral-8x7b's prefill, and
for each MoE arch's resident run the grad sketch at its unit and the
Gram at its router-term D; then phase 18's: the band at
recurrentgemma-9b's prefill and the WKV forward with pad rows, each
with its serving launches, and the grad sketch and the Gram of
recurrentgemma-9b's resident run; then phase 19's: the grad sketch and
the Gram of the ``encdec-resident`` and ``vlm-resident`` runs; then
the band's backward ``swa_attn_bwd`` and its forward that writes lse on
the training paths through the band, ``recurrentgemma-9b-resident``
(18c), ``starcoder2-3b-long`` (20a: a step-graph kernel's launches
counted at the warm-ups and the capture plus its graph's nodes x
replays) and ``starcoder2-3b-long-2`` (20b), with the grad sketch and
the Gram of 20a; then phase 21's: the lattice and the Gram of
``rnnt-mesh`` (21a; the lattice of the step graph as counted plus its
nodes x replays), the grad sketch and the Gram of ``lm-mesh`` (21b's
round) and the lattice and the Gram of ``rnnt-mesh-gloo`` (21c, both
ranks' launches), the card's name and power limit
as ``nvidia-smi`` prints them, and the line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
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
# the LM resident path's chunk of 4 units (chunk_units 4, phase 15c)
SKETCH_CHUNK = (4,) + SKETCH_MAIN[1:]
# the dense archs' stage-A units (phase 16c, 512-token examples): d and V
# of gemma-7b and gemma3-27b (tied heads) and minitron-8b (its untied
# head as the selector's (V, d) buffer)
SKETCH_DENSE = {"gemma-7b": (1, UNIT_SIZE * (LM_SEQ - 1), 3072, 256000, 64,
                             64),
                "minitron-8b": (1, UNIT_SIZE * (LM_SEQ - 1), 4096, 256000,
                                64, 64),
                "gemma3-27b": (1, UNIT_SIZE * (LM_SEQ - 1), 5376, 262144,
                               64, 64)}
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
# phase 15c: starcoder2-3b at full width and these layers on the scan
# engine with resident rounds (its 30 took 37.4 s of the script's time;
# phase 19 trains two archs at full depth through the same route)
LM_RESIDENT_LAYERS = 6
# phase 4's full-width LM and RWKV units (and the LM's serve agreement),
# card against CPU: one layer, whose CPU side is the phase's cost
AGREE_LAYERS = 1
# serving: the agreement prompt, and the full-depth run's prompts
SERVE_AGREE_S = 6144
SERVE_AGREE_STEPS = 8
SERVE_PROMPT = 8192
SERVE_NEW = 32
SERVE_SLOTS = 4
SERVE_REQUESTS = 8
# gemma3-27b served at full width (phase 16a): generate's 2 x 8,192
# prefill takes the band in each local layer, at this shape
SWA_GEMMA3 = (2, SERVE_PROMPT, 16, 2, 128, 1024, "bfloat16", None)
# phase 16a: gemma3-27b served at full width and this many of its 62
# layers (28.42 GB of bf16; its full depth, 54.02 GB, took ~20 s more of
# the script's time budget)
GEMMA3_SERVE_LAYERS = 31
# phase 16b: gemma3-27b at full width with one group of layers (5 local, 1
# global), fp32 masters against serving weights on a prompt past the band
GEMMA3_AGREE_LAYERS = 6
GEMMA3_AGREE_S = 3072
GEMMA3_AGREE_STEPS = 16
# phase 16c: the dense archs trained at full width, at these depths
DENSE_TRAIN = (("gemma3-27b", 2), ("gemma-7b", 2), ("minitron-8b", 2))
# phase 17, the MoE archs: slot prompts of at most 2,048 tokens, one MoE
# group (ROADMAP M1: the reference asserts that the tokens split into
# groups of 2,048); mixtral-8x7b served at this depth of its 32 layers
# (bf16 weights of 2.90 GB a layer; on an H100 80GB 22 layers peaked at
# 71.43 GB on their own and at 73.33 GB after phases 1-16), the peak
# held to MOE_PEAK_GB
MOE_SLOT_PROMPT = 2048
MIXTRAL_SERVE_LAYERS = 21
MOE_PEAK_GB = 72.0
MOE_AGREE_STEPS = 16
# phase 17c: trained at full width, at these depths (olmoe-1b-7b at 8
# layers ran out of an H100 80GB's memory in its first resident round,
# its step and stage-A graphs' pools holding 53.4 GB; at 6 its two runs
# took 42.6 s of the script's time, cut to 2 to pay for phase 19)
MOE_TRAIN = (("olmoe-1b-7b", 2, 1), ("mixtral-8x7b", 2, 1))
# their stage-A units (untied heads: the selector's (V, d) buffer) and
# stage-B Grams with the router term (M6: D = 64 x 64 + layers x 64 x E)
SKETCH_MOE = {"olmoe-1b-7b": (1, UNIT_SIZE * (LM_SEQ - 1), 2048, 50304, 64,
                              64),
              "mixtral-8x7b": (1, UNIT_SIZE * (LM_SEQ - 1), 4096, 32000, 64,
                               64)}
GRAM_MOE = {"olmoe-1b-7b": (4, 4, 64 * 64 + 2 * 64 * 64),
            "mixtral-8x7b": (4, 4, 64 * 64 + 2 * 64 * 8)}
# mixtral-8x7b's 2 x 8,192 prefill takes the band in every local layer
SWA_MIXTRAL = (2, SERVE_PROMPT, 8, 4, 128, 4096, "bfloat16", None)
# RNN-T serving: the launcher's utterances of 256-512 frames
RNNT_SERVE_FRAMES = 512
RNNT_MAX_SYMBOLS = 8
# phase 18, the recurrent families.  recurrentgemma-9b's 2 x 8,192 prefill
# takes the band at head dim 256 (MQA: 1 KV head, G 16) in its 12 local
# layers; the head-dim-256 tiles' edges (S off the 128-row q tile, windows
# off the 64-key tile, per-row lengths), bf16 and fp32
SWA_RG = (2, SERVE_PROMPT, 1, 16, 256, 2048, "bfloat16", None)
SWA_RG_EDGES = ((1, 129, 1, 2, 256, 63, "bfloat16", None),
                (2, 1100, 1, 16, 256, 200, "bfloat16", (1100, 70)),
                (1, 700, 2, 2, 256, 1, "bfloat16", None),
                (2, 300, 1, 4, 256, 64, "float32", (300, 1)),
                (1, 1100, 1, 16, 256, 5000, "float32", None))
# rwkv6-3b's 2 x 8,192 prefill through the WKV kernel with pad rows (k 0
# and a log-decay of 0 from the second row's length on, S10)
WKV_PAD = (2, SERVE_PROMPT, 40, 64, 64, (SERVE_PROMPT, 5000))
# the slot engines' requests, of lengths that are not powers of two:
# recurrentgemma-9b prefills exact lengths (local layers; 3 of 4 past the
# band's start at 3,072), rwkv6-3b right-pads to power-of-two buckets.
# An unpadded rwkv6-3b prefill whose length is not a multiple of 64 takes
# the sequential WKV scan, the padded one the chunked kernel; in bf16 the
# two roundings can flip a greedy token (3 of 4 requests of 1,179-1,842
# tokens in one run on an H100).  So 1,559, one of those (its last chunk
# 23 live and 41 pad rows), is held token for token against the same
# padded prefill and greedy decode outside the engine, and every
# request's padded prefill against its unpadded one by logits and
# recurrent cache within a bar of each one's largest entry that the
# reference's padded prefill (pads through the recurrence, S10) must
# miss: in bf16 0.25 (on an H100 80GB HBM3 at 700 W the two roundings put
# 1,559 at 5.9e-2-7.6e-2 and the S10 fault at 1.26-2.96), and, for a
# length that ends inside a chunk, at fp32 (TF32 off) at full depth too,
# 1e-3, where only the summation order differs
RG_SLOT_LENS = (2500, 3300, 4100, 5000)
RWKV_SLOT_LENS = (1088, 1559, 2496, 3008)
RWKV_PAD_BARS = {"bfloat16": 0.25, "float32": 1e-3}
HYBRID_SLOTS = 2
HYBRID_NEW = 8
# phase 18c: recurrentgemma-9b trained at full width and one group of its
# layers (rec, rec, local; its fp32 masters at full depth, 37.6 GB, would
# not fit with their gradients and activations; two groups took 58.5 s
# of the script's time, cut to one to pay for phase 19), at S 4,096, the
# reference's TRAIN_4K, past the band's start at 3,072 (the band's
# backward at head dim 256, one remat group), on 8 examples in units of 1
# and 4 validation units (units of 2 ran out of memory at S 4,096 in the
# first run's validation, 68.2 GB allocated, 47.8 GB of it graph pools,
# on an H100 80GB HBM3 at 700 W; S 2,048 and 32 examples in units of 2
# before the band's backward); its stage-A unit (tied head, V 256,000,
# n = 4,095) and stage-B Gram
RG_TRAIN_LAYERS = 3
RG_TRAIN_SEQ = 4096
RG_TRAIN_N = 8
RG_TRAIN_UNIT = 1
RG_VAL_UNITS = 4
SKETCH_RG = (1, RG_TRAIN_UNIT * (RG_TRAIN_SEQ - 1), 4096, 256000, 64, 64)
GRAM_RG = (4, 4, 64 * 64)
# phase 19, the encoder-decoder and VLM families at full width and depth,
# each (arch, make_batch's S, runs): seamless-m4t-medium at S 1,024 (512
# frames and 512 tokens), paligemma-3b at S 768 (256 patches and 512
# tokens), so a stage-A unit of 4 examples has n = 4 x 511 = 2,044; 16
# training and 4 validation units; seamless twice with one seed
FAMILY_TRAIN = (("seamless-m4t-medium", 1024, 2), ("paligemma-3b", 768, 1))
FAMILY_N_UNITS = 16
FAMILY_N_VAL = 4
SKETCH_FAMILY = {"seamless-m4t-medium": (1, UNIT_SIZE * 511, 1024, 256206,
                                         64, 64),
                 "paligemma-3b": (1, UNIT_SIZE * 511, 2048, 257216, 64,
                                  64)}
# serving (19c): frames or patches, and prompt tokens, a request; S11
# (19d): one prompt of this many tokens behind paligemma-3b's 256 patches;
# card against CPU (19e): make_batch's S (256 frames or patches and 256
# tokens), and the teacher-forced decode steps
FAMILY_SERVE = {"encdec": (1024, 16), "vlm": (256, 512)}
FAMILY_NEW = 32
S11_PROMPT = 512
FAMILY_AGREE_S = 512
FAMILY_AGREE_STEPS = 8
# phase 20, long-context training through the band.  The band's backward
# kernel at the edge shapes of both forward bodies and at the training
# shapes that take the band: starcoder2-3b at 2 x 8,192 (window 4,096),
# recurrentgemma-9b at 2 x 4,096 (head dim 256, window 2,048; 18c) and
# gemma3-27b at 1 x 4,096 (window 1,024; a kernel row only, its training
# past the band needs sharding for depth)
SWA_BWD_TRAIN = (("starcoder2-3b", (2, 8192, 2, 12, 128, 4096, "bfloat16",
                                    None)),
                 ("recurrentgemma-9b", (2, 4096, 1, 16, 256, 2048,
                                        "bfloat16", None)),
                 ("gemma3-27b", (1, 4096, 16, 2, 128, 1024, "bfloat16",
                                 None)))
# (a) starcoder2-3b at full width and depth trained at S 8,192 (past the
# band's start at 5,120) with group remat, on LONG_TRAIN_UNITS units and
# LONG_VAL_UNITS validation units of LONG_UNIT x 8,192 tokens, 2 epochs
# (the warm start and one round), subset 0.5; its stage-A unit has n = 2 x
# 8,191 tokens; (b) the same at LM_RESIDENT_LAYERS layers twice; (c) one
# step at that depth with remat on and off; (d) one layer at fp32 on one
# example of LONG_AGREE_S tokens, card against CPU
LONG_SEQ = 8192
LONG_UNIT = 2
LONG_TRAIN_UNITS = 8
LONG_VAL_UNITS = 2
LONG_AGREE_S = 6144
# (b)'s depth ((c) runs at LM_RESIDENT_LAYERS)
LONG_REPEAT_LAYERS = 2
SKETCH_LONG = (1, LONG_UNIT * (LONG_SEQ - 1), 3072, 49152, 64, 64)


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


def gram_row(torch, shape, dev):
    """The Gram kernel at one stage-B shape (P, n, D): twice bitwise,
    exactly symmetric, against its plain version, timed in turns with
    ``torch.bmm`` -> (err, kernel ms, plain ms, library ms, bound ms,
    what bounds it)."""
    from repro_torch.kernels.omp_gram.ops import omp_gram_batched_op
    from repro_torch.kernels.omp_gram.ref import omp_gram_batched_ref

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
    print(f"[kernels] omp_gram {shape}: max_abs_err {err:.3e} kernel_ms "
          f"{k_ms:.4f} plain_ms {p_ms:.4f} library_ms (torch.bmm) "
          f"{l_ms:.4f} (kernel / library {k_ms / l_ms:.3f}) bound_ms "
          f"{b_ms:.6f} ({b_by}) achieved {g_ops / k_ms / 1e9:.2f} "
          f"TFLOP/s (counting the upper triangle); two launches bitwise "
          f"equal, K exactly symmetric", flush=True)
    return err, k_ms, p_ms, l_ms, b_ms, b_by


def sketch_inputs(torch, U, n, d, V, k1, k2, seed, dev, on_card=False):
    """Logits of std 4 (the head scaled by 4/sqrt(d)), so the softmax is
    peaked and its p.R2 term carries a good part of the sketch; the head
    is passed as the (d, V) view of a contiguous (V, d) tensor, as the
    tied embedding gives it; unit 1 (when there is one) has scale 0.
    ``on_card``: drawn by a generator on the card (a head of 1.4B entries
    takes seconds to draw on the host)."""
    g = torch.Generator(device=dev if on_card else "cpu").manual_seed(seed)
    kw = dict(generator=g, device=g.device)
    h = torch.randn(U, n, d, **kw)
    wt = torch.randn(V, d, **kw) * (4 / math.sqrt(d))
    rh = torch.randn(d, k1, **kw)
    rv = torch.randn(V, k2, **kw)
    t = torch.randint(0, V, (U, n), dtype=torch.int32, **kw)
    s = torch.rand(U, n, **kw) + 0.5
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


def sketch_row(torch, op, ref, shape, seed, dev, tag, on_card=False):
    """The grad-sketch kernel at one main path's stage-A shape (one unit):
    its error (``sketch_err``), its and the plain version's distance from
    the same function in float64, kernel and plain version timed in
    turns, and two
    bounds: the fp32 FMA route (every product at the fp32 peak) and the
    3xTF32 route the kernel takes (h.W and p.R2 three times over at the
    TF32 tensor-core peak, h.R1 and hr^T er2 at the fp32 peak), each the
    larger of its operations time and the bytes time.  -> (err, kernel
    ms, plain ms, the lesser bound, what bounds it)."""
    ins = sketch_inputs(torch, *shape, seed=seed, dev=dev, on_card=on_card)
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
        runs.append(cuda_ms(torch, lambda: op(*ins), reps=6))
        runs.append(cuda_ms(torch, lambda: ref(*ins), reps=3))
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


# a same-seed repeat of a 3-epoch RNN-T run takes its first REPEAT_EPOCHS
# (the warm-start epoch and one round), held against that prefix of the
# first run: a run's first epochs do not depend on how many follow
REPEAT_EPOCHS = 2


def run_prefix(rec, epochs: int = REPEAT_EPOCHS):
    """A run record's first ``epochs`` epochs and the rounds before them."""
    tl, vl, sels = rec
    return tl[:epochs], vl[:epochs], [x for x in sels if x[0] < epochs]


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
                   tag, rounds: int = 2):
    """``rounds`` (2 or 1) selection rounds on the same params and
    projections: stage A (a unit vector for every training and
    validation unit), timed on the host clock after a synchronize, then
    stage B.  Prints each round's stage-A time and, with two, whether
    their unit vectors agree bit for bit and whether they pick the same
    subsets -> (bitwise equal, same subsets), (None, None) with one."""
    from repro_torch.core.lastlayer import make_proj_for, units_gradients
    from repro_torch.core.pgm import _stage_b, _val_target
    from repro_torch.train.engine import to_device

    us, vs = to_device(units, dev), to_device(val_units, dev)
    proj = make_proj_for(bundle, torch.Generator().manual_seed(0),
                         pgm_cfg.sketch_dim_h, pgm_cfg.sketch_dim_v, dev)
    n_rounds, rounds = rounds, []
    for _ in range(n_rounds):
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
    g1, gv1, i1, w1, s1 = rounds[0]
    require(bool(torch.isfinite(g1).all()), f"stage A {tag}: non-finite")
    if n_rounds == 1:
        print(f"[stage A {tag}] {g1.shape[0]} training + {gv1.shape[0]} "
              f"validation units a round: {s1:.3f} s (host clock)",
              flush=True)
        return None, None
    g2, gv2, i2, w2, s2 = rounds[1]
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


def swa_timed(torch, swa_attn_op, swa_attn_ref, shape, swa_abs, swa_margin,
              dev):
    """The band kernel at one prefill shape timed in turns with PyTorch's
    SDPA under the band mask (the library yardstick), its plain version
    once, its bound, and its rate on the function's and the tensor
    cores' FLOPs, printed with its error (``swa_err``'s) -> (kernel ms,
    plain ms, library ms, bound ms, what bounds it)."""
    B, S, KV, G, hd, W, dtype, _ = shape
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
    print(f"[kernels] swa_attn {shape[:7]}: max_abs_err {swa_abs:.3e} "
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
    return swa_ms, swa_plain, swa_lib, swa_bound, swa_by


def dense_kernel_rows(torch, dev):
    """Phase 3 at the shapes phase 16 gives the kernels: the band kernel
    at gemma3-27b's 2 x 8,192 prefill (``SWA_GEMMA3``: G = 2, window
    1024) and the grad sketch at each dense arch's stage-A unit
    (``SKETCH_DENSE``: V of 256,000 and 262,144), each held against its
    plain version and timed -> {"swa_attn": {err, ms, plain_ms,
    library_ms, bound_ms, bound_by}, "grad_sketch": {arch: {...}}}."""
    from repro_torch.kernels.grad_sketch.ops import grad_sketch_units_op
    from repro_torch.kernels.grad_sketch.ref import grad_sketch_units_ref
    from repro_torch.kernels.swa_attn.ops import swa_attn_op
    from repro_torch.kernels.swa_attn.ref import swa_attn_ref

    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")
    err, margin = swa_err(torch, swa_attn_op, swa_attn_ref, SWA_GEMMA3, dev)
    print(f"[kernels] swa_attn {SWA_GEMMA3}: max abs err {err:.3e}, "
          f"{margin:.3f} of the bar at most; two launches bitwise equal",
          flush=True)
    swa = swa_timed(torch, swa_attn_op, swa_attn_ref, SWA_GEMMA3, err,
                    margin, dev)
    out = {"swa_attn": dict(zip(keys, (err,) + swa)), "grad_sketch": {}}
    for i, (arch, shape) in enumerate(SKETCH_DENSE.items()):
        e, k_ms, p_ms, b_ms, b_by = sketch_row(
            torch, grad_sketch_units_op, grad_sketch_units_ref, shape,
            10 + i, dev, arch, on_card=True)
        out["grad_sketch"][arch] = dict(zip(keys, (e, k_ms, p_ms, None,
                                                   b_ms, b_by)))
        torch.cuda.empty_cache()
    return out


def band_pairs(S: int, W: int) -> int:
    """(query, key) pairs of a causal window W over S tokens."""
    return sum(min(s + 1, W) for s in range(S))


def serve_agreement(torch, bundle, p_cpu, dev, tree_map) -> None:
    """The 1-layer model served on one SERVE_AGREE_S-token prompt on the
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
    print(f"[agree] starcoder2-3b served at full width, "
          f"{bundle.cfg.n_layers} layer(s), fp32, one "
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
    every prefill with S > window + 1024, and the slot pool is updated in
    place across the admits and decodes -> (launches, a summary)."""
    from repro_torch.analysis import contracts
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
    pool_at = contracts.pointers(eng._state["cache"])
    t0 = time.time()
    comps = eng.run(reqs)
    wall = time.time() - t0
    contracts.assert_in_place(pool_at, eng._state["cache"],
                              "the SlotEngine cache pool")
    print(f"[serve lm] contracts: the slot pool's {len(pool_at)} cache "
          f"leaves in place across {SERVE_REQUESTS} admits and every "
          f"decode scan", flush=True)
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


def profile_call(torch, fn, tag: str, what: str, per: int = 1,
                 count=None):
    """``fn()`` once under ``torch.profiler`` after a warm-up call: host
    wall time, summed kernel time (device busy share), and the kernels
    that take the most device time, each over ``per`` (the steps ``fn``
    runs) -> (wall ms, busy ms, device ops, {name: instances}), the
    instances, of the whole call, those of each kernel whose name holds
    ``count[name]``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()                                                # warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3 / per
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue                            # host-side op records
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = ev.self_cuda_time_total
        rows.append((dt / 1e3, ev.count, ev.key))
    busy_ms = sum(r[0] for r in rows) / per
    n_kernels = sum(r[1] for r in rows) // per
    counts = {n: sum(c for _, c, key in rows if sym in key)
              for n, sym in (count or {}).items()}
    print(f"[profile {tag}] {what}: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), {n_kernels} "
          f"device ops{' a step' if per > 1 else ''}", flush=True)
    for dt, count_, key in sorted(rows, reverse=True)[:8]:
        print(f"[profile {tag}]   {dt / per:8.3f} ms  x{count_ // per:<6d} "
              f"{key[:80]}", flush=True)
    return wall_ms, busy_ms, n_kernels, counts


def profile_step(torch, bundle, tc, units, dev, params, tag, count=None):
    """One training step on one unit under the profiler -> (wall ms, busy
    ms, device ops, {name: traced instances of ``count[name]``})."""
    from repro_torch.train.engine import make_step_core, to_device
    from repro_torch.train.optim import make_update_for

    opt_state = make_update_for(tc)[0](params)
    step = make_step_core(bundle, tc)
    batch = to_device({k: v[0] for k, v in units.items()}, dev)
    return profile_call(torch, lambda: step(params, opt_state, batch,
                                            tc.lr), tag,
                        f"one training step (B={UNIT_SIZE})", count=count)


def greedy_with_margin(torch, greedy_decode, bundle, params, feats, lens):
    """``greedy_decode`` on ``params``, recording the top-2 margin of each
    frame's joint logits that the search reads -> (hyp, n_sym, smallest
    margin, largest |logit|)."""
    from repro_torch.models import rnnt as rnnt_mod
    joint_logits, seen = rnnt_mod.joint_logits, []

    def recording(p, z):
        logits = joint_logits(p, z)
        top2 = torch.topk(logits, 2, dim=-1).values
        seen.append((float((top2[..., 0] - top2[..., 1]).min()),
                     float(logits.abs().max())))
        return logits

    rnnt_mod.joint_logits = recording
    try:
        hyp, n_sym = greedy_decode(bundle, params, feats, lens)
    finally:
        rnnt_mod.joint_logits = joint_logits
    return hyp, n_sym, min(m for m, _ in seen), max(b for _, b in seen)


def reference_loop(torch, np, bundle, tc, units, val_units, val_corpus,
                   first, final_params, dev, mark):
    """Phase 6: the reference's own loop on the card, beside phase 5's
    first run (``first``, its final params): (a) preemption and resume,
    then a corrupted newest checkpoint; (b) the non-finite guard; (c) the
    dense loss against the fused one; (d) an exact-gradient PGM round and
    the Gram at (4, 4, 1,024,000); (e) greedy decode and TER, card
    against CPU; (f) the twin of ``examples/train_asr_pgm.py`` in a
    process of its own.  -> (launches of (a)'s run, the exact Gram's
    kernels row, the twin's output lines)."""
    import tempfile

    from repro_torch.configs.base import PGMConfig, TrainConfig
    from repro_torch.core.lastlayer import units_gradients
    from repro_torch.core.pgm import pgm_select
    from repro_torch.examples.train_asr_pgm import (greedy_decode,
                                                    token_error_rate)
    from repro_torch.kernels.omp_gram.ops import omp_gram_batched_op
    from repro_torch.kernels.omp_gram.ref import omp_gram_batched_ref
    from repro_torch.kernels.rnnt_lattice.ops import rnnt_lattice_op
    from repro_torch.models.api import build_model
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.engine import HostEngine, to_device
    from repro_torch.train.faults import FaultPlan, corrupt_checkpoint
    from repro_torch.train.optim import make_update_for

    # (a) the path's first REPEAT_EPOCHS epochs preempted after epoch 0,
    # then resumed: the remaining epoch and its round bitwise phase 5's
    # first run's; then the newest checkpoint corrupted, and the restore
    # falls back to the one before
    rnnt_lattice_op.launches = 0
    omp_gram_batched_op.launches = 0
    tc_a = dataclasses.replace(tc, epochs=REPEAT_EPOCHS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ck:
        t0 = time.time()
        logs = []
        cut = train_with_selection_logged(
            bundle, units, tc_a, val_units, logs, "[6a cut", t0,
            ckpt_dir=ck, fault_plan=FaultPlan(preempt_after_epoch=0))
        manifest = ckpt.read_manifest(ck)
        require(cut.preempted and len(cut.train_loss) == 1
                and manifest["extra"].get("preempted") is True,
                f"6a: the preempted run did not stop resumably: "
                f"{manifest['extra']}")
        res = train_with_selection_logged(
            bundle, units, tc_a, val_units, logs, "[6a resume", t0,
            ckpt_dir=ck, resume=True)
        torch.cuda.synchronize()
        launches = {"rnnt_lattice": rnnt_lattice_op.launches,
                    "omp_gram": omp_gram_batched_op.launches}
        joined = (cut.train_loss + res.train_loss, cut.val_loss
                  + res.val_loss,
                  [(s["epoch"], list(s["indices"]), list(s["weights"]))
                   for s in cut.selections + res.selections])
        same = joined == run_prefix(first)
        print(f"[6a] preempted after epoch 0 (manifest step "
              f"{manifest['step']}, extra.preempted true), resumed at epoch "
              f"1: {time.time() - t0:.1f} s for both; launches {launches}; "
              f"every loss and every round's indices and weights bitwise "
              f"equal to phase 5's first run's first {REPEAT_EPOCHS} epochs: "
              f"{same}", flush=True)
        require(same, f"6a: preempted + resumed run differs from the "
                      f"uninterrupted one: {joined} against {first}")
        require(all(n > 0 for n in launches.values()),
                f"6a: a kernel of the path was never launched: {launches}")
        newest = ckpt.latest_step(ck)
        corrupt_checkpoint(ck)
        fell = []
        _, m = ckpt.restore_latest_intact(
            ck, template={"params": final_params}, log_fn=fell.append)
        require(m["step"] == newest - 1 and len(fell) == 1,
                f"6a: no fall-back to the previous checkpoint: {fell}")
        print(f"[6a] step_{newest} corrupted: restore_latest_intact fell "
              f"back to step_{m['step']} ({fell[0][:90]}...)", flush=True)
    mark("6a preemption and resume")

    # (b) the guard: one warm epoch with a NaN at step 5, run in three
    # slices so the state around the poisoned step can be compared
    tc_g = dataclasses.replace(tc, optimizer="adamw", lr=0.05,
                               nonfinite_guard=True)
    eng = HostEngine(bundle, tc_g, units, device=dev)
    params = bundle.init_params(torch.Generator().manual_seed(0), dev)
    opt = make_update_for(tc_g)[0](params)
    idx, w = FaultPlan(nan_step=(0, 5)).poison_plan(0, eng.full_plan(0))
    t0 = time.time()
    skipped = 0
    states = [(params, opt)]
    for rows in (slice(0, 5), slice(5, 6), slice(6, None)):
        p, o, losses = eng.run_epoch(*states[-1], tc_g.lr,
                                     (idx[rows], w[rows]))
        skipped += eng.last_n_skipped
        states.append((p, o))
    torch.cuda.synchronize()
    before, after = states[1], states[2]
    held = all(bool(torch.equal(a, b)) for a, b in
               zip(tree_leaves(before), tree_leaves(after)))
    finite = all(bool(torch.isfinite(x).all()) for x in
                 tree_leaves(states[3]))
    print(f"[6b] guarded AdamW epoch of {len(w)} steps with a NaN weight at "
          f"step 5: {skipped} skipped; params and AdamW state (step, m, v) "
          f"bitwise unchanged across it: {held}; final state finite: "
          f"{finite} ({time.time() - t0:.1f} s)", flush=True)
    require(skipped == 1 and held and finite, "6b: the guard failed")
    del eng, states, before, after, params, opt
    mark("6b guard")

    # (c) the dense loss against the fused one on one full-width unit
    cfg_d = dataclasses.replace(bundle.cfg, rnnt=dataclasses.replace(
        bundle.cfg.rnnt, loss_impl="dense"))
    ub = to_device({k: v[0] for k, v in units.items()}, dev)
    got = {}
    for name, b in (("fused", bundle), ("dense", build_model(cfg_d))):
        rnnt_lattice_op.launches = 0
        live = tree_map(lambda x: x.detach().requires_grad_(True),
                        final_params)
        per_ex = b.per_example_loss(live, ub)
        total, _ = b.loss_fn(live, ub)
        grads = torch.autograd.grad(total, tree_leaves(live))
        torch.cuda.synchronize()
        got[name] = (per_ex.detach(), grads, rnnt_lattice_op.launches)
    loss_rel = float(((got["dense"][0] - got["fused"][0]).abs()
                      / got["fused"][0].abs()).max())
    grad_rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(
        1e-30)) for a, b in zip(got["dense"][1], got["fused"][1]))
    # bars: the loss at 1e-4; the gradients at 1e-3 of each leaf's
    # largest entry: both scale d(loss)/d(logits) by exp(-log p) of a
    # per-example log-likelihood of hundreds of nats summed over the
    # 128 x 33 lattice in fp32, in two orders (the dense autograd through
    # alpha, the fused beta pass), so every leaf moves together by ~1e-4
    # (2.9e-4 at the seed-0 init on the CPU)
    print(f"[6c] dense vs fused loss, one full-width unit (fp32, TF32 off): "
          f"per-example loss rel err {loss_rel:.2e} (bar 1e-4), gradients "
          f"at most {grad_rel:.2e} of a leaf's largest entry (bar 1e-3); "
          f"lattice launches fused {got['fused'][2]}, dense "
          f"{got['dense'][2]}", flush=True)
    require(loss_rel < 1e-4 and grad_rel < 1e-3,
            "6c: the dense and fused losses disagree")
    require(got["dense"][2] == 0 and got["fused"][2] > 0,
            "6c: the dense oracle went through the lattice kernel, or the "
            "fused loss did not")
    del got, live, per_ex, total, grads
    mark("6c dense loss")

    # (d) one exact-gradient PGM round on the trained params; the Gram at
    # its shape against its plain version, twice bitwise, timed
    pc = dataclasses.replace(tc.pgm, use_sketch=False)
    us, vs = to_device(units, dev), to_device(val_units, dev)
    omp_gram_batched_op.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    sel = pgm_select(bundle, final_params, us, pc, None, val_units=vs)
    torch.cuda.synchronize()
    exact_s = time.time() - t0
    exact_launches = omp_gram_batched_op.launches
    g = units_gradients(bundle, final_params, us, None, exact=True)
    P = pc.n_partitions
    gp = g.reshape(P, g.shape[0] // P, g.shape[1]).contiguous()
    k1, k2 = omp_gram_batched_op(gp), omp_gram_batched_op(gp)
    torch.cuda.synchronize()
    want = omp_gram_batched_ref(gp)
    require(bool(torch.equal(k1, k2)) and bool(torch.equal(k1, k1.transpose(
        1, 2))), "6d: the exact Gram is not bitwise repeatable or symmetric")
    err = gram_err(torch, k1, want)
    gt = gp.transpose(1, 2)
    k_ms, l_ms = [], []
    for _ in range(2):
        k_ms.append(cuda_ms(torch, lambda: omp_gram_batched_op(gp), 50))
        l_ms.append(cuda_ms(torch, lambda: torch.bmm(gp, gt), 50))
    p_ms = cuda_ms(torch, lambda: omp_gram_batched_ref(gp), 20)
    k_ms, l_ms = sum(k_ms) / 2, sum(l_ms) / 2
    _, n, D = gp.shape
    g_ops = P * n * (n + 1) * D
    b_ms, b_by = bound(4 * (P * n * D + P * n * n), g_ops)
    print(f"[6d] exact PGM round (stage A: {g.shape[0]} + "
          f"{vs['tokens'].shape[0]} units of {g.shape[1]:,} floats, then "
          f"stage B): {exact_s:.2f} s, "
          f"selected {sel.indices.cpu().tolist()}; Gram launches "
          f"{exact_launches}", flush=True)
    print(f"[kernels] omp_gram {tuple(gp.shape)} (exact stage B): "
          f"max_abs_err {err:.3e} kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
          f"library_ms (torch.bmm) {l_ms:.4f} (kernel / library "
          f"{k_ms / l_ms:.3f}) bound_ms {b_ms:.6f} ({b_by}) achieved "
          f"{4 * (P * n * D + P * n * n) / k_ms / 1e6:.1f} GB/s; two "
          f"launches bitwise equal, K exactly symmetric", flush=True)
    require(exact_launches > 0, "6d: the exact round never launched the "
                                "Gram kernel")
    gram_row = {"name": "omp_gram_batched", "path": "rnnt-exact",
                "route": "cuda",
                "source": "src/repro_torch/kernels/omp_gram/csrc/omp_gram.cu",
                "replaces": "src/repro/kernels/omp_gram/kernel.py:54",
                "launches": exact_launches, "max_abs_err": err, "ms": k_ms,
                "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": l_ms}
    del g, gp, gt, k1, k2, want, us, vs
    mark("6d exact stage B")

    # (e) greedy decode and TER on phase 5's final params over its 16
    # validation utterances, card against CPU; then on phase 8's random
    # weights, which emit symbols (the 3-epoch model emits blanks)
    feats, lens = val_corpus.feats, val_corpus.feat_lens
    for tag, p_dev in (("trained", final_params),
                       ("random seed 1", bundle.init_params(
                           torch.Generator().manual_seed(1), dev))):
        t0 = time.time()
        hyp, n_sym, margin, big = greedy_with_margin(
            torch, greedy_decode, bundle, p_dev, feats, lens)
        card_s = time.time() - t0
        p_cpu = tree_map(lambda x: x.cpu(), p_dev)
        t0 = time.time()
        hyp_c, n_c = greedy_decode(bundle, p_cpu, feats, lens)
        cpu_s = time.time() - t0
        ter = token_error_rate(hyp, n_sym, val_corpus.tokens,
                               val_corpus.token_lens)
        same = bool(np.array_equal(hyp, hyp_c) and np.array_equal(n_sym,
                                                                  n_c))
        print(f"[6e] greedy decode ({tag}), {len(lens)} validation "
              f"utterances: {int(n_sym.sum())} symbols, token error rate "
              f"{ter:.3f}; card hypotheses equal to the CPU's: {same}; "
              f"smallest top-2 margin {margin:.3e} (largest |logit| "
              f"{big:.3e}) (card {card_s:.1f} s with the margins read, "
              f"CPU {cpu_s:.1f} s)",
              flush=True)
        require(same, f"6e: card and CPU hypotheses differ ({tag})")
    mark("6e greedy decode")
    return launches, gram_row


#: rows of an epoch that ``replay_check`` replays under the profiler (an
#: RNN-T row is ~44,200 kernels, whose trace took ~5 s of host time beside
#: an H100 80GB HBM3 at 700 W)
TRACE_ROWS = 3

#: a kernel that each call of a wrapper launches once, by launch counter
KERNEL_MARKERS = {"rnnt_lattice": "rnnt_lattice_kernel",
                  "rwkv6_wkv": "wkv_out_kernel",
                  "rwkv6_wkv_bwd": "wkv_bwd_grad_kernel",
                  "grad_sketch": "gs_partial"}


class kept_graphs:
    """Within the block every ``torch.cuda.CUDAGraph()`` is made with
    ``keep_graph=True``: its ``cudaGraph_t`` outlives the capture (it is
    instantiated at its first replay), so ``graph_kernels`` can read its
    kernel nodes."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        import functools
        self.orig = self.torch.cuda.CUDAGraph
        self.torch.cuda.CUDAGraph = functools.partial(self.orig,
                                                      keep_graph=True)

    def __exit__(self, *exc):
        self.torch.cuda.CUDAGraph = self.orig


def graph_kernels(graph, markers):
    """{name: kernel nodes of a captured graph (kept, ``kept_graphs``)
    whose function's name holds ``markers[name]``}, read through the
    driver by ``contracts.graph_nodes`` (child graphs walked).  A replay
    runs every node once, so nodes x replays is exactly what the replays
    launched; the profiler's trace is the measurement beside it, and can
    drop a record (PERF.md section 7, 15d)."""
    from repro_torch.analysis import contracts
    found = [d for kind, d in contracts.graph_nodes(graph) if kind == "KERNEL"]
    return {n: sum(m in f for f in found) for n, m in markers.items()}


def device_only(graph, tag: str) -> dict:
    """``contracts.assert_graph_device_only`` on a kept graph -> its node
    types counted (``CUgraphNodeType`` names): no host node, no memcpy
    to or from the host."""
    from repro_torch.analysis import contracts
    contracts.assert_graph_device_only(graph, tag)
    kinds = {}
    for kind, _ in contracts.graph_nodes(graph):
        kinds[kind] = kinds.get(kind, 0) + 1
    return kinds


def check_node_types() -> str:
    """``contracts.NODE_TYPES`` (the driver's ``CUgraphNodeType``, which
    ``graph_nodes`` reads) against the toolkit's ``cuda.h``: every
    enumerator both name must have one value."""
    from repro_torch.analysis import contracts
    from repro_torch.kernels import backend
    header = Path(backend._nvcc()).resolve().parents[1] / "include" / "cuda.h"
    got = contracts.header_node_types(str(header))
    both = sorted(set(got) & set(contracts.NODE_TYPES))
    require(len(both) >= 8 and all(got[k] == contracts.NODE_TYPES[k]
                                   for k in both),
            f"CUgraphNodeType in {header}: {got} against "
            f"{contracts.NODE_TYPES}")
    return (f"{header}: CU_GRAPH_NODE_TYPE_ " + ", ".join(
        f"{k} {got[k]}" for k in sorted(both, key=got.get)))


class guarded_replays:
    """Within the block every ``EpochEngine`` replay loop (``_run_rows``:
    the plan's rows copied on the card, then one replay a row) runs under
    ``contracts.no_host_sync``: ``torch.cuda.set_sync_debug_mode("error")``
    and a mode that raises on any host read of a tensor."""

    def __init__(self, engine_cls, tag: str):
        self.cls, self.tag = engine_cls, tag

    def __enter__(self):
        from repro_torch.analysis import contracts
        orig = self.orig = self.cls._run_rows
        tag = self.tag

        def run_rows(eng, idx, w):
            with contracts.no_host_sync(f"{tag}: the replay loop"):
                return orig(eng, idx, w)

        self.cls._run_rows = run_rows
        return self

    def __exit__(self, *exc):
        self.cls._run_rows = self.orig


def replay_check(torch, np, bundle, tc, units, dev, params, ops, tag,
                 eager=None):
    """The scan engine on the card, on a fresh ``EpochEngine`` over
    ``units`` from ``params``.  The launch counters of ``ops`` ({name:
    (wrapper, attribute)}) count at the launch site, so: (1) one eager
    step under the profiler: its counts, and its traced marker kernels
    (``KERNEL_MARKERS``) the same numbers (or ``eager``, the per-step
    counts of a step already traced so, phase 7's); (2) a full epoch: the
    counts
    per step x (warm-up steps + the capture), one capture; then a second
    full epoch timed; (3) three rows of the next plan, the third made
    padding, replayed and run on the card without the graph from the same
    state: params, optimizer state and losses bitwise equal; (4) a plan
    of two padding rows through the graph: the state bitwise held, losses
    0, still one capture; (5) ``TRACE_ROWS`` rows of an epoch replayed
    under the profiler: the counts unchanged, each marker kernel traced
    per-step launches x rows times.  -> (per-step launches, the replayed
    rows' profile a step, ms a step of the timed epoch, the traced rows'
    launches).  The contracts hold from the capture on: no capture in
    (2)-(5) (plans of every row count: the full epoch, 3 rows, 2 rows),
    the params and optimizer buffers in place across them, the replay
    loops of (2)-(4) under ``no_host_sync``, the step graph device-only."""
    from repro_torch.analysis import contracts
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train.engine import (EpochEngine, make_step_core,
                                          to_device)
    from repro_torch.train.optim import make_update_for

    class Eager(EpochEngine):
        """The same step body on the card without the graph."""

        def _ensure_graph(self):
            pass

    def read():
        return {n: getattr(op, a) for n, (op, a) in ops.items()}

    def bitwise(a, b):
        return all(bool(torch.equal(x, y))
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    markers = {n: KERNEL_MARKERS[n] for n in ops}
    opt_init = make_update_for(tc)[0]
    if eager is None:
        opt0 = opt_init(params)
        batch = to_device({k: v[0] for k, v in units.items()}, dev)
        step = make_step_core(bundle, tc)
        n0 = read()
        _, _, _, traced = profile_call(
            torch, lambda: step(params, opt0, batch, tc.lr), tag,
            "one eager step", count=markers)
        per_step = {n: (c - n0[n]) // 2 for n, c in read().items()}
        print(f"[{tag}] one eager step: launches {per_step}, its traced "
              f"kernels {traced}", flush=True)
        require(all(v > 0 for v in per_step.values()) and traced == per_step,
                f"{tag}: an eager step's launches {per_step} against its "
                f"traced kernels {traced}")
        del opt0, batch
    else:
        per_step = dict(eager)
    EpochEngine.captures = EpochEngine.replays = 0
    EpochEngine.warmup_steps = 0
    eng = EpochEngine(bundle, tc, units, device=dev)
    plan = eng.full_plan(0)
    n_rows = len(plan[0])
    n0 = read()
    torch.cuda.synchronize()
    t0 = time.time()
    with kept_graphs(torch):            # the capture keeps its graph
        eng.run_epoch(params, opt_init(params), tc.lr, plan)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    got = {n: c - n0[n] for n, c in read().items()}
    want = {n: d * (EpochEngine.WARMUP_STEPS + 1)
            for n, d in per_step.items()}
    print(f"[{tag}] first epoch ({EpochEngine.WARMUP_STEPS} warm-up steps, "
          f"the capture, {n_rows} replays): {first_s:.2f} s; launches "
          f"counted {got} = per step {per_step} x "
          f"({EpochEngine.WARMUP_STEPS} warm-up steps + the capture) "
          f"{want}; captures {EpochEngine.captures}, replays "
          f"{EpochEngine.replays}", flush=True)
    require(got == want and EpochEngine.captures == 1
            and EpochEngine.replays == n_rows,
            f"{tag}: launches {got} against {want} or captures "
            f"{EpochEngine.captures}")
    kinds = device_only(eng._graph, f"{tag}: the step graph")
    state_at = contracts.pointers((eng.params, eng.opt_state))
    no_capture = contracts.assert_recapture_free(
        f"{tag}: the epochs after the capture")
    no_capture.__enter__()
    torch.cuda.synchronize()
    t0 = time.time()
    with guarded_replays(EpochEngine, tag):
        eng.run_epoch(eng.params, eng.opt_state, tc.lr, eng.full_plan(1))
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) * 1e3 / n_rows
    idx, w = eng.full_plan(2)
    idx, w = idx[:3].copy(), w[:3].copy()
    idx[2], w[2] = -1, 0.0
    start = tree_map(lambda x: x.clone(), (eng.params, eng.opt_state))
    with guarded_replays(EpochEngine, tag):
        _, _, l_graph = eng.run_epoch(eng.params, eng.opt_state, tc.lr,
                                      (idx, w))
    eager = Eager(bundle, tc, units, device=dev)
    p_e, o_e, l_eager = eager.run_epoch(*start, tc.lr, (idx, w))
    torch.cuda.synchronize()
    same = (bitwise((eng.params, eng.opt_state), (p_e, o_e))
            and l_graph.tolist() == l_eager.tolist())
    del eager, p_e, o_e, start
    before = tree_map(lambda x: x.clone(), (eng.params, eng.opt_state))
    pad = (np.full((2, eng.batch_units), -1, np.int32),
           np.zeros((2, eng.batch_units), np.float32))
    with guarded_replays(EpochEngine, tag):
        _, _, l_pad = eng.run_epoch(eng.params, eng.opt_state, tc.lr, pad)
    torch.cuda.synchronize()
    held = bitwise(before, (eng.params, eng.opt_state))
    del before
    print(f"[{tag}] second epoch {step_ms:.1f} ms a step ({n_rows} "
          f"replays); 3 rows (the third padding) replayed against the same "
          f"rows without the graph: params, optimizer state and losses "
          f"bitwise equal: {same} (losses {l_graph.tolist()}); 2 padding "
          f"rows through the graph: state bitwise held: {held}, losses "
          f"{l_pad.tolist()}; captures {EpochEngine.captures}", flush=True)
    require(same and l_graph[2] == 0.0,
            f"{tag}: the replayed rows differ from the eager rows")
    require(held and l_pad.tolist() == [0.0, 0.0]
            and EpochEngine.captures == 1,
            f"{tag}: padding rows are not bitwise no-ops through the graph")
    idx, w = eng.full_plan(3)
    rows = (idx[:TRACE_ROWS].copy(), w[:TRACE_ROWS].copy())
    n0 = read()
    t0 = time.time()
    *prof, traced = profile_call(
        torch, lambda: eng.run_epoch(eng.params, eng.opt_state, tc.lr, rows),
        tag, f"{TRACE_ROWS} replayed rows of an epoch of {n_rows}",
        per=TRACE_ROWS, count=markers)
    counted = {n: c - n0[n] for n, c in read().items()}
    no_capture.__exit__(None, None, None)
    contracts.assert_in_place(state_at, (eng.params, eng.opt_state),
                              f"{tag}: the params and optimizer buffers")
    print(f"[{tag}] contracts: no capture after the first in the second "
          f"epoch ({n_rows} rows), the 3- and 2-row plans and the traced "
          f"rows; the params and optimizer buffers in place across them "
          f"({len(state_at)} leaves); the replay loops under no_host_sync; "
          f"the step graph device-only, its nodes {kinds}", flush=True)
    want = {n: d * TRACE_ROWS for n, d in per_step.items()}
    nodes = graph_kernels(eng._graph, markers)
    ran = {n: v * TRACE_ROWS for n, v in nodes.items()}
    print(f"[{tag}] {TRACE_ROWS} replayed rows under the profiler "
          f"({time.time() - t0:.1f} s with their warm-up and the trace): "
          f"the step graph's kernel nodes {nodes} x {TRACE_ROWS} replays "
          f"{ran} = per step x {TRACE_ROWS} rows {want}; traced kernels "
          f"{traced}{'' if traced == want else ' (the trace dropped records)'}"
          f"; launches counted over both passes {counted} (replays make no "
          f"host call); captures {EpochEngine.captures}", flush=True)
    require(ran == want and all(traced[n] > 0 for n in want)
            and all(v == 0 for v in counted.values())
            and EpochEngine.captures == 1,
            f"{tag}: {TRACE_ROWS} replayed rows ran {ran} kernels (traced "
            f"{traced}), not {want}, or counted {counted} launches")
    return per_step, prof, step_ms, ran


def scan_engine_phase(torch, np, bundle, tc, units, val_units, first,
                      eager_step, models, dev, mark):
    """Phase 14: the scanned epoch engine (``engine="scan"``, one captured
    CUDA graph of the step replayed over each plan).  (a) phase 5's RNN-T
    main path through it, twice with one seed (bitwise equal), against
    phase 5's host run, then ``replay_check``; (b) the same with
    ``epoch_chunk=2``; (c) ``starcoder2-3b`` and ``rwkv6-3b`` at full
    width with 2 layers, 2 epochs, host against scan, then
    ``replay_check``; (d) the twin with ``--engine scan --epoch-chunk
    2``.  ``models``: {"lm"|"rwkv": (config, units, val units, counters)}.
    -> ({path: launches}, {path: launches counted in its scan run},
    14a's run record): a kernel of the captured step has the launches of
    ``replay_check``'s traced replayed epoch, one outside it its scan
    run's count."""
    from repro_torch.configs.base import PGMConfig, TrainConfig
    from repro_torch.kernels.omp_gram.ops import omp_gram_batched_op
    from repro_torch.kernels.rnnt_lattice.ops import rnnt_lattice_op
    from repro_torch.models.api import build_model
    from repro_torch.train.engine import EpochEngine
    from repro_torch.train.loop import train_with_selection

    rnnt_ops = {"rnnt_lattice": (rnnt_lattice_op, "launches"),
                "omp_gram": (omp_gram_batched_op, "launches")}

    def scan_run(b, us, vs, tc_, ops, tag, **kw):
        for op, a in ops.values():
            setattr(op, a, 0)
        EpochEngine.captures = EpochEngine.replays = 0
        EpochEngine.warmup_steps = 0
        torch.cuda.synchronize()
        t0 = time.time()
        h = train_with_selection(
            b, us, tc_, method="pgm", val_units=vs, device="cuda",
            log_fn=lambda s: print(f"[{tag} +{time.time() - t0:.1f}s] {s}",
                                   flush=True), **kw)
        torch.cuda.synchronize()
        secs = time.time() - t0
        launches = {n: getattr(op, a) for n, (op, a) in ops.items()}
        print(f"[{tag}] {secs:.1f} s ({h.wall_time:.1f} s after the init) "
              f"on engine={kw['engine']!r}{', epoch_chunk ' + str(kw['epoch_chunk']) if 'epoch_chunk' in kw else ''}; "
              f"launches {launches}; captures {EpochEngine.captures}, "
              f"replays {EpochEngine.replays}, warm-up steps "
              f"{EpochEngine.warmup_steps}; cost {h.cost_units:.3f} epoch "
              f"units", flush=True)
        require(all(v > 0 for v in launches.values()),
                f"{tag}: a kernel of the path was never launched: {launches}")
        if kw["engine"] == "scan":
            require(EpochEngine.captures == 1,
                    f"{tag}: {EpochEngine.captures} captures, not 1")
        return h, launches, secs

    def agree(rec, ref, tag, ref_tag):
        """Same subsets; weights and losses within rtol 1e-3."""
        (tl, vl, sels), (tl0, vl0, sels0) = rec, ref
        subsets = [(e, i) for e, i, _ in sels] == [(e, i) for e, i, _ in
                                                   sels0]
        weights = len(sels) == len(sels0) and all(
            np.allclose(w, w0, rtol=1e-3, atol=1e-6)
            for (_, _, w), (_, _, w0) in zip(sels, sels0))
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(tl + vl,
                                                           tl0 + vl0))
        print(f"[{tag}] against {ref_tag}: same subsets {subsets}, weights "
              f"within rtol 1e-3 {weights}, losses at most {loss_rel:.2e} "
              f"apart (rtol 1e-3), every loss, index and weight bitwise "
              f"equal: {rec == ref}", flush=True)
        require(subsets and weights and len(tl) == len(tl0)
                and loss_rel < 1e-3, f"{tag}: {rec} against {ref_tag} {ref}")

    # (a) the RNN-T main path through the scan engine (15a repeats the
    # path resident with one seed)
    h, launches, secs = scan_run(bundle, units, val_units, tc, rnnt_ops,
                                 "14a", engine="scan")
    runs = [(rnnt_run_record(h), launches, secs, h.final_params)]
    del h
    agree(runs[0][0], first, "14a", "phase 5's host run")
    # the eager step was traced and counted in phase 7
    per_step, replayed, step_ms, traced = replay_check(
        torch, np, bundle, tc, units, dev, runs[0][3],
        {"rnnt_lattice": (rnnt_lattice_op, "launches")}, "14a replay",
        eager=eager_step[3])
    print(f"[14a] one RNN-T step (B={UNIT_SIZE}): eager (phase 7) wall "
          f"{eager_step[0]:.1f} ms, busy {eager_step[1]:.1f} ms "
          f"({100 * eager_step[1] / eager_step[0]:.1f}%), {eager_step[2]} "
          f"device ops; replayed ({TRACE_ROWS} traced rows, a step) wall "
          f"{replayed[0]:.1f} ms, busy {replayed[1]:.1f} ms "
          f"({100 * replayed[1] / replayed[0]:.1f}%), {replayed[2]} device "
          f"ops; a replayed full epoch untraced {step_ms:.1f} ms a step",
          flush=True)
    # the captured step's kernels: the launches of a traced replayed
    # epoch; the rest (stage B's Gram): the scan run's counters
    launches = {"rnnt": dict(runs[0][1], **traced)}
    host_launches = {"rnnt": runs[0][1]}
    rec_a = runs[0][0]
    del runs
    gc.collect()
    mark("14a scan engine, RNN-T")

    # (b) the same loop in chunks of two epochs, its first REPEAT_EPOCHS
    h, _, _ = scan_run(bundle, units, val_units,
                       dataclasses.replace(tc, epochs=REPEAT_EPOCHS),
                       rnnt_ops, "14b", engine="scan", epoch_chunk=2)
    agree(rnnt_run_record(h), run_prefix(rec_a), "14b",
          "14a (chunks of 1)")
    del h
    gc.collect()
    mark("14b epoch chunks")

    # (c) the LM and RWKV at full width, 2 layers, host against scan
    for path, (cfg, us, vs, ops) in models.items():
        b2 = build_model(dataclasses.replace(cfg, n_layers=2))
        tc2 = TrainConfig(lr=0.05, optimizer="sgd", epochs=2, seed=0,
                          pgm=PGMConfig(subset_fraction=0.5,
                                        n_partitions=tc.pgm.n_partitions,
                                        select_every=1, warm_start_epochs=1,
                                        val_matching=True))
        tag = f"14c {path}"
        h_host, _, _ = scan_run(b2, us, vs, tc2, ops, f"{tag} host",
                                engine="host")
        rec_host = rnnt_run_record(h_host)
        del h_host
        gc.collect()
        h, counted, _ = scan_run(b2, us, vs, tc2, ops, f"{tag} scan",
                                 engine="scan")
        agree(rnnt_run_record(h), rec_host, f"{tag} scan", "the host run")
        step_ops = {n: v for n, v in ops.items() if n.startswith("rwkv6")}
        traced = replay_check(torch, np, b2, tc2, us, dev, h.final_params,
                              step_ops, f"{tag} replay")[3]
        launches[path] = dict(counted, **traced)
        host_launches[path] = counted
        del h, b2
        gc.collect()
        torch.cuda.empty_cache()
    mark("14c scan engine, LM and RWKV (2 layers)")

    # (d) the twin on the scan engine in chunks of two
    t0 = time.time()
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.train_asr_pgm",
         "--engine", "scan", "--epoch-chunk", "2"],
        cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(SRC)),
        capture_output=True, text=True, timeout=600)
    out = run.stdout.strip().splitlines()
    require(run.returncode == 0 and out and "token error rate" in out[-1],
            f"14d: the twin failed (rc {run.returncode}): "
            f"{run.stderr[-2000:]}")
    for line in filter(None, out):
        print(f"[14d] {line}", flush=True)
    picked = lambda lines: [l for l in lines if "selected" in l
                            or "token error rate" in l]
    print(f"[14d] python -m repro_torch.examples.train_asr_pgm --engine scan "
          f"--epoch-chunk 2 on the card: {time.time() - t0:.1f} s; its "
          f"selection and TER lines {picked(out)}", flush=True)
    mark("14d twin, scan engine")
    return launches, host_launches, rec_a


def resident_against_host(torch, b, pgm_cfg, params, us, vs, proj, read):
    """P7 on one params tree: a fresh ``ResidentSelector``'s stage A of
    the train and val units (warm-up and capture, then a replay of each)
    against host ``units_gradients`` (with the MoE router term when
    ``pgm_cfg`` asks for it), and its round against host
    ``pgm_select``.  ``read()`` -> the kernels' launch counts.  -> (the
    selector, its train vectors, the larger max error over the largest
    entry, whether the subsets and the weights (1e-4) are the same,
    whether two replays are bitwise equal, the launches counted at the
    warm-ups and captures).  The replays run under the contracts: no
    capture, no host read, the selector's params and outputs in place."""
    from repro_torch.analysis import contracts
    from repro_torch.core.lastlayer import units_gradients
    from repro_torch.core.pgm import (ResidentSelector, _router_term_for,
                                      pgm_select)

    rt = _router_term_for(b, pgm_cfg)
    n0 = read()
    sel = ResidentSelector(b, pgm_cfg, proj)
    g1, gv1 = sel.stage_a(params, us), sel.stage_a(params, vs)
    counted = {n: c - n0[n] for n, c in read().items() if c - n0[n]}
    held = (sel._params, [c.out for c in sel._captured])
    at = contracts.pointers(held)
    with contracts.assert_recapture_free("a replayed stage A"), \
            contracts.no_host_sync("a replayed stage A"):
        g2, gv2 = sel.stage_a(params, us), sel.stage_a(params, vs)
    contracts.assert_in_place(at, held, "the selector's params and outputs")
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(g1, g2) and torch.equal(gv1, gv2))
    host, host_v = (units_gradients(b, params, us, proj, router_term=rt),
                    units_gradients(b, params, vs, proj, router_term=rt))
    err = max(float((g1 - host).abs().max() / host.abs().max()),
              float((gv1 - host_v).abs().max() / host_v.abs().max()))
    s_res = sel(params, us, val_units=vs)
    s_host = pgm_select(b, params, us, pgm_cfg, proj, val_units=vs)
    same = (s_res.indices.tolist() == s_host.indices.tolist()
            and bool(torch.allclose(s_res.weights, s_host.weights,
                                    rtol=0, atol=1e-4)))
    torch.cuda.synchronize()
    return sel, g1, err, same, bitwise, counted


def resident_phase(torch, np, bundle, tc, units, val_units, rec_14a, models,
                   dev, mark, keep=None):
    """Phase 15: resident selection rounds (``ResidentSelector``: stage A
    one captured CUDA graph a unit corpus, of one chunk at a cursor over
    the units, replayed a chunk at a time every round).  (a)
    phase 5's RNN-T path on the scan engine with ``resident_selection``,
    the second run its first ``REPEAT_EPOCHS`` epochs; (b) on its trained
    params, resident against host stage A, two replays bitwise, a
    replayed stage A traced; (c) ``starcoder2-3b`` at full width and
    ``LM_RESIDENT_LAYERS`` layers, 2 epochs, its peak memory,
    resident against host stage A, ``chunk_units`` 4 against 1; (d)
    ``rwkv6-3b`` at full width with 2 layers, resident against host
    stage A, a replayed round traced; (e) an injected failure of the
    kernel route raises.  ``models``: {"lm"|"rwkv": (config, units, val
    units)}.  -> {path: {kernel: (launches, counted)}}: a kernel inside
    the graphs has the instances one replayed round ran (the graphs'
    kernel nodes x their replays; the trace must hold it) and, as
    counted, the launches of the selector's warm-ups and captures; stage
    B's Gram (eager) has its count in both."""
    import repro_torch.train.loop as loop_mod
    from repro_torch.analysis import contracts
    from repro_torch.configs.base import PGMConfig, TrainConfig
    from repro_torch.core.lastlayer import _chunk_size, make_proj_for
    from repro_torch.core.pgm import ResidentSelector
    from repro_torch.kernels.grad_sketch.ops import grad_sketch_units_op
    from repro_torch.kernels.omp_gram.ops import omp_gram_batched_op
    from repro_torch.kernels.rnnt_lattice.ops import rnnt_lattice_op
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_wkv_op
    from repro_torch.models.api import build_model
    from repro_torch.train.engine import EpochEngine, to_device
    from repro_torch.train.faults import failing_selection_kernels
    from repro_torch.train.loop import train_with_selection

    ops = {"rnnt_lattice": rnnt_lattice_op, "grad_sketch": grad_sketch_units_op,
           "rwkv6_wkv": rwkv6_wkv_op, "omp_gram": omp_gram_batched_op}
    read = lambda: {n: op.launches for n, op in ops.items()}
    delta = lambda n0: {n: c - n0[n] for n, c in read().items() if c - n0[n]}
    out = {}
    stage_a_log = []

    class Timed(ResidentSelector):
        """Each stage-A call timed on the host clock after a synchronize,
        with the captures so far; the calls after the first round's two
        (its captures) under the contracts: no capture, no host read, the
        selector's params buffers (the scan engine's) in place."""

        def stage_a(self, params, units_):
            torch.cuda.synchronize()
            t0 = time.time()
            if len(stage_a_log) < 2:
                g = super().stage_a(params, units_)
                self.held = contracts.pointers(self._params)
            else:
                with contracts.assert_recapture_free(
                        "a later round's stage A"), \
                        contracts.no_host_sync("a later round's stage A"):
                    g = super().stage_a(params, units_)
                contracts.assert_in_place(self.held, self._params,
                                          "the selector's params buffers")
            torch.cuda.synchronize()
            stage_a_log.append((ResidentSelector.captures, time.time() - t0))
            return g

    def resident_run(b, us, vs, tc_, tag, init=None):
        # ``init``: a callable drawing the initial params, called inside
        # the run's call so that no frame here holds them while the run
        # copies them into its engine
        for op in ops.values():
            op.launches = 0
        ResidentSelector.captures = ResidentSelector.replays = 0
        EpochEngine.captures = EpochEngine.replays = 0
        stage_a_log.clear()
        loop_mod.ResidentSelector = Timed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        try:
            h = train_with_selection(
                b, us, tc_, method="pgm", val_units=vs, device="cuda",
                engine="scan", resident_selection=True,
                params=None if init is None else init(),
                log_fn=lambda s: print(f"[{tag} +{time.time() - t0:.1f}s] "
                                       f"{s}", flush=True))
        finally:
            loop_mod.ResidentSelector = ResidentSelector
        torch.cuda.synchronize()
        secs = time.time() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        n = len(h.selections)
        rounds = [round(s["seconds"], 3) for s in h.selections]
        per_round = [round(sum(t for _, t in stage_a_log[2 * i:2 * i + 2]),
                           3) for i in range(n)]
        caps = [c for c, _ in stage_a_log]
        print(f"[{tag}] {secs:.1f} s ({h.wall_time:.1f} s after the init) "
              f"on engine='scan' with resident selection; rounds (stage A + "
              f"B, host clock) {rounds} s; stage A alone (train + val) "
              f"{per_round} s; captures after each stage-A call {caps}; "
              f"stage-A captures {ResidentSelector.captures}, replays "
              f"{ResidentSelector.replays}; step captures "
              f"{EpochEngine.captures}; launches {read()}; peak device memory {peak:.2f} GB "
              f"(torch.cuda.max_memory_allocated)", flush=True)
        chunks = sum(x["tokens"].shape[0] // _chunk_size(
            x["tokens"].shape[0], None) for x in (us, vs))
        require(ResidentSelector.captures == 2
                and ResidentSelector.replays == chunks * n
                and caps[:2] == [1, 2] and all(c == 2 for c in caps[2:]),
                f"{tag}: stage-A captures {caps}, not 2 in the first round "
                f"and none after")
        require(all(np.isfinite(h.train_loss))
                and all(np.isfinite(h.val_loss)), f"{tag}: non-finite loss")
        return h, read(), peak

    def round_check(b, pgm_cfg, params, us, vs, proj, tag, markers,
                    trace_round=True):
        """A fresh selector on ``params``: resident against host stage A
        (1e-5 of the largest entry) and the same selection; two replays
        bitwise; stage A and a round timed; one replayed round traced (or,
        without ``trace_round``, the replayed stage A of the validation
        corpus: an RNN-T round is ~432,700 kernels, whose trace took ~55 s
        of host time beside an H100 80GB HBM3 at 700 W) -> (train vectors,
        {kernel: (traced, counted)})."""
        with kept_graphs(torch):        # the captures keep their graphs
            sel, g1, err, same, bitwise, counted = resident_against_host(
                torch, b, pgm_cfg, params, us, vs, proj, read)
        graphs = [c.graph for c in sel._captured] + (
            [] if sel._head_graph is None else [sel._head_graph])
        kinds = [device_only(g, f"{tag}: a stage-A graph") for g in graphs]
        print(f"[{tag}] contracts: the replayed stage A (train + val) "
              f"captured nothing, read nothing back, kept the selector's "
              f"params and outputs in place; its {len(graphs)} graphs "
              f"device-only, their nodes {kinds}", flush=True)
        t0 = time.time()
        sel.stage_a(params, us)
        sel.stage_a(params, vs)
        torch.cuda.synchronize()
        t_a = time.time() - t0
        t0 = time.time()
        sel(params, us, val_units=vs)
        torch.cuda.synchronize()
        t_round = time.time() - t0
        n1 = read()
        if trace_round:
            fn, what = (lambda: sel(params, us, val_units=vs),
                        f"a replayed round ({us['tokens'].shape[0]} + "
                        f"{vs['tokens'].shape[0]} units, stage B eager)")
        else:
            fn, what = (lambda: sel.stage_a(params, vs),
                        f"a replayed stage A of the validation corpus "
                        f"({vs['tokens'].shape[0]} units)")
        mk = {k: KERNEL_MARKERS[k] for k in markers}
        *_, traced = profile_call(torch, fn, tag, what, count=mk)
        # what the replays ran: each replayed graph's kernel nodes x its
        # replays (a chunk each)
        ran = dict.fromkeys(markers, 0)
        for c in sel._captured:
            if trace_round or c.units is vs:
                for k, v in graph_kernels(c.graph, mk).items():
                    ran[k] += v * c.n_chunks
        moved = {k: v for k, v in delta(n1).items() if k in markers}
        print(f"[{tag}] resident stage A against host units_gradients: max "
              f"err {err:.2e} of the largest entry (1e-5); same subsets and "
              f"weights (1e-4): {same}; two replays bitwise equal: "
              f"{bitwise}; a replayed stage A (train + val) {t_a:.3f} s, a "
              f"replayed round {t_round:.3f} s (host clock); launches "
              f"counted at the warm-ups and captures {counted}; in a "
              f"replayed {'round' if trace_round else 'validation stage A'} "
              f"the graphs' kernel nodes x replays {ran}, traced {traced}"
              f"{'' if traced == ran else ' (the trace dropped records)'}; "
              f"counted during the traced replays {moved}", flush=True)
        require(err <= 1e-5 and same and bitwise and not moved
                and all(traced[k] > 0 for k in markers),
                f"{tag}: resident stage A disagrees with the host's, two "
                f"replays differ, a replay moved a counter or the trace "
                f"holds none of a kernel")
        return g1, {k: (ran[k], counted.get(k, 0)) for k in markers}

    # (a) the RNN-T main path, resident, twice with one seed
    runs = []
    for tag, tc_ in (("15a", tc), ("15a again", dataclasses.replace(
            tc, epochs=REPEAT_EPOCHS))):
        h, launches, _ = resident_run(bundle, units, val_units, tc_, tag)
        runs.append((rnnt_run_record(h), launches, h.final_params))
        del h
    again = runs[1][0] == run_prefix(runs[0][0])
    (tl, vl, sels), (tl0, vl0, sels0) = runs[0][0], rec_14a
    same = [(e, i) for e, i, _ in sels] == [(e, i) for e, i, _ in sels0]
    w_ok = all(np.allclose(w, w0, rtol=0, atol=1e-4)
               for (_, _, w), (_, _, w0) in zip(sels, sels0))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(tl + vl, tl0 + vl0))
    print(f"[15a] two resident runs of seed {tc.seed} bitwise equal over "
          f"the second's {REPEAT_EPOCHS} epochs: {again}; against 14a "
          f"(host stage A, scan "
          f"engine): same subsets {same}, weights within 1e-4 {w_ok}, losses "
          f"at most {loss_rel:.2e} apart (rtol 1e-3), bitwise equal: "
          f"{runs[0][0] == rec_14a}", flush=True)
    require(again, "15a: two resident runs differ")
    require(same and w_ok and loss_rel < 1e-3 and len(tl) == len(tl0),
            f"15a: {runs[0][0]} against 14a {rec_14a}")
    if keep is not None:                # phase 21a holds its run to this
        keep["15a"] = runs[0][0]
    omp_a = runs[0][1]["omp_gram"]
    mark("15a resident selection, RNN-T")

    # (b) on the trained params: a fresh selector against host stage A
    us, vs = to_device(units, dev), to_device(val_units, dev)
    proj = make_proj_for(bundle, torch.Generator().manual_seed(0),
                         tc.pgm.sketch_dim_h, tc.pgm.sketch_dim_v, dev)
    _, rows = round_check(bundle, tc.pgm, runs[0][2], us, vs, proj, "15b",
                          ["rnnt_lattice"], trace_round=False)
    n_units = vs["tokens"].shape[0]
    require(rows["rnnt_lattice"][0] == 2 * n_units,
            f"15b: {rows['rnnt_lattice'][0]} lattice kernels ran in a "
            f"replayed validation stage A, not 2 a unit x {n_units}")
    out["rnnt-resident"] = dict(rows, omp_gram=(omp_a, omp_a))
    del runs, us, vs
    gc.collect()
    torch.cuda.empty_cache()
    mark("15b resident stage A on the trained RNN-T params")

    # (c) starcoder2-3b at full width and depth on the scan engine
    lm_cfg, lm_us, lm_vs = models["lm"]
    lm = build_model(dataclasses.replace(lm_cfg,
                                         n_layers=LM_RESIDENT_LAYERS))
    pc_lm = PGMConfig(subset_fraction=0.5, n_partitions=tc.pgm.n_partitions,
                      select_every=1, warm_start_epochs=1, val_matching=True)
    tc_lm = TrainConfig(lr=0.05, optimizer="sgd", epochs=2, seed=0,
                        pgm=pc_lm)
    h, launches, peak = resident_run(lm, lm_us, lm_vs, tc_lm, "15c",
                                     lambda: card_init(torch, lm, dev))
    require(len(h.selections) == 1 and len(h.train_loss) == 2,
            "15c: the LM run did not run its round and epochs")
    params = h.final_params
    del h
    us, vs = to_device(lm_us, dev), to_device(lm_vs, dev)
    proj = make_proj_for(lm, torch.Generator().manual_seed(0),
                         pc_lm.sketch_dim_h, pc_lm.sketch_dim_v, dev)
    g1, rows = round_check(lm, pc_lm, params, us, vs, proj, "15c",
                           ["grad_sketch"])
    out["lm-resident"] = dict(rows, omp_gram=(launches["omp_gram"],) * 2)
    gc.collect()
    n0 = read()
    sel4 = ResidentSelector(lm, pc_lm, proj, chunk_units=4)
    with kept_graphs(torch):
        g4 = sel4.stage_a(params, us)
    counted = delta(n0).get("grad_sketch", 0)
    *_, traced = profile_call(torch, lambda: sel4.stage_a(params, us), "15c",
                              "a replayed stage A at chunk_units 4",
                              count={"grad_sketch": "gs_partial"})
    (c4,) = sel4._captured
    ran = graph_kernels(c4.graph, {"grad_sketch": "gs_partial"})[
        "grad_sketch"] * c4.n_chunks
    per_unit = float(((g4 - g1).abs().amax(dim=1)
                      / g1.abs().amax(dim=1)).max())
    n_u = us["tokens"].shape[0]
    print(f"[15c] chunk_units 4 against 1: per unit vector at most "
          f"{per_unit:.2e} of its largest entry apart (1e-5); grad-sketch "
          f"launches counted {counted} (the warm-up's chunk and the "
          f"captured chunk, U = 4 each); in a replayed stage A of {n_u} "
          f"units the graph's kernel nodes x replays {ran}, traced "
          f"{traced['grad_sketch']}", flush=True)
    require(per_unit <= 1e-5 and counted == 2 and ran == n_u // 4
            and traced["grad_sketch"] > 0,
            "15c: chunk_units 4 disagrees with 1 or launches the kernel "
            "another number of times than once a chunk")
    out["lm-resident-chunk4"] = {"grad_sketch": (ran, counted)}
    del sel4, g4, g1, params, lm, us, vs
    gc.collect()
    torch.cuda.empty_cache()
    mark(f"15c resident selection, starcoder2-3b {LM_RESIDENT_LAYERS} "
         f"layers")

    # (d) rwkv6-3b at full width with 2 layers, init params
    rw_cfg, rw_us, rw_vs = models["rwkv"]
    rw2 = build_model(dataclasses.replace(rw_cfg, n_layers=2))
    params = rw2.init_params(torch.Generator().manual_seed(0), dev)
    us, vs = to_device(rw_us, dev), to_device(rw_vs, dev)
    proj = make_proj_for(rw2, torch.Generator().manual_seed(1),
                         pc_lm.sketch_dim_h, pc_lm.sketch_dim_v, dev)
    n0 = read()
    _, rows = round_check(rw2, pc_lm, params, us, vs, proj, "15d",
                          ["rwkv6_wkv", "grad_sketch"])
    n_units = us["tokens"].shape[0] + vs["tokens"].shape[0]
    require(rows["rwkv6_wkv"][0] == 2 * n_units,
            f"15d: {rows['rwkv6_wkv'][0]} WKV forwards ran in a replayed "
            f"round, not a unit x 2 layers x {n_units}")
    omp_d = read()["omp_gram"] - n0["omp_gram"]
    out["rwkv-resident"] = dict(rows, omp_gram=(omp_d, omp_d))
    mark("15d resident stage A, rwkv6-3b 2 layers")

    # (e) an injected failure of the kernel route raises on the card
    sel = ResidentSelector(rw2, pc_lm, proj, on_failure="soft_random")
    raised = None
    with failing_selection_kernels(("cuda",)):
        try:
            sel(params, us, val_units=vs)
        except RuntimeError as err:
            raised = err
    print(f"[15e] an injected failure of the 'cuda' route: raised "
          f"{raised!r}; degraded rounds {sel.degraded_rounds}", flush=True)
    require(raised is not None and "injected kernel failure" in str(raised)
            and sel.degraded_rounds == 0,
            "15e: a failed kernel route did not raise out of the round")
    del sel, params, rw2, us, vs
    gc.collect()
    torch.cuda.empty_cache()
    mark("15e injected kernel failure")
    return out


def card_init(torch, bundle, dev, seed: int = 0):
    """fp32 master weights of ``bundle`` drawn by a generator on the card
    (seconds, where a host generator takes ~20 s for 3B params), for a
    run's ``params=``."""
    return bundle.init_params(torch.Generator(device=dev).manual_seed(seed),
                              dev)


def greedy_logits(torch, bundle, params, prompt, steps: int):
    """The bundle's own prefill, then ``steps`` greedy decode calls ->
    (every step's logits, the tokens): the hooks the serving engines
    call, on exactly the tree given (the engines would cast it first)."""
    with torch.no_grad():
        logits, cache = bundle.prefill(params, {"tokens": prompt},
                                       cache_len=prompt.shape[1] + steps)
        out, toks = [logits], []
        for _ in range(steps):
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            toks.append(tok)
            logits, cache = bundle.decode(params, cache, tok)
            out.append(logits)
    return out, torch.stack(toks, dim=1)


def launch_counters():
    """(zero, read) over every kernel wrapper's launch counter:
    ``zero()`` sets each to 0, ``read()`` -> {kernel: launches}."""
    from repro_torch.kernels.grad_sketch.ops import grad_sketch_units_op
    from repro_torch.kernels.omp_gram.ops import omp_gram_batched_op
    from repro_torch.kernels.rnnt_lattice.ops import rnnt_lattice_op
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_wkv_op
    from repro_torch.kernels.swa_attn.ops import swa_attn_op

    ops = {"rnnt_lattice": (rnnt_lattice_op, "launches"),
           "omp_gram": (omp_gram_batched_op, "launches"),
           "grad_sketch": (grad_sketch_units_op, "launches"),
           "rwkv6_wkv": (rwkv6_wkv_op, "launches"),
           "swa_attn": (swa_attn_op, "launches"),
           "swa_attn_bwd": (swa_attn_op, "bwd_launches")}

    def zero():
        for op, attr in ops.values():
            setattr(op, attr, 0)

    def read():
        return {n: getattr(op, attr) for n, (op, attr) in ops.items()}
    return zero, read


def dense_phase(torch, np, dev, mark):
    """Phase 16: the reference's other dense archs and examples.  (a)
    ``gemma3-27b`` at full width and ``GEMMA3_SERVE_LAYERS`` layers
    served from bf16 weights drawn
    on the card (no fp32 masters): ``generate`` on 2 x 8,192 prompts, then
    ``SlotEngine`` on the launcher's 8 requests; (b) at full width and
    one group of 6 layers, fp32 masters against their ``serving_params``:
    prefill and greedy decode logits bitwise; (c) ``gemma3-27b``,
    ``gemma-7b`` and ``minitron-8b`` at full width and reduced depth,
    trained on the scan engine with resident selection for 2 epochs,
    each held against host stage A (P7); (d) the twins of the reference's
    quickstart and ``train_lm_pgm`` on the card, ``--selection-kernels``
    auto against xla.  -> {path: {kernel: launches}}."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PGMConfig, TrainConfig
    from repro_torch.core.lastlayer import make_proj_for
    from repro_torch.core.pgm import ResidentSelector
    from repro_torch.examples import quickstart, train_lm_pgm
    from repro_torch.launch.serve import make_requests
    from repro_torch.launch.train import make_units_for
    from repro_torch.models.api import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.serve.engine import SlotEngine, generate
    from repro_torch.train.engine import EpochEngine, to_device
    from repro_torch.train.loop import train_with_selection

    zero, read = launch_counters()

    out = {}
    gb = lambda: torch.cuda.max_memory_allocated() / 1e9

    # (a) gemma3-27b at full width, bf16 weights only
    cfg = dataclasses.replace(get_config("gemma3-27b"),
                              n_layers=GEMMA3_SERVE_LAYERS)
    b27 = build_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    params = b27.init_params(torch.Generator(device=dev).manual_seed(0), dev,
                             dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_par = sum(l.numel() for l in tree_leaves(params))
    w_gb = sum(l.numel() * l.element_size()
               for l in tree_leaves(params)) / 1e9
    print(f"[16a] gemma3-27b at full width ({cfg.n_layers} of 62 "
          f"layers: {cfg.layer_kinds().count('local')} local (window "
          f"{cfg.window}), {cfg.layer_kinds().count('global')} global; "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads over "
          f"{cfg.n_kv_heads} KV heads of {cfg.head_dim}, GeGLU "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, QK-norm, tied head): "
          f"{n_par:,} params ({cfg.n_params():,} by the reference's "
          f"formula), {w_gb:.2f} GB of bf16 serving weights drawn on the "
          f"card in {init_s:.1f} s, no fp32 masters", flush=True)
    require(all(l.dtype == torch.bfloat16 for k, v in params.items()
                if k != "final_norm" for l in tree_leaves(v))
            and params["final_norm"].dtype == torch.float32,
            "16a: the serving weights are not bf16 (final norm fp32)")
    prompts = torch.randint(0, cfg.vocab_size, (2, SERVE_PROMPT),
                            dtype=torch.int32, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    zero()
    toks, st = generate(b27, params, prompts, SERVE_NEW)
    torch.cuda.synchronize()
    n_gen = read()
    per_step = st.decode_s * 1e3 / max(st.decode_steps, 1)
    print(f"[16a] generate 2 x {SERVE_PROMPT} -> {tuple(toks.shape)}: "
          f"prefill {st.prefill_s * 1e3:.1f} ms, decode "
          f"{st.decode_s * 1e3:.1f} ms / {st.decode_steps} steps "
          f"({per_step:.1f} ms a step, {st.tokens_per_s:.1f} live tok/s); "
          f"launches {n_gen}", flush=True)
    n_local = cfg.layer_kinds().count("local")
    require(n_gen["swa_attn"] == n_local
            and sum(n_gen.values()) == n_local,
            f"16a: generate's prefill launched {n_gen}, not the band kernel "
            f"once a local layer ({n_local})")
    require(toks.shape == (2, SERVE_NEW) and bool((toks >= 0).all())
            and bool((toks < cfg.vocab_size).all()), "16a: tokens")
    reqs = make_requests(cfg, SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW, 0)
    lens = sorted(len(r.inputs["tokens"]) for r in reqs)
    zero()
    eng = SlotEngine(b27, params, n_slots=SERVE_SLOTS,
                     max_new_tokens=SERVE_NEW, max_prompt_len=SERVE_PROMPT)
    torch.cuda.synchronize()
    t0 = time.time()
    comps = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    n_slot = read()
    lat = sorted(c.latency_s for c in comps)
    peak_a = gb()
    print(f"[16a] SlotEngine, {SERVE_SLOTS} slots, {len(reqs)} requests of "
          f"{lens[0]}-{lens[-1]} tokens, {SERVE_NEW} new each: {wall:.2f} s, "
          f"{len(comps) / wall:.2f} req/s, p50 latency "
          f"{lat[len(lat) // 2] * 1e3:.0f} ms, {eng.n_decode_dispatches} "
          f"decode dispatches; launches {n_slot}; peak device memory "
          f"{peak_a:.2f} GB (torch.cuda.max_memory_allocated; weights "
          f"{w_gb:.2f} GB)", flush=True)
    require(len(comps) == len(reqs)
            and all(len(c.tokens) == SERVE_NEW for c in comps),
            "16a: the slot engine did not complete every request")
    require(n_slot["swa_attn"] == n_local * len(reqs)
            and sum(n_slot.values()) == n_slot["swa_attn"],
            f"16a: the slot engine launched {n_slot}, not the band kernel "
            f"once a local layer a request")
    out["serve-gemma3-27b"] = {"swa_attn": n_gen["swa_attn"]
                               + n_slot["swa_attn"]}
    del params, eng, comps, toks, prompts
    gc.collect()
    torch.cuda.empty_cache()
    mark(f"16a gemma3-27b served at full width, {GEMMA3_SERVE_LAYERS} layers")

    # (b) one group at full width: fp32 masters against serving weights
    b6 = build_model(dataclasses.replace(cfg, n_layers=GEMMA3_AGREE_LAYERS))
    masters = b6.init_params(torch.Generator(device=dev).manual_seed(2), dev)
    served = b6.serving_params(masters)
    prompt = torch.randint(0, cfg.vocab_size, (1, GEMMA3_AGREE_S),
                           dtype=torch.int32, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(3))
    zero()
    lm_, tm_ = greedy_logits(torch, b6, masters, prompt, GEMMA3_AGREE_STEPS)
    ls_, ts_ = greedy_logits(torch, b6, served, prompt, GEMMA3_AGREE_STEPS)
    torch.cuda.synchronize()
    n_b = read()
    same = [bool(torch.equal(a, c)) for a, c in zip(lm_, ls_)]
    print(f"[16b] gemma3-27b at full width, {GEMMA3_AGREE_LAYERS} layers "
          f"({b6.cfg.layer_kinds().count('local')} local, "
          f"{b6.cfg.layer_kinds().count('global')} global): prefill of "
          f"{GEMMA3_AGREE_S} tokens and {GEMMA3_AGREE_STEPS} greedy decode "
          f"steps from the fp32 masters (cast a block call) and from "
          f"serving_params of them (bf16, cast once): logits bitwise equal "
          f"at {sum(same)} of {len(same)} steps, tokens equal "
          f"{bool(torch.equal(tm_, ts_))}; launches {n_b}", flush=True)
    require(all(same) and bool(torch.equal(tm_, ts_)),
            "16b: serving weights give other logits than the fp32 masters")
    require(n_b["swa_attn"] == 2 * b6.cfg.layer_kinds().count("local"),
            f"16b: the prefill did not take the band: {n_b}")
    del b6, masters, served, lm_, ls_, prompt
    gc.collect()
    torch.cuda.empty_cache()
    mark("16b serving weights bitwise the fp32 masters")

    # (c) full width, reduced depth, trained on the scan engine with
    # resident rounds, then held against host stage A
    pc = PGMConfig(subset_fraction=0.5, n_partitions=4, select_every=1,
                   warm_start_epochs=1, val_matching=True)
    tc = TrainConfig(lr=0.05, optimizer="sgd", epochs=2, seed=0, pgm=pc)
    for arch, layers in DENSE_TRAIN:
        c = dataclasses.replace(get_config(arch), n_layers=layers)
        bd = build_model(c)
        us_np, vs_np = make_units_for(c, n=LM_N, seq=LM_SEQ, noise=0.0)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero()
        ResidentSelector.captures = ResidentSelector.replays = 0
        EpochEngine.captures = EpochEngine.replays = 0
        torch.cuda.synchronize()
        t0 = time.time()
        init = [card_init(torch, bd, dev)]
        n_par = sum(l.numel() for l in tree_leaves(init[0]))
        h = train_with_selection(
            bd, us_np, tc, method="pgm", val_units=vs_np, device="cuda",
            engine="scan", resident_selection=True, params=init.pop(),
            log_fn=lambda s: print(f"[16c {arch} +{time.time() - t0:.1f}s] "
                                   f"{s}", flush=True))
        torch.cuda.synchronize()
        secs, peak = time.time() - t0, gb()
        n_run = read()
        print(f"[16c] {arch} at full width, {layers} layers ({n_par:,} "
              f"params; cut from {get_config(arch).n_layers} layers), "
              f"{us_np['tokens'].shape[0]} units of {UNIT_SIZE} x {LM_SEQ} "
              f"tokens, 2 epochs, scan engine, resident rounds: {secs:.1f} s "
              f"({h.wall_time:.1f} s after the init); rounds "
              f"{[round(s['seconds'], 3) for s in h.selections]} s; "
              f"stage-A captures {ResidentSelector.captures}, replays "
              f"{ResidentSelector.replays}; step captures "
              f"{EpochEngine.captures}; losses train "
              f"{[round(x, 4) for x in h.train_loss]} val "
              f"{[round(x, 4) for x in h.val_loss]}; launches {n_run}; peak "
              f"device memory {peak:.2f} GB", flush=True)
        require(len(h.selections) == 1 and len(h.train_loss) == 2
                and all(np.isfinite(h.train_loss + h.val_loss)),
                f"16c {arch}: the run did not finish its round and epochs")
        require(n_run["grad_sketch"] > 0 and n_run["omp_gram"] > 0
                and n_run["swa_attn"] == 0,
                f"16c {arch}: a kernel of the path was not launched: {n_run}")
        params = h.final_params
        del h
        gc.collect()
        us, vs = to_device(us_np, dev), to_device(vs_np, dev)
        proj = make_proj_for(bd, torch.Generator().manual_seed(0),
                             pc.sketch_dim_h, pc.sketch_dim_v, dev)
        sel, _, err, same, bitwise, counted = resident_against_host(
            torch, bd, pc, params, us, vs, proj, read)
        print(f"[16c] {arch}: resident stage A against host units_gradients "
              f"on the trained params: max err {err:.2e} of the largest "
              f"entry (1e-5); same subsets and weights (1e-4): {same}; two "
              f"replays bitwise equal: {bitwise}; launches counted at the "
              f"warm-ups and captures {counted}", flush=True)
        require(err <= 1e-5 and same and bitwise,
                f"16c {arch}: resident stage A disagrees with the host's")
        out[f"{arch}-resident"] = {"grad_sketch": n_run["grad_sketch"],
                                   "omp_gram": n_run["omp_gram"]}
        del sel, params, us, vs, proj, bd
        gc.collect()
        torch.cuda.empty_cache()
        mark(f"16c {arch} trained at full width, {layers} layers")

    # (d) the twins on the card
    t0 = time.time()
    qs = quickstart.run(device="cuda", log_fn=lambda s: print(
        f"[16d quickstart] {s}", flush=True))
    require(all(np.isfinite(h.val_loss).all() for h in qs.values())
            and len(qs["pgm"].selections) == 2,
            "16d: the quickstart twin did not run")
    print(f"[16d] quickstart twin: {time.time() - t0:.1f} s", flush=True)
    runs = {}
    for impl in ("auto", "xla"):
        zero()
        t0 = time.time()
        h = train_lm_pgm.run(n=32, epochs=4, kernel_impl=impl,
                             device="cuda", log_fn=lambda s: print(
                                 f"[16d train_lm_pgm {impl}] {s}",
                                 flush=True))
        runs[impl] = (h, read(), time.time() - t0)
    (ha, na, ta), (hx, nx, tx) = runs["auto"], runs["xla"]
    rel = max(abs(a - x) / abs(x) for a, x in
              zip(ha.train_loss + ha.val_loss, hx.train_loss + hx.val_loss))
    same = [sa["indices"] for sa in ha.selections] == \
        [sx["indices"] for sx in hx.selections]
    print(f"[16d] train_lm_pgm twin --n 32 --epochs 4, --selection-kernels "
          f"auto ({ta:.1f} s, launches {na}) against xla ({tx:.1f} s, "
          f"launches {nx}): losses at most {rel:.2e} apart (rtol 1e-3); "
          f"same subsets {same}", flush=True)
    require(na["grad_sketch"] > 0 and na["omp_gram"] > 0,
            f"16d: auto did not launch the selection kernels: {na}")
    require(nx["grad_sketch"] == 0 and nx["omp_gram"] == 0,
            f"16d: xla launched a selection kernel: {nx}")
    require(rel <= 1e-3, "16d: auto and xla losses differ")
    out["lm-twin"] = {"grad_sketch": na["grad_sketch"],
                      "omp_gram": na["omp_gram"]}
    mark("16d the twins on the card")
    return out


def moe_kernel_rows(torch, dev):
    """Phase 3 at the shapes phase 17 gives the kernels: the grad sketch
    at both MoE archs' stage-A units (``SKETCH_MOE``, untied heads), the
    Gram at their router-term stage-B shapes (``GRAM_MOE``, M6) and the
    band at ``mixtral-8x7b``'s 2 x 8,192 prefill (``SWA_MIXTRAL``), each
    held against its plain version and timed -> {"grad_sketch": {arch:
    row}, "omp_gram": {arch: row}, "swa_attn": row}, a row {max_abs_err,
    ms, plain_ms, library_ms, bound_ms, bound_by}."""
    from repro_torch.kernels.grad_sketch.ops import grad_sketch_units_op
    from repro_torch.kernels.grad_sketch.ref import grad_sketch_units_ref
    from repro_torch.kernels.swa_attn.ops import swa_attn_op
    from repro_torch.kernels.swa_attn.ref import swa_attn_ref

    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")
    out = {"grad_sketch": {}, "omp_gram": {}}
    for i, (arch, shape) in enumerate(SKETCH_MOE.items()):
        e, k_ms, p_ms, b_ms, b_by = sketch_row(
            torch, grad_sketch_units_op, grad_sketch_units_ref, shape,
            20 + i, dev, arch, on_card=True)
        out["grad_sketch"][arch] = dict(zip(keys, (e, k_ms, p_ms, None,
                                                   b_ms, b_by)))
        torch.cuda.empty_cache()
    for arch, shape in GRAM_MOE.items():
        err, k_ms, p_ms, l_ms, b_ms, b_by = gram_row(torch, shape, dev)
        out["omp_gram"][arch] = dict(zip(keys, (err, k_ms, p_ms, l_ms, b_ms,
                                                b_by)))
    err, margin = swa_err(torch, swa_attn_op, swa_attn_ref, SWA_MIXTRAL, dev)
    print(f"[kernels] swa_attn {SWA_MIXTRAL}: max abs err {err:.3e}, "
          f"{margin:.3f} of the bar at most; two launches bitwise equal",
          flush=True)
    swa = swa_timed(torch, swa_attn_op, swa_attn_ref, SWA_MIXTRAL, err,
                    margin, dev)
    out["swa_attn"] = dict(zip(keys, (err,) + swa))
    torch.cuda.empty_cache()
    return out


def moe_split(torch, prof, cfg, group: int, capacity: int):
    """Device time of a call profiled with ``record_shapes``, by part ->
    ({part: ms}, total ms).  An op is placed by its operands' shapes (the
    card's profiler records no Python frames), or, for the matmul and the
    copies inside an ``aten::einsum``, by that einsum's matmul: one that
    contracts or produces the experts' slots, E x C wide, is the dispatch
    or combine einsum's, else the expert GEMMs'.  The experts' hidden
    (E, G, C, d_ff_expert) and their weights' matmuls are the experts';
    the router's matmul and the (G, g, E), (G, E) and (G, g, E, C) passes
    of the top-k and the aux are the routing; the scores and p.v (a
    batched matmul with the head dim), the 5-D masks and softmax and the
    band kernel are attention; the rest (norms, projections, the LM head,
    casts, the optimizer, most of the backward's elementwise passes) is
    the total less the parts."""
    from torch.autograd import DeviceType

    m = cfg.moe
    E, C, f, hd = m.n_experts, capacity, m.d_ff_expert, cfg.head_dim
    mm = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")

    def dev_ms(ev):
        t = getattr(ev, "self_device_time_total", None)
        return (ev.self_cuda_time_total if t is None else t) / 1e3

    def by_shapes(ev):
        sh = [tuple(x) for x in (ev.input_shapes or []) if x]
        if ev.name in mm:
            if any(E * C in s for s in sh):
                return "dispatch/combine einsums"
            if any(len(s) == 3 and s[0] == E and f in s[1:] for s in sh):
                return "expert GEMMs"
            if any(len(s) == 2 and s[-1] == E for s in sh):
                return "routing"
            if any(len(s) == 3 and hd in s[1:] for s in sh):
                return "attention"
            return None
        if any(len(s) == 4 and s[0] == E and s[-1] == f for s in sh):
            return "expert GEMMs"
        if any(len(s) == 4 and s[-2:] == (E, C)
               or len(s) == 3 and s[1:] == (group, E)
               or len(s) == 2 and s[-1] == E for s in sh):
            return "routing"
        if any(len(s) == 5 for s in sh):
            return "attention"
        return None

    def part_of(ev):
        p = ev
        while p is not None:
            if p.name == "aten::einsum":
                bmm = [c for c in p.cpu_children if c.name in mm]
                return (by_shapes(bmm[0]) if bmm else None) \
                    or "expert GEMMs"
            p = p.cpu_parent
        return by_shapes(ev)

    split = {"dispatch/combine einsums": 0.0, "expert GEMMs": 0.0,
             "routing": 0.0, "attention": 0.0, "rest": 0.0}
    total = 0.0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            total += dev_ms(ev)
            if "swa" in ev.key:
                split["attention"] += dev_ms(ev)
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            continue
        t = dev_ms(ev)
        if t > 0:
            part = part_of(ev)
            if part is not None:
                split[part] += t
    split["rest"] = total - sum(v for k, v in split.items() if k != "rest")
    return split, total


def moe_profile(torch, fn, cfg, tokens: int, tag: str, what: str):
    """``fn()`` (over ``tokens`` tokens of ``cfg``) once under the
    profiler after a warm-up call, shapes recorded: host wall time,
    device busy time and its split by part (``moe_split``) -> (wall ms,
    busy ms, split)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.moe import DEFAULT_GROUP

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    g = min(DEFAULT_GROUP, tokens)
    capacity = max(1, int(cfg.moe.capacity_factor * g * cfg.moe.top_k
                          / cfg.moe.n_experts))
    split, busy = moe_split(torch, prof, cfg, g, capacity)
    print(f"[profile {tag}] {what}: wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%); device time by "
          f"part: " + ", ".join(f"{k} {v:.1f} ms ({100 * v / busy:.1f}%)"
                                for k, v in split.items()), flush=True)
    kernels = sorted(((ev.self_device_time_total / 1e3, ev.count, ev.key)
                      for ev in prof.key_averages()
                      if ev.device_type == DeviceType.CUDA), reverse=True)
    for ms, n, key in kernels[:8]:
        print(f"[profile {tag}]   {ms:8.3f} ms  x{n:<6d} {key[:80]}",
              flush=True)
    return wall_ms, busy, split


def run_fingerprint(torch, hist):
    """A training run's record for 'two runs bitwise equal': each epoch's
    losses, each round's indices and weights, and each final leaf's bits
    summed as int64 with their positions weighted in."""
    from repro_torch.models.common import tree_leaves

    def bits(x):
        # in slices of 2**24 entries: an expert stack has ~1e9
        total = weighted = 0
        for v in x.detach().reshape(-1).view(torch.int32).split(1 << 24):
            v = v.to(torch.int64)
            w = torch.arange(1, v.numel() + 1, device=v.device)
            total += int(v.sum())
            weighted += int((v * w).sum())
        return total, weighted
    return (tuple(hist.train_loss), tuple(hist.val_loss),
            tuple((s["epoch"], tuple(s["indices"]), tuple(s["weights"]))
                  for s in hist.selections),
            tuple(bits(l) for l in tree_leaves(hist.final_params)))


def train_twice(torch, np, bundle, us_np, vs_np, tc, dev, tag, what,
                zero, read, gb, kernels, runs: int = 2):
    """A path of phases 17c, 18c and 19a-b: ``bundle`` trained 2 epochs on
    the scan engine with resident rounds (one round) from weights drawn
    on the card, ``runs`` times (2 or 1) with one seed; each run's time,
    rounds, captures, losses, launches and peak memory printed; with two
    runs every epoch's losses, the round and every final leaf's bits
    equal across them; each run launches ``kernels`` (the path's) and no
    other counted kernel -> (the last run's final params, the first
    run's launches)."""
    from repro_torch.core.pgm import ResidentSelector
    from repro_torch.models.common import tree_leaves
    from repro_torch.train.engine import EpochEngine
    from repro_torch.train.loop import train_with_selection

    cfg = bundle.cfg
    n_runs, runs = runs, []
    for rep in range(n_runs):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero()
        ResidentSelector.captures = ResidentSelector.replays = 0
        EpochEngine.captures = EpochEngine.replays = 0
        torch.cuda.synchronize()
        t0 = time.time()
        h = train_with_selection(
            bundle, us_np, tc, method="pgm", val_units=vs_np, device="cuda",
            engine="scan", resident_selection=True,
            params=card_init(torch, bundle, dev),
            log_fn=lambda s: print(f"[{tag} {cfg.name} +"
                                   f"{time.time() - t0:.1f}s] {s}",
                                   flush=True))
        torch.cuda.synchronize()
        secs, peak = time.time() - t0, gb()
        n_run = read()
        n_par = sum(l.numel() for l in tree_leaves(h.final_params))
        U, b, S = us_np["tokens"].shape
        depth = (f"{cfg.n_enc_layers} encoder + {cfg.n_layers} decoder"
                 if cfg.family == "encdec" else str(cfg.n_layers))
        print(f"[{tag}] {cfg.name} at full width, {depth} layers "
              f"({n_par:,} params), run {rep + 1}: {U} units of {b} x {S} "
              f"tokens, 2 epochs, scan engine, resident rounds{what}: "
              f"{secs:.1f} s ({h.wall_time:.1f} s after the init); rounds "
              f"{[round(s['seconds'], 3) for s in h.selections]} s; "
              f"stage-A captures {ResidentSelector.captures}, replays "
              f"{ResidentSelector.replays}; step captures "
              f"{EpochEngine.captures}; losses train "
              f"{[round(x, 4) for x in h.train_loss]} val "
              f"{[round(x, 4) for x in h.val_loss]}; launches {n_run}; "
              f"peak device memory {peak:.2f} GB", flush=True)
        require(len(h.selections) == 1 and len(h.train_loss) == 2
                and all(np.isfinite(h.train_loss + h.val_loss)),
                f"{tag} {cfg.name}: the run did not finish its round and "
                f"epochs")
        require(all(n_run[k] > 0 for k in kernels)
                and all(v == 0 for k, v in n_run.items() if k not in kernels),
                f"{tag} {cfg.name}: launches {n_run}, not {kernels} alone")
        runs.append((run_fingerprint(torch, h), n_run))
        params = h.final_params
        del h
        if rep < n_runs - 1:
            del params
    if n_runs == 1:
        return params, runs[0][1]
    same = runs[0][0] == runs[1][0]
    print(f"[{tag}] {cfg.name}: two runs of seed {tc.seed}, every epoch's "
          f"losses, the round's indices and weights and every final leaf's "
          f"bits equal: {same}", flush=True)
    require(same, f"{tag} {cfg.name}: two runs of one seed differ")
    gc.collect()
    return params, runs[0][1]


def moe_serve(torch, dev, arch, layers, prompt_len, zero, read, gb, mark):
    """Phase 17a/b for one MoE arch at full width and ``layers`` layers,
    from bf16 weights drawn on the card: ``generate`` on 2 prompts of
    ``prompt_len``, ``SlotEngine`` on the launcher's 8 requests at
    ``--prompt-len MOE_SLOT_PROMPT`` (M1: every slot prefill one group),
    the peak memory -> (the run's launches, the bf16 bundle and weights
    for the caller's profile)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.api import build_model
    from repro_torch.models.attention import Q_BLOCK
    from repro_torch.models.common import tree_leaves
    from repro_torch.serve.engine import SlotEngine, generate

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    b = build_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    params = b.init_params(torch.Generator(device=dev).manual_seed(0), dev,
                           dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s, init_peak = time.time() - t0, gb()
    n_par = sum(l.numel() for l in tree_leaves(params))
    w_gb = sum(l.numel() * l.element_size()
               for l in tree_leaves(params)) / 1e9
    m = cfg.moe
    tag = "17a" if arch == "olmoe-1b-7b" else "17b"
    print(f"[{tag}] {arch} at full width, {layers} of {full.n_layers} "
          f"layers ({cfg.layer_kinds()[0]} attention"
          f"{', window ' + str(cfg.window) if cfg.window else ''}; d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV "
          f"heads of {cfg.head_dim}, {m.n_experts} experts top-{m.top_k} of "
          f"d_ff {m.d_ff_expert}, vocab {cfg.vocab_size}): {n_par:,} params "
          f"({cfg.n_params():,} by the reference's formula; "
          f"{full.n_params():,} at full depth), {w_gb:.2f} GB of bf16 "
          f"serving weights drawn on the card layer by layer in "
          f"{init_s:.1f} s (peak {init_peak:.2f} GB), no fp32 masters",
          flush=True)
    require(all(l.dtype == torch.bfloat16 for k, v in params.items()
                if k != "final_norm" for l in tree_leaves(v)),
            f"{tag}: the serving weights are not bf16")
    prompts = torch.randint(0, cfg.vocab_size, (2, prompt_len),
                            dtype=torch.int32, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    zero()
    toks, st = generate(b, params, prompts, SERVE_NEW)
    torch.cuda.synchronize()
    n_gen = read()
    per_step = st.decode_s * 1e3 / max(st.decode_steps, 1)
    print(f"[{tag}] generate 2 x {prompt_len} -> {tuple(toks.shape)}: "
          f"prefill {st.prefill_s * 1e3:.1f} ms, decode "
          f"{st.decode_s * 1e3:.1f} ms / {st.decode_steps} steps "
          f"({per_step:.2f} ms a step, {st.tokens_per_s:.1f} live tok/s); "
          f"launches {n_gen}", flush=True)
    # the band branch: a local layer past window + Q_BLOCK tokens
    band = cfg.window and prompt_len > cfg.window + Q_BLOCK
    want = cfg.n_layers if band else 0
    require(n_gen["swa_attn"] == want and sum(n_gen.values()) == want,
            f"{tag}: generate launched {n_gen}, not the band kernel {want} "
            f"times (once a local layer past the window)")
    require(toks.shape == (2, SERVE_NEW) and bool((toks >= 0).all())
            and bool((toks < cfg.vocab_size).all()), f"{tag}: tokens")
    reqs = make_requests(cfg, SERVE_REQUESTS, MOE_SLOT_PROMPT, SERVE_NEW, 0)
    lens = sorted(len(r.inputs["tokens"]) for r in reqs)
    zero()
    eng = SlotEngine(b, params, n_slots=SERVE_SLOTS,
                     max_new_tokens=SERVE_NEW, max_prompt_len=MOE_SLOT_PROMPT)
    torch.cuda.synchronize()
    t0 = time.time()
    comps = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    n_slot = read()
    lat = sorted(c.latency_s for c in comps)
    peak = gb()
    print(f"[{tag}] SlotEngine, {SERVE_SLOTS} slots, {len(reqs)} requests of "
          f"{lens[0]}-{lens[-1]} tokens ("
          f"{'exact lengths' if eng.exact_lengths else 'power-of-two buckets'}"
          f"), {SERVE_NEW} new each: {wall:.2f} s, {len(comps) / wall:.2f} "
          f"req/s, p50 latency {lat[len(lat) // 2] * 1e3:.0f} ms, "
          f"{eng.n_decode_dispatches} decode dispatches; launches {n_slot}; "
          f"peak device memory {peak:.2f} GB (torch.cuda.max_memory_allocated;"
          f" weights {w_gb:.2f} GB)", flush=True)
    require(len(comps) == len(reqs)
            and all(len(c.tokens) == SERVE_NEW for c in comps),
            f"{tag}: the slot engine did not complete every request")
    require(sum(n_slot.values()) == 0,
            f"{tag}: slot prefills of <= {MOE_SLOT_PROMPT} tokens launched "
            f"{n_slot}")
    require(peak <= MOE_PEAK_GB, f"{tag}: peak {peak:.2f} GB over "
                                 f"{MOE_PEAK_GB} GB")
    del eng, comps, toks, prompts
    mark(f"{tag} {arch} served at full width, {layers} layers")
    return n_gen["swa_attn"] + n_slot["swa_attn"], b, params


def moe_phase(torch, np, dev, mark):
    """Phase 17: the MoE family.  (a) ``olmoe-1b-7b`` at full width and
    depth and (b) ``mixtral-8x7b`` at full width and
    ``MIXTRAL_SERVE_LAYERS`` layers served from bf16 weights drawn on the
    card (``moe_serve``), with one ``olmoe`` prefill profiled (e) and, at
    one layer, fp32 masters against their ``serving_params`` (logits
    bitwise at every step); (c) both archs at full width and reduced
    depth (``MOE_TRAIN``) trained 2 epochs on the scan engine with
    resident rounds and the router term, twice with one seed (bitwise
    equal), then resident stage A against the host's (P7) and at
    ``chunk_units`` 1 the head blocks bitwise the head-only vectors, and
    one step of each profiled (e).  -> {path: {kernel: launches}}."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PGMConfig, TrainConfig
    from repro_torch.core.lastlayer import make_proj_for
    from repro_torch.core.pgm import ResidentSelector
    from repro_torch.launch.train import make_units_for
    from repro_torch.models.api import build_model
    from repro_torch.train.engine import make_step_core, to_device
    from repro_torch.train.optim import make_update_for

    zero, read = launch_counters()

    out = {}
    gb = lambda: torch.cuda.max_memory_allocated() / 1e9

    # (a) olmoe-1b-7b at full width and depth, and its prefill profiled
    full = get_config("olmoe-1b-7b")
    n, bo, po = moe_serve(torch, dev, "olmoe-1b-7b", full.n_layers,
                          MOE_SLOT_PROMPT, zero, read, gb, mark)
    out["serve-olmoe-1b-7b"] = {"swa_attn": n}
    prompts = torch.randint(0, full.vocab_size, (2, MOE_SLOT_PROMPT),
                            dtype=torch.int32, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(5))
    with torch.no_grad():
        moe_profile(torch, lambda: bo.prefill(po, {"tokens": prompts}),
                    full, 2 * MOE_SLOT_PROMPT, "17e",
                    f"olmoe-1b-7b prefill of 2 x {MOE_SLOT_PROMPT} tokens, "
                    f"bf16 serving weights, full depth")
    del bo, po, prompts
    gc.collect()
    torch.cuda.empty_cache()

    # (a) at one layer: fp32 masters against serving weights
    b1 = build_model(dataclasses.replace(full, n_layers=1))
    masters = b1.init_params(torch.Generator(device=dev).manual_seed(2), dev)
    served = b1.serving_params(masters)
    prompt = torch.randint(0, full.vocab_size, (1, MOE_SLOT_PROMPT),
                           dtype=torch.int32, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(3))
    lm_, tm_ = greedy_logits(torch, b1, masters, prompt, MOE_AGREE_STEPS)
    ls_, ts_ = greedy_logits(torch, b1, served, prompt, MOE_AGREE_STEPS)
    torch.cuda.synchronize()
    same = [bool(torch.equal(a, c)) for a, c in zip(lm_, ls_)]
    print(f"[17a] olmoe-1b-7b at full width, 1 layer: prefill of "
          f"{MOE_SLOT_PROMPT} tokens and {MOE_AGREE_STEPS} greedy decode "
          f"steps from the fp32 masters (cast a block call) and from "
          f"serving_params of them (bf16, cast once): logits bitwise equal "
          f"at {sum(same)} of {len(same)} steps, tokens equal "
          f"{bool(torch.equal(tm_, ts_))}", flush=True)
    require(all(same) and bool(torch.equal(tm_, ts_)),
            "17a: serving weights give other logits than the fp32 masters")
    del b1, masters, served, lm_, ls_, prompt
    gc.collect()
    torch.cuda.empty_cache()
    mark("17a serving weights bitwise the fp32 masters")

    # (b) mixtral-8x7b at full width, reduced depth
    n, bm, pm = moe_serve(torch, dev, "mixtral-8x7b", MIXTRAL_SERVE_LAYERS,
                          SERVE_PROMPT, zero, read, gb, mark)
    out["serve-mixtral-8x7b"] = {"swa_attn": n}
    del bm, pm
    gc.collect()
    torch.cuda.empty_cache()

    # (c) trained at full width, reduced depth, with the router term
    pc = PGMConfig(subset_fraction=0.5, n_partitions=4, select_every=1,
                   warm_start_epochs=1, val_matching=True,
                   moe_router_term=True)
    tc = TrainConfig(lr=0.05, optimizer="sgd", epochs=2, seed=0, pgm=pc)
    for arch, layers, runs in MOE_TRAIN:
        c = dataclasses.replace(get_config(arch), n_layers=layers)
        bd = build_model(c)
        us_np, vs_np = make_units_for(c, n=LM_N, seq=LM_SEQ, noise=0.0)
        params, n_run = train_twice(
            torch, np, bd, us_np, vs_np, tc, dev, "17c",
            " with the router term", zero, read, gb,
            ("grad_sketch", "omp_gram"), runs=runs)
        us, vs = to_device(us_np, dev), to_device(vs_np, dev)
        proj = make_proj_for(bd, torch.Generator().manual_seed(0),
                             pc.sketch_dim_h, pc.sketch_dim_v, dev)
        sel, g1, err, same, bitwise, counted = resident_against_host(
            torch, bd, pc, params, us, vs, proj, read)
        head = ResidentSelector(bd, dataclasses.replace(
            pc, moe_router_term=False), proj, chunk_units=1).stage_a(
                params, us)
        D_head = pc.sketch_dim_h * pc.sketch_dim_v
        head_same = bool(torch.equal(g1[:, :D_head], head))
        print(f"[17c] {arch}: resident stage A with the router term (D = "
              f"{g1.shape[1]}: the head's {D_head} + {layers} layers x "
              f"{pc.sketch_dim_h} x {c.moe.n_experts}, M6) against host "
              f"units_gradients on the trained params: max err {err:.2e} of "
              f"the largest entry (1e-5); same subsets and weights (1e-4): "
              f"{same}; two replays bitwise equal: {bitwise}; head blocks "
              f"bitwise the head-only vectors (chunk_units 1): {head_same}; "
              f"launches counted at the warm-ups and captures {counted}",
              flush=True)
        require(err <= 1e-5 and same and bitwise and head_same,
                f"17c {arch}: resident stage A disagrees with the host's")
        require(g1.shape[1] == D_head + layers * pc.sketch_dim_h
                * c.moe.n_experts, f"17c {arch}: D {g1.shape[1]}")
        del sel, g1, head, us, vs, proj
        gc.collect()
        torch.cuda.empty_cache()
        # (e) one step profiled, its device time by part
        step = make_step_core(bd, tc)
        opt_state = make_update_for(tc)[0](params)
        batch = to_device({k: v[0] for k, v in us_np.items()}, dev)
        moe_profile(torch, lambda: step(params, opt_state, batch, tc.lr), c,
                    UNIT_SIZE * LM_SEQ, "17e",
                    f"{arch} ({layers} layers) one training step (B="
                    f"{UNIT_SIZE} x {LM_SEQ}), eager")
        out[f"{arch}-resident"] = {"grad_sketch": n_run["grad_sketch"],
                                   "omp_gram": n_run["omp_gram"]}
        del params, opt_state, batch, step, bd
        gc.collect()
        torch.cuda.empty_cache()
        mark(f"17c {arch} trained at full width, {layers} layers")
    return out


def wkv_pad_row(torch, dev):
    """The WKV forward at ``WKV_PAD``: rwkv6-3b's prefill with pad rows
    (k 0 and a log-decay of 0 past the row's length, as the time mix
    sets them).  Two launches bitwise equal; y at the live rows and the
    final state against the plain chunk algebra on the same card tensors
    (1e-4 of each one's largest entry); the padded row, whose length ends
    inside a chunk, against the sequential scan of its live prefix alone
    (no pad row; y and the final state, 1e-4 of the largest entry: the
    chunk that holds live and pad rows, S10); its state bitwise the
    kernel's on the prefix rounded up to a chunk (whole pad chunks carry
    it unchanged); timed against the plain version -> (max abs err,
    kernel ms, plain ms, library ms (None), bound ms, what bounds it)."""
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_wkv_op, wkv_forward
    from repro_torch.kernels.rwkv6_scan.ref import wkv_scan

    B, S, H, N, C, lens = WKV_PAD
    (r, k, v, lw, u), _ = wkv_inputs(torch, B, S, H, N, None, seed=11,
                                     dev=dev)
    n = torch.tensor(lens, device=dev)
    live = (torch.arange(S, device=dev)[None, :] < n[:, None])[..., None,
                                                               None]
    k = torch.where(live, k, torch.zeros((), device=dev))
    lw = torch.where(live, lw, torch.zeros((), device=dev))
    with torch.no_grad():
        y, st = rwkv6_wkv_op(r, k, v, lw, u, C)
        y2, st2 = rwkv6_wkv_op(r, k, v, lw, u, C)
        torch.cuda.synchronize()
        require(bool(torch.equal(y, y2) and torch.equal(st, st2)),
                f"rwkv6_wkv {WKV_PAD}: two launches differ")
        yp, sp = wkv_plain(torch, r, k, v, lw, u, C)
        L = lens[1]
        cut = -(-L // C) * C
        _, st_cut = rwkv6_wkv_op(*(x[1:, :cut].contiguous()
                                   for x in (r, k, v, lw)), u, C)
        y_seq, st_seq = wkv_scan(r[1:, :L], k[1:, :L], v[1:, :L],
                                 torch.exp(lw[1:, :L]), u,
                                 torch.zeros(1, H, N, N, device=dev))
    keep = live.expand_as(y)
    err_y = float((y - yp)[keep].abs().max())
    err_s = float((st - sp).abs().max())
    y_scale, s_scale = float(yp[keep].abs().max()), float(sp.abs().max())
    require(err_y <= 1e-4 * y_scale and err_s <= 1e-4 * s_scale,
            f"rwkv6_wkv {WKV_PAD}: y err {err_y} (scale {y_scale}), state "
            f"err {err_s} (scale {s_scale})")
    pre_y = float((y[1, :L] - y_seq[0]).abs().max())
    pre_s = float((st[1] - st_seq[0]).abs().max())
    pre_ys, pre_ss = float(y_seq.abs().max()), float(st_seq.abs().max())
    require(pre_y <= 1e-4 * pre_ys and pre_s <= 1e-4 * pre_ss,
            f"rwkv6_wkv {WKV_PAD}: the padded row against the sequential "
            f"scan of its {L} live tokens: y err {pre_y} (scale {pre_ys}), "
            f"state err {pre_s} (scale {pre_ss})")
    same = bool(torch.equal(st[1], st_cut[0]))
    require(same, f"rwkv6_wkv {WKV_PAD}: the pad chunks moved the state")
    k_ms = cuda_ms(torch, lambda: wkv_forward(r, k, v, lw, u, C, False),
                   reps=20)
    with torch.no_grad():
        p_ms = cuda_ms(torch, lambda: wkv_plain(torch, r, k, v, lw, u, C),
                       reps=3)
    # r, k, v, lw, u read once, y and the final state written once; 4 N^2
    # FLOP a (token, head) over the whole padded prefill
    bshn, bhnn = B * S * H * N, B * H * N * N
    b_ms, b_by = bound(4 * (4 * bshn + H * N + bshn + bhnn),
                       4 * N * N * B * S * H)
    err = max(err_y, err_s)
    print(f"[kernels] rwkv6_wkv with pad rows {WKV_PAD}: y err {err_y:.3e} "
          f"({err_y / y_scale:.1e} of the largest entry), state err "
          f"{err_s:.3e} ({err_s / s_scale:.1e}); two launches bitwise "
          f"equal; the padded row ({L} live tokens, {L % C} of them in a "
          f"chunk with pad rows) against the sequential scan of its live "
          f"tokens alone: y err {pre_y:.3e} ({pre_y / pre_ys:.1e}), state "
          f"err {pre_s:.3e} ({pre_s / pre_ss:.1e}); its state bitwise the "
          f"kernel's on {cut} tokens (whole pad chunks): {same}; kernel_ms "
          f"{k_ms:.4f} plain_ms "
          f"{p_ms:.4f} library_ms none bound_ms {b_ms:.4f} ({b_by})",
          flush=True)
    del r, k, v, lw, u, y, y2, yp, st, st2, sp, st_cut, y_seq, st_seq
    return err, k_ms, p_ms, None, b_ms, b_by


def hybrid_kernel_rows(torch, dev):
    """Phase 3 at the shapes phase 18 gives the kernels: the band at head
    dim 256 (``SWA_RG_EDGES``, then ``SWA_RG`` in fp32 and in bf16, the
    bf16 timed against SDPA), the WKV forward with pad rows
    (``wkv_pad_row``), the grad sketch at recurrentgemma-9b's stage-A
    unit (``SKETCH_RG``) and the Gram of its stage B (``GRAM_RG``) ->
    {kernel: row}, a row {max_abs_err, ms, plain_ms, library_ms,
    bound_ms, bound_by}."""
    from repro_torch.kernels.grad_sketch.ops import grad_sketch_units_op
    from repro_torch.kernels.grad_sketch.ref import grad_sketch_units_ref
    from repro_torch.kernels.swa_attn.ops import swa_attn_op
    from repro_torch.kernels.swa_attn.ref import swa_attn_ref

    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")
    out = {}
    for shape in SWA_RG_EDGES + (SWA_RG[:6] + ("float32", None), SWA_RG):
        err, margin = swa_err(torch, swa_attn_op, swa_attn_ref, shape, dev)
        print(f"[kernels] swa_attn {shape}: max abs err {err:.3e}, "
              f"{margin:.3f} of the bar at most; two launches bitwise equal",
              flush=True)
    swa = swa_timed(torch, swa_attn_op, swa_attn_ref, SWA_RG, err, margin,
                    dev)
    out["swa_attn"] = dict(zip(keys, (err,) + swa))
    torch.cuda.empty_cache()
    out["rwkv6_wkv"] = dict(zip(keys, wkv_pad_row(torch, dev)))
    torch.cuda.empty_cache()
    e, k_ms, p_ms, b_ms, b_by = sketch_row(
        torch, grad_sketch_units_op, grad_sketch_units_ref, SKETCH_RG, 30,
        dev, "recurrentgemma-9b", on_card=True)
    out["grad_sketch"] = dict(zip(keys, (e, k_ms, p_ms, None, b_ms, b_by)))
    torch.cuda.empty_cache()
    out["omp_gram"] = dict(zip(keys, gram_row(torch, GRAM_RG, dev)))
    return out


def rglru_profile(torch, fn, tag: str, what: str):
    """``fn()`` once under the profiler after a warm-up call: host wall
    time, device busy time, the RG-LRU scan's device time (the kernels
    under the ``rglru.scan`` and ``rglru.scan_bwd`` ranges of
    ``models/rglru.py``) and its share, and the kernels that take the
    most -> (wall ms, busy ms, scan ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    kernels, scan_ms, ranges = [], 0.0, {}
    for ev in prof.key_averages():
        if ev.key.startswith("rglru."):
            if ev.device_type != DeviceType.CUDA:
                total = getattr(ev, "device_time_total", None)
                if total is None:
                    total = ev.cuda_time_total
                scan_ms += total / 1e3
                ranges[ev.key] = ev.count
            continue                   # the ranges' own device-side rows
        if ev.device_type != DeviceType.CUDA:
            continue
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = ev.self_cuda_time_total
        kernels.append((dt / 1e3, ev.count, ev.key))
    busy = sum(k[0] for k in kernels)
    require(scan_ms > 0, f"{tag}: no device time under the rglru ranges")
    print(f"[profile {tag}] {what}: wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%); the RG-LRU scan "
          f"(ranges {ranges}) {scan_ms:.1f} ms, {100 * scan_ms / busy:.1f}% "
          f"of the busy time", flush=True)
    for ms, c, key in sorted(kernels, reverse=True)[:8]:
        print(f"[profile {tag}]   {ms:8.3f} ms  x{c:<6d} {key[:80]}",
              flush=True)
    return wall_ms, busy, scan_ms


def _padded_prefill(torch, b, params, toks, bucket, dev, lens=True):
    """B = 1 prefill of ``toks`` right-padded to ``bucket`` as the slot
    engine admits it (its length given), or, with ``lens`` False, as the
    reference's padded prefill leaves a recurrent block (the pads run
    through it, S10) -> (logits (1,V), cache)."""
    L = toks.shape[0]
    x = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
    x[0, :L] = torch.from_numpy(toks).to(dev)
    n = torch.tensor([L], dtype=torch.int32, device=dev) if lens else None
    return b.prefill(b.serving_params(params), {"tokens": x},
                     cache_len=bucket, prompt_lens=n)


def padded_greedy(torch, b, params, toks, bucket, new, dev):
    """The slot engine's arithmetic for one request outside it: the
    padded prefill, then ``new`` - 1 greedy decode steps -> tokens."""
    sp = b.serving_params(params)
    with torch.no_grad():
        logits, cache = _padded_prefill(torch, b, params, toks, bucket, dev)
        out = [torch.argmax(logits, dim=-1).to(torch.int32)]
        for _ in range(new - 1):
            logits, cache = b.decode(sp, cache, out[-1])
            out.append(torch.argmax(logits, dim=-1).to(torch.int32))
    return torch.cat(out).tolist()


def padded_against_unpadded(torch, b, params, toks, bucket, dev, tag):
    """One rwkv6-3b request's padded prefill (``_padded_prefill``)
    against the unpadded prefill of its tokens: the last-token logits,
    each recurrent cache leaf (S, x_tmix, x_cmix, all layers) and the
    logits of one decode step on the same token, each within the bar of
    the bundle's compute dtype (``RWKV_PAD_BARS``) of its largest entry
    in the unpadded run; the reference's padded prefill (pads through the
    recurrence) must miss that bar on S and on the step's logits (S10)."""
    from repro_torch.models.common import tree_leaves

    sp = b.serving_params(params)
    L = toks.shape[0]
    leaves, tok = {}, None
    for name, lens in (("unpadded", None), ("padded", True),
                       ("reference's padded", False)):
        with torch.no_grad():
            if lens is None:
                logits, cache = b.prefill(
                    sp, {"tokens": torch.from_numpy(toks).to(dev)[None]},
                    cache_len=L)
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                logits, cache = _padded_prefill(torch, b, params, toks,
                                                bucket, dev, lens=lens)
            by = {"logits": [logits.float()]}
            for entry in list(cache["groups"]) + list(cache["tail"]):
                for key in ("S", "x_tmix", "x_cmix"):
                    by.setdefault(key, []).append(entry[key].float().clone())
            by["step logits"] = [b.decode(sp, cache, tok)[0].float()]
        leaves[name] = by
        del cache

    def rel(other, key):
        want = leaves["unpadded"][key]
        err = max(float((g - w).abs().max())
                  for g, w in zip(leaves[other][key], want))
        return err / max(float(w.abs().max()) for w in want)

    dt = b.cfg.compute_dtype
    bar = RWKV_PAD_BARS[dt]
    keys = ("logits", "step logits", "S", "x_tmix", "x_cmix")
    pad = {k: rel("padded", k) for k in keys}
    ref = {k: rel("reference's padded", k) for k in keys[1:]}
    mixed = (f"a chunk of {L % 64} live and {64 - L % 64} pad rows"
             if L % 64 else "whole pad chunks")
    print(f"[{tag}] {dt}: {L} tokens padded to {bucket} ({mixed}) against "
          f"unpadded, of each one's largest entry: "
          + ", ".join(f"{k} {v:.2e}" for k, v in pad.items())
          + "; the reference's padded prefill: "
          + ", ".join(f"{k} {v:.2e}" for k, v in ref.items())
          + f" (bar {bar})", flush=True)
    require(all(v <= bar for v in pad.values()),
            f"{tag}: {dt}, {L} tokens, the padded prefill against the "
            f"unpadded one {pad}, over {bar}")
    require(ref["S"] > bar and ref["step logits"] > bar,
            f"{tag}: {dt}, {L} tokens, the reference's padded prefill is "
            f"within the bar {bar} ({ref}): the check cannot see S10")


def hybrid_serve(torch, np, dev, arch, slot_lens, zero, read, gb, mark):
    """Phase 18a/b for one arch at full width and depth, from bf16
    weights drawn on the card: ``generate`` on 2 prompts of
    ``SERVE_PROMPT`` (rwkv6-3b's prefill through the WKV kernel, once a
    layer; recurrentgemma-9b's local layers through the band at head dim
    256, once each), ``SlotEngine`` on requests of ``slot_lens`` tokens,
    each completion token for token against ``generate`` on its prompt
    alone (unpadded), the peak memory -> (the runs' launches, the bundle
    and weights for the caller's profile)."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.models.attention import Q_BLOCK
    from repro_torch.kernels.rwkv6_scan.ref import CHUNK
    from repro_torch.models.common import tree_leaves
    from repro_torch.serve.engine import Request, SlotEngine, generate

    cfg = get_config(arch)
    b = build_model(cfg)
    tag = "18a" if arch == "recurrentgemma-9b" else "18b"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    params = b.init_params(torch.Generator(device=dev).manual_seed(0), dev,
                           dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_par = sum(l.numel() for l in tree_leaves(params))
    w_gb = sum(l.numel() * l.element_size()
               for l in tree_leaves(params)) / 1e9
    kinds = cfg.layer_kinds()
    print(f"[{tag}] {arch} at full width and depth ({len(kinds)} layers: "
          + ", ".join(f"{kinds.count(k)} {k}" for k in sorted(set(kinds)))
          + f"; d_model {cfg.d_model}, vocab {cfg.vocab_size}): {n_par:,} "
          f"params ({cfg.n_params():,} by the reference's formula), "
          f"{w_gb:.2f} GB of bf16 serving weights drawn on the card in "
          f"{init_s:.1f} s", flush=True)
    prompts = torch.randint(0, cfg.vocab_size, (2, SERVE_PROMPT),
                            dtype=torch.int32, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    zero()
    toks, st = generate(b, params, prompts, SERVE_NEW)
    torch.cuda.synchronize()
    n_gen = read()
    per_step = st.decode_s * 1e3 / max(st.decode_steps, 1)
    print(f"[{tag}] generate 2 x {SERVE_PROMPT} -> {tuple(toks.shape)}: "
          f"prefill {st.prefill_s * 1e3:.1f} ms, decode "
          f"{st.decode_s * 1e3:.1f} ms / {st.decode_steps} steps "
          f"({per_step:.2f} ms a step, {st.tokens_per_s:.1f} live tok/s); "
          f"launches {n_gen}", flush=True)
    if arch == "recurrentgemma-9b":
        kernel, want = "swa_attn", kinds.count("local")
    else:
        kernel, want = "rwkv6_wkv", len(kinds)
    per_prefill = want
    require(n_gen[kernel] == want and sum(n_gen.values()) == want,
            f"{tag}: generate launched {n_gen}, not {kernel} {want} times "
            f"(once a {'local' if kernel == 'swa_attn' else 'time-mix'} "
            f"layer)")
    require(toks.shape == (2, SERVE_NEW) and bool((toks >= 0).all())
            and bool((toks < cfg.vocab_size).all()), f"{tag}: tokens")
    rng = np.random.default_rng(3)
    reqs = [Request(uid=i, inputs={"tokens": rng.integers(
        0, cfg.vocab_size, (L,)).astype(np.int32)},
        max_new_tokens=HYBRID_NEW) for i, L in enumerate(slot_lens)]
    zero()
    eng = SlotEngine(b, params, n_slots=HYBRID_SLOTS,
                     max_new_tokens=HYBRID_NEW,
                     max_prompt_len=max(slot_lens))
    torch.cuda.synchronize()
    t0 = time.time()
    comps = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    n_slot = read()
    got = {c.uid: list(c.tokens) for c in comps}
    zero()
    same, against = [], []
    for r in reqs:
        toks = r.inputs["tokens"]
        L = toks.shape[0]
        if eng.exact_lengths or L % CHUNK == 0:
            p = torch.from_numpy(toks).to(dev)[None]
            want_toks, _ = generate(b, params, p, HYBRID_NEW)
            want_toks, how = want_toks[0].tolist(), "generate (unpadded)"
        else:
            want_toks = padded_greedy(torch, b, params, toks,
                                      eng.bucket_for(r), HYBRID_NEW, dev)
            how = "the padded prefill and greedy decode"
        same.append(got[r.uid] == want_toks)
        against.append(how)
    if not eng.exact_lengths:
        for r in reqs:
            padded_against_unpadded(torch, b, params, r.inputs["tokens"],
                                    eng.bucket_for(r), dev, tag)
        # the same pad handling at fp32, where the two paths' roundings
        # differ by summation order only
        b32 = build_model(dataclasses.replace(cfg, compute_dtype="float32"))
        p32 = b32.init_params(torch.Generator(device=dev).manual_seed(0),
                              dev)
        for r in reqs:
            if r.inputs["tokens"].shape[0] % CHUNK:
                padded_against_unpadded(torch, b32, p32, r.inputs["tokens"],
                                        eng.bucket_for(r), dev, tag)
        del b32, p32
    torch.cuda.synchronize()
    peak = gb()
    buckets = sorted({eng.bucket_for(r) for r in reqs})
    print(f"[{tag}] SlotEngine, {HYBRID_SLOTS} slots, {len(reqs)} requests "
          f"of {list(slot_lens)} tokens ("
          f"{'exact lengths' if eng.exact_lengths else f'buckets {buckets}'}"
          f"), {HYBRID_NEW} new each: {wall:.2f} s, {len(comps) / wall:.2f} "
          f"req/s, {eng.n_decode_dispatches} decode dispatches; launches "
          f"{n_slot}; each completion token for token against "
          f"{list(zip(against, same))}; peak device memory "
          f"{peak:.2f} GB (torch.cuda.max_memory_allocated; weights "
          f"{w_gb:.2f} GB)", flush=True)
    require(len(comps) == len(reqs) and all(same),
            f"{tag}: the slot engine's completions differ from "
            f"{list(zip(against, same))}")
    # a slot prefill takes the band past window + Q_BLOCK tokens; the
    # time mix takes the WKV kernel in every bucket (S % 64 == 0, >= 128)
    n_prefills = (sum(L > cfg.window + Q_BLOCK for L in slot_lens)
                  if kernel == "swa_attn" else len(reqs))
    want = n_prefills * per_prefill
    require(n_slot[kernel] == want and sum(n_slot.values()) == want,
            f"{tag}: the slot prefills launched {n_slot}, not {kernel} "
            f"{want} times")
    del eng, comps, toks, prompts
    mark(f"{tag} {arch} served at full width and depth")
    return n_gen[kernel] + n_slot[kernel], b, params


def hybrid_phase(torch, np, dev, mark):
    """Phase 18: recurrent-state serving and the hybrid family.  (a)
    ``recurrentgemma-9b`` and (b) ``rwkv6-3b`` at full width and depth
    served from bf16 weights drawn on the card (``hybrid_serve``), one
    ``recurrentgemma-9b`` prefill profiled (e); (c) ``recurrentgemma-9b``
    at full width and ``RG_TRAIN_LAYERS`` layers trained 2 epochs at S
    ``RG_TRAIN_SEQ``, past the band's start (its backward at head dim
    256, group remat), on the scan engine with resident rounds, twice
    with one seed (bitwise equal), then resident stage A against the
    host's (P7), one step profiled (e).  -> {path: {kernel: launches}}."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PGMConfig, TrainConfig
    from repro_torch.core.lastlayer import make_proj_for
    from repro_torch.launch.train import make_units_for
    from repro_torch.models.api import build_model
    from repro_torch.train.engine import make_step_core, to_device
    from repro_torch.train.optim import make_update_for

    zero, read = launch_counters()

    out = {}
    gb = lambda: torch.cuda.max_memory_allocated() / 1e9

    # (a) recurrentgemma-9b at full width and depth, its prefill profiled
    n, b, params = hybrid_serve(torch, np, dev, "recurrentgemma-9b",
                                RG_SLOT_LENS, zero, read, gb, mark)
    out["serve-recurrentgemma-9b"] = {"swa_attn": n}
    prompts = torch.randint(0, b.cfg.vocab_size, (2, SERVE_PROMPT),
                            dtype=torch.int32, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(5))
    with torch.no_grad():
        rglru_profile(torch, lambda: b.prefill(params, {"tokens": prompts}),
                      "18e", f"recurrentgemma-9b prefill of 2 x "
                      f"{SERVE_PROMPT} tokens, bf16 serving weights, full "
                      f"depth")
    del b, params, prompts
    gc.collect()
    torch.cuda.empty_cache()
    mark("18e recurrentgemma-9b prefill profiled")

    # (b) rwkv6-3b at full width and depth
    n, b, params = hybrid_serve(torch, np, dev, "rwkv6-3b", RWKV_SLOT_LENS,
                                zero, read, gb, mark)
    out["serve-rwkv6-3b"] = {"rwkv6_wkv": n}
    del b, params
    gc.collect()
    torch.cuda.empty_cache()

    # (c) recurrentgemma-9b trained at full width, one group of layers
    arch = "recurrentgemma-9b"
    c = dataclasses.replace(get_config(arch), n_layers=RG_TRAIN_LAYERS)
    bd = build_model(c)
    pc = PGMConfig(subset_fraction=0.5, n_partitions=4, select_every=1,
                   warm_start_epochs=1, val_matching=True)
    tc = TrainConfig(lr=0.05, optimizer="sgd", epochs=2, seed=0, pgm=pc)
    us_np, vs_np = make_units_for(c, n=RG_TRAIN_N, seq=RG_TRAIN_SEQ,
                                  noise=0.0, unit_size=RG_TRAIN_UNIT)
    vs_np = {k: v[:RG_VAL_UNITS] for k, v in vs_np.items()}
    require(RG_TRAIN_SEQ > c.window + 1024, "18c: S does not reach the band")
    params, n_run = train_twice(torch, np, bd, us_np, vs_np, tc, dev, "18c",
                                f", S {RG_TRAIN_SEQ} through the band, remat",
                                zero, read, gb,
                                ("grad_sketch", "omp_gram", "swa_attn",
                                 "swa_attn_bwd"))
    us, vs = to_device(us_np, dev), to_device(vs_np, dev)
    proj = make_proj_for(bd, torch.Generator().manual_seed(0),
                         pc.sketch_dim_h, pc.sketch_dim_v, dev)
    sel, _, err, same, bitwise, counted = resident_against_host(
        torch, bd, pc, params, us, vs, proj, read)
    print(f"[18c] {arch}: resident stage A against host units_gradients on "
          f"the trained params: max err {err:.2e} of the largest entry "
          f"(1e-5); same subsets and weights (1e-4): {same}; two replays "
          f"bitwise equal: {bitwise}; launches counted at the warm-ups and "
          f"captures {counted}", flush=True)
    require(err <= 1e-5 and same and bitwise,
            "18c: resident stage A disagrees with the host's")
    del sel, us, vs, proj
    gc.collect()
    torch.cuda.empty_cache()
    # (e) one step profiled, the scan's share of its device time
    step = make_step_core(bd, tc)
    opt_state = make_update_for(tc)[0](params)
    batch = to_device({k: v[0] for k, v in us_np.items()}, dev)
    rglru_profile(torch, lambda: step(params, opt_state, batch, tc.lr),
                  "18e", f"{arch} ({RG_TRAIN_LAYERS} layers) one training "
                  f"step (B={RG_TRAIN_UNIT} x {RG_TRAIN_SEQ}), eager")
    out[f"{arch}-resident"] = {k: n_run[k] for k in (
        "grad_sketch", "omp_gram", "swa_attn", "swa_attn_bwd")}
    del params, opt_state, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    mark(f"18c {arch} trained at full width, {RG_TRAIN_LAYERS} layers")
    return out




def stack_units(bundle, gen, n_units: int, S: int):
    """``n_units`` of the bundle's ``make_batch`` draws of ``UNIT_SIZE``
    examples at ``S`` (from the host generator ``gen``), stacked into
    units as numpy arrays (the leaves' leading axis)."""
    import numpy as np

    draws = [bundle.make_batch(gen, UNIT_SIZE, S) for _ in range(n_units)]
    return {k: np.stack([d[k].numpy() for d in draws]) for k in draws[0]}


class cpu_side:
    """``fn(*args)``, a function of this module, run on the CPU in a
    spawned process from the moment this is made, while the card works
    through other phases; ``result()`` waits for its value and ends the
    process.  The CPU sides of the card-against-CPU checks take tens of
    seconds and the card's phases leave the host's cores idle."""

    def __init__(self, fn, *args):
        import concurrent.futures
        import multiprocessing
        self.pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"))
        self.future = self.pool.submit(fn, *args)

    def result(self):
        try:
            return self.future.result()
        finally:
            self.pool.shutdown(wait=True)


def cpu_torch():
    """torch in a ``cpu_side`` process: the port's sources on the path,
    all but two of the host's cores for intra-op threads."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
    return torch


def rwkv_agree_setup(torch):
    """Phase 4's rwkv6-3b unit: the 1-layer fp32 bundle, its params and
    projections drawn on the CPU from one seed, and one unit."""
    from repro_torch.configs import get_config
    from repro_torch.core.sketch import make_projections
    from repro_torch.launch.train import make_units_for
    from repro_torch.models.api import build_model

    rw_cfg = get_config("rwkv6-3b")
    rw2 = build_model(dataclasses.replace(rw_cfg, n_layers=AGREE_LAYERS,
                                          compute_dtype="float32"))
    rw_units, _ = make_units_for(rw_cfg, n=LM_N, seq=LM_SEQ, noise=0.0)
    gen = torch.Generator().manual_seed(0)
    p_cpu = rw2.init_params(gen, torch.device("cpu"))
    proj_cpu = make_projections(gen, rw_cfg.d_model, rw_cfg.vocab_size)
    unit = {k: torch.as_tensor(v[:1]) for k, v in rw_units.items()}
    return rw2, p_cpu, proj_cpu, unit


def rwkv_agree_side(torch, rw2, p_cpu, proj_cpu, unit, on, check=None):
    """One side of phase 4's RWKV unit on device ``on``: the per-example
    loss and its mean's gradient in one pass, the layer-0 time-mix
    gradients, the stage-A sketch -> (loss, sketch, {leaf: grad},
    seconds), all on the CPU; ``check(held)`` is called around stage A
    on the card."""
    from repro_torch.core.lastlayer import units_gradients
    from repro_torch.models.common import tree_map

    p = tree_map(lambda x: x.detach().to(on).requires_grad_(True), p_cpu)
    pr = type(proj_cpu)(*(x.to(on) for x in proj_cpu))
    u = {k: v.to(on) for k, v in unit.items()}
    t_a = time.time()
    # the weighted loss with unit weights
    loss = rw2.per_example_loss(p, {k: v[0] for k, v in u.items()})
    loss.mean().backward()
    tm = p["stack"]["groups"][0]["tmix"]
    grads = {k: v.grad[0].cpu() for k, v in tm.items()}
    held = check() if check else None
    sk = units_gradients(rw2, p, u, pr)
    if check:
        check(held)
    return loss.detach().cpu(), sk.cpu(), grads, time.time() - t_a


def rwkv_agree_cpu():
    """Phase 4's RWKV unit through the plain versions (a ``cpu_side``)."""
    torch = cpu_torch()
    rw2, p_cpu, proj_cpu, unit = rwkv_agree_setup(torch)
    return rwkv_agree_side(torch, rw2, p_cpu, proj_cpu, unit,
                           torch.device("cpu"))


def long_agree_setup(torch):
    """20d: starcoder2-3b at full width with one layer in fp32, its params
    drawn on the CPU from one seed, and one example of ``LONG_AGREE_S``
    tokens with weight 1 (so the weighted loss is its per-example
    loss)."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model

    cfg = get_config("starcoder2-3b")
    b1 = build_model(dataclasses.replace(cfg, n_layers=1,
                                         compute_dtype="float32"))
    p_cpu = b1.init_params(torch.Generator().manual_seed(0),
                           torch.device("cpu"))
    toks = torch.randint(0, cfg.vocab_size, (1, LONG_AGREE_S),
                         dtype=torch.int32,
                         generator=torch.Generator().manual_seed(4))
    return b1, p_cpu, {"tokens": toks, "weights": torch.ones((1,))}


def long_agree_side(torch, b1, p_cpu, batch, on):
    """One side of 20d on device ``on`` -> (per-example loss, every
    gradient leaf, seconds), on the CPU."""
    from repro_torch.models.common import tree_leaves, tree_map

    t_a = time.time()
    live = tree_map(lambda x: x.detach().to(on).requires_grad_(True), p_cpu)
    total, metrics = b1.loss_fn(live, {k: v.to(on) for k, v in batch.items()})
    grads = torch.autograd.grad(total, tree_leaves(live))
    return (metrics["loss"].detach().reshape(1).cpu(),
            [g.cpu() for g in grads], time.time() - t_a)


def long_agree_cpu(path: str) -> str:
    """20d's CPU side (a ``cpu_side``), saved to ``path``."""
    torch = cpu_torch()
    b1, p_cpu, batch = long_agree_setup(torch)
    torch.save(long_agree_side(torch, b1, p_cpu, batch, torch.device("cpu")),
               path)
    return path


def swa_bwd_inputs(torch, shape, dev):
    """The band's inputs at ``shape`` and a cotangent of its output, on
    the card -> (q, k, v, dout, lengths)."""
    B, S, KV, G, hd, W, dtype, lengths = shape
    (q, k, v), lens = swa_inputs(torch, B, S, KV, G, hd, dtype, lengths,
                                 seed=S + hd + 1, dev=dev)
    g = torch.Generator(device=dev).manual_seed(S + W)
    dout = torch.randn(q.shape, generator=g, device=dev).to(q.dtype)
    return q, k, v, dout, lens


def swa_bwd_err(torch, shape, dev):
    """The band's backward kernel at one shape, on the same card tensors:
    the forward that writes lse bitwise the serving forward's output, two
    backward launches bitwise equal, and the kernel against the plain
    backward (``swa_attn_bwd_ref``, from the kernel's out and lse) and
    against autograd of the plain forward.  Both the kernel and the plain
    backward sum in fp32 and differ in the order of their sums, whose
    rounding scales with the terms summed: at fp32 each gradient is held
    to 1e-5 of the largest entry of the three, at bf16 (both round their
    fp32 sums to bf16) each element to one bf16 ulp of its own value plus
    1e-5 of that entry (at window 1, dq is zero but for that rounding).
    Against autograd, which reads D through the softmax's fp32 output
    where the kernel reads the forward's rounded output, the LM tests'
    bars: fp32 1e-5 of the largest entry of the three, bf16 2e-2
    relative in norm (a norm floored at 1e-3 of the largest of the
    three) -> (max abs err against the
    plain backward, the largest share of its bar an element takes, the
    largest error against autograd on its bar's scale)."""
    from repro_torch.kernels.swa_attn.ops import (_launch, swa_attn_bwd,
                                                  swa_attn_op)
    from repro_torch.kernels.swa_attn.ref import (swa_attn_bwd_ref,
                                                  swa_attn_ref)

    B, S, KV, G, hd, W, dtype, lengths = shape
    q, k, v, dout, lens = swa_bwd_inputs(torch, shape, dev)
    with torch.no_grad():
        serve = swa_attn_op(q, k, v, window=W, lengths=lens)
    out, lse = _launch(q, k, v, lens, W, with_lse=True)
    require(bool(torch.equal(out, serve)),
            f"swa_attn {shape}: the forward with lse differs from the "
            f"serving forward")
    require(bool(torch.isfinite(lse).all()),
            f"swa_attn {shape}: non-finite lse")
    got = swa_attn_bwd(q, k, v, out, lse, dout, W, lens)
    again = swa_attn_bwd(q, k, v, out, lse, dout, W, lens)
    torch.cuda.synchronize()
    require(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
            f"swa_attn_bwd {shape}: two launches on the same inputs differ")
    del again
    want = swa_attn_bwd_ref(q, k, v, out, lse, dout, window=W, lengths=lens)
    # the sums' rounding noise scales with the terms they add, which the
    # largest entry of the three gradients measures (at window 1 dq is
    # zero but for that noise)
    top = max(float(b.abs().max()) for b in want)
    err = margin = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = a.float(), b.float()
        diff = (a - b).abs()
        bar = (1e-5 * top if dtype == "float32"
               else 2.0 ** -7 * b.abs() + 1e-5 * top)
        m = float((diff / bar).max())
        require(bool(torch.isfinite(a).all()) and m <= 1.0,
                f"swa_attn_bwd {shape}: {name} element at {m:.2f} x its bar "
                f"from the plain backward")
        err, margin = max(err, float(diff.max())), max(margin, m)
    del want
    xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    with torch.enable_grad():
        auto = torch.autograd.grad(swa_attn_ref(*xs, window=W, lengths=lens),
                                   xs, dout)
    auto_err = 0.0
    tops = [float(b.float().abs().max()) for b in auto]
    norms = [float(b.float().norm()) for b in auto]
    for name, a, b, top, nb in zip(("dq", "dk", "dv"), got, auto, tops,
                                   norms):
        a, b = a.float(), b.float()
        if dtype == "float32":
            e = float((a - b).abs().max()) / max(tops)
            ok = e <= 1e-5
        else:
            e = float((a - b).norm()) / max(nb, 1e-3 * max(norms))
            ok = e < 2e-2
        require(ok, f"swa_attn_bwd {shape}: {name} {e:.2e} from autograd of "
                    f"the plain forward")
        auto_err = max(auto_err, e)
    return err, margin, auto_err


def swa_bwd_timed(torch, shape, dev):
    """The backward kernel at one training shape timed (CUDA events) in
    turns with PyTorch's SDPA backward under the band mask (the library
    yardstick: k and v repeated over the group, a boolean band mask), the
    plain backward once, the forward with and without lse, and its bound
    (10 hd FLOP a (query, key) pair and query head at the inputs' peak;
    q, k, v, out, dout and lse read once, dq, dk, dv written once); and
    the forward that writes lse at the same shape: held to the plain
    forward (``swa_err``), timed with its plain version and SDPA's
    forward, its bound (4 hd FLOP a pair and head; q, k, v read, out and
    lse written) -> {ms, plain_ms, library_ms, bound_ms, bound_by, fwd_ms,
    fwd_lse_ms, fwd_max_abs_err, fwd_plain_ms, fwd_library_ms,
    fwd_bound_ms, fwd_bound_by}."""
    from repro_torch.kernels.swa_attn.ops import (_launch, swa_attn_bwd,
                                                  swa_attn_op)
    from repro_torch.kernels.swa_attn.ref import (swa_attn_bwd_ref,
                                                  swa_attn_fwd_ref,
                                                  swa_attn_ref)

    B, S, KV, G, hd, W, dtype, _ = shape
    q, k, v, dout, _ = swa_bwd_inputs(torch, shape, dev)
    out, lse = _launch(q, k, v, None, W, with_lse=True)
    fwd = cuda_ms(torch, lambda: _launch(q, k, v, None, W), reps=5)
    fwd_lse = cuda_ms(torch, lambda: _launch(q, k, v, None, W,
                                             with_lse=True), reps=5)
    H = KV * G
    qh = q.reshape(B, S, H, hd).transpose(1, 2).contiguous() \
        .requires_grad_(True)
    kh, vh = (x.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
              .requires_grad_(True) for x in (k, v))
    doh = dout.reshape(B, S, H, hd).transpose(1, 2).contiguous()
    pos = torch.arange(S, device=dev)
    band = ((pos[:, None] - pos[None, :]) >= 0) \
        & ((pos[:, None] - pos[None, :]) < W)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        fwd_lib = cuda_ms(torch, lambda: sdpa(qh, kh, vh, attn_mask=band),
                          reps=3, warmup=1)
        fwd_plain = cuda_ms(torch, lambda: swa_attn_fwd_ref(q, k, v,
                                                            window=W),
                            reps=1, warmup=1)
    with torch.enable_grad():
        lib_out = sdpa(qh, kh, vh, attn_mask=band)
    runs, lib_runs = [], []
    for _ in range(2):
        runs.append(cuda_ms(torch, lambda: swa_attn_bwd(
            q, k, v, out, lse, dout, W), reps=3, warmup=1))
        lib_runs.append(cuda_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qh, kh, vh), doh, retain_graph=True), reps=3,
            warmup=1))
    plain = cuda_ms(torch, lambda: swa_attn_bwd_ref(
        q, k, v, out, lse, dout, window=W), reps=1, warmup=1)
    del lib_out, qh, kh, vh, doh, band
    ms, lib = sum(runs) / 2, sum(lib_runs) / 2
    esz = q.element_size()
    n_ops = 10 * hd * band_pairs(S, W) * H * B
    peak = FP32_FLOP_PER_S if dtype == "float32" else BF16_FLOP_PER_S
    b_ms, b_by = bound(esz * (4 * q.numel() + 2 * k.numel() + 2 * v.numel())
                       + 4 * lse.numel(), n_ops, peak)
    f_ms, f_by = bound(esz * (2 * q.numel() + k.numel() + v.numel())
                       + 4 * lse.numel(), 4 * hd * band_pairs(S, W) * H * B,
                       peak)
    del q, k, v, dout, out, lse
    f_err, f_margin = swa_err(torch, swa_attn_op, swa_attn_ref, shape, dev)
    print(f"[kernels] swa_attn (the forward with lse) {shape[:6]} {dtype}: "
          f"max_abs_err {f_err:.3e} ({f_margin:.3f} of the one-ulp bar) "
          f"kernel_ms {fwd_lse:.4f} (without lse {fwd:.4f}) plain_ms "
          f"{fwd_plain:.4f} library_ms (scaled_dot_product_attention, band "
          f"mask) {fwd_lib:.4f} bound_ms {f_ms:.4f} ({f_by})", flush=True)
    print(f"[kernels] swa_attn_bwd {shape[:6]} {dtype}: kernel_ms {ms:.4f} "
          f"({runs[0]:.4f}, {runs[1]:.4f}) plain_ms {plain:.4f} library_ms "
          f"(scaled_dot_product_attention backward, band mask) {lib:.4f} "
          f"({lib_runs[0]:.4f}, {lib_runs[1]:.4f}); kernel / library "
          f"{ms / lib:.3f}; bound_ms {b_ms:.4f} ({b_by}, {n_ops / 1e9:.1f} "
          f"GFLOP at the {dtype} peak; {n_ops / FP32_FLOP_PER_S * 1e3:.3f} "
          f"ms at the fp32 peak) achieved {n_ops / ms / 1e9:.2f} TFLOP/s; "
          f"the forward {fwd:.4f} ms, with lse {fwd_lse:.4f} ms",
          flush=True)
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, fwd_ms=fwd, fwd_lse_ms=fwd_lse,
                fwd_max_abs_err=f_err, fwd_plain_ms=fwd_plain,
                fwd_library_ms=fwd_lib, fwd_bound_ms=f_ms, fwd_bound_by=f_by)


def long_kernel_rows(torch, dev):
    """Phase 3 for the band's backward (phase 20, 18c): the edge shapes of
    both forward bodies (``SWA_EDGES``, ``SWA_RG_EDGES``), then the
    training shapes (``SWA_BWD_TRAIN``), each held by ``swa_bwd_err``;
    the training shapes timed (``swa_bwd_timed``); the grad sketch at
    phase 20's stage-A unit (``SKETCH_LONG``) -> {"swa_attn_bwd": {arch:
    row}, "grad_sketch": row}, a row {max_abs_err, ms, plain_ms,
    library_ms, bound_ms, bound_by}."""
    from repro_torch.kernels.grad_sketch.ops import grad_sketch_units_op
    from repro_torch.kernels.grad_sketch.ref import grad_sketch_units_ref

    worst = [0.0, 0.0, 0.0]
    for shape in SWA_EDGES + SWA_RG_EDGES:
        got = swa_bwd_err(torch, shape, dev)
        worst = [max(a, b) for a, b in zip(worst, got)]
    print(f"[kernels] swa_attn_bwd at the {len(SWA_EDGES + SWA_RG_EDGES)} "
          f"edge shapes of SWA_EDGES and SWA_RG_EDGES: max abs err "
          f"{worst[0]:.3e}, {worst[1]:.3f} of the bar at most, "
          f"{worst[2]:.2e} from autograd of the plain forward at most; the "
          f"forward with lse bitwise the serving forward, two backward "
          f"launches bitwise equal", flush=True)
    out = {"swa_attn_bwd": {}}
    for arch, shape in SWA_BWD_TRAIN:
        err, margin, auto = swa_bwd_err(torch, shape, dev)
        print(f"[kernels] swa_attn_bwd {shape} ({arch}): max abs err "
              f"{err:.3e}, {margin:.3f} of the bar at most, {auto:.2e} "
              f"from autograd of the plain forward; forward with lse "
              f"bitwise the serving forward, two launches bitwise equal",
              flush=True)
        torch.cuda.empty_cache()
        out["swa_attn_bwd"][arch] = dict(max_abs_err=err,
                                         **swa_bwd_timed(torch, shape, dev))
    e, k_ms, p_ms, b_ms, b_by = sketch_row(
        torch, grad_sketch_units_op, grad_sketch_units_ref, SKETCH_LONG, 40,
        dev, "starcoder2-3b at S 8,192", on_card=True)
    out["grad_sketch"] = dict(max_abs_err=e, ms=k_ms, plain_ms=p_ms,
                              library_ms=None, bound_ms=b_ms, bound_by=b_by)
    torch.cuda.empty_cache()
    return out


def family_kernel_rows(torch, dev):
    """Phase 3 at the shapes phase 19 gives the kernels: the grad sketch
    at the stage-A units of seamless-m4t-medium and paligemma-3b (tied
    heads, V 256,206 and 257,216: vocab tails of 78 and 64 columns past
    the 128-wide tile), twice bitwise and timed in turns with its plain
    version -> {arch: row}, a row {max_abs_err, ms, plain_ms, library_ms,
    bound_ms, bound_by}."""
    from repro_torch.kernels.grad_sketch.ops import grad_sketch_units_op
    from repro_torch.kernels.grad_sketch.ref import grad_sketch_units_ref

    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")
    out = {}
    for i, (arch, shape) in enumerate(SKETCH_FAMILY.items()):
        e, k_ms, p_ms, b_ms, b_by = sketch_row(
            torch, grad_sketch_units_op, grad_sketch_units_ref, shape,
            40 + i, dev, arch, on_card=True)
        out[arch] = dict(zip(keys, (e, k_ms, p_ms, None, b_ms, b_by)))
        torch.cuda.empty_cache()
    return out


def family_serve(torch, bd, params, dev, zero, read, gb):
    """Phase 19c: the trained model served from its ``serving_params``
    (bf16, greedy): ``generate`` on ``UNIT_SIZE`` requests of
    ``FAMILY_SERVE[family]`` (frames and prompt tokens, or patches and
    prompt tokens), ``FAMILY_NEW`` new tokens; no counted kernel (no
    band layer), the tokens in the vocab, the peak memory."""
    from repro_torch.serve.engine import generate

    cfg = bd.cfg
    n_src, n_prompt = FAMILY_SERVE[cfg.family]
    g = torch.Generator(device=dev).manual_seed(5)
    key = "frames" if cfg.family == "encdec" else "patches"
    extra = {key: torch.randn((UNIT_SIZE, n_src, cfg.d_model), generator=g,
                              device=dev)}
    prompts = torch.randint(0, cfg.vocab_size, (UNIT_SIZE, n_prompt),
                            dtype=torch.int32, device=dev, generator=g)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero()
    torch.cuda.synchronize()
    toks, st = generate(bd, params, prompts, FAMILY_NEW, extra_inputs=extra)
    torch.cuda.synchronize()
    n = read()
    per_step = st.decode_s * 1e3 / max(st.decode_steps, 1)
    print(f"[19c] {cfg.name} served from its serving_params (bf16, "
          f"greedy): {UNIT_SIZE} requests of {n_src} {key} + {n_prompt} "
          f"prompt tokens -> {tuple(toks.shape)}: prefill "
          f"{st.prefill_s * 1e3:.1f} ms, decode {st.decode_s * 1e3:.1f} ms "
          f"/ {st.decode_steps} steps ({per_step:.2f} ms a step, "
          f"{st.tokens_per_s:.1f} live tok/s); launches {n}; peak device "
          f"memory {gb():.2f} GB", flush=True)
    require(toks.shape == (UNIT_SIZE, FAMILY_NEW)
            and st.decode_steps == FAMILY_NEW - 1
            and bool((toks >= 0).all())
            and bool((toks < cfg.vocab_size).all()),
            f"19c: {cfg.name} generated {tuple(toks.shape)} tokens")
    require(not any(n.values()), f"19c: serving launched {n}")


def s11_check(torch, cfg, params, dev):
    """Phase 19d, ROADMAP S11 at full width and depth in fp32 (TF32 off):
    one paligemma-3b decode step after a prefill of ``n_prefix`` patches
    and ``S11_PROMPT`` tokens, its cache sized ``n_prefix + Sp + new``
    (the port's ``generate``) and ``Sp + new`` (the reference's), each
    against the last logits of a full forward over the same tokens: the
    first within 1e-3 of its largest entry, the second (a ring that has
    dropped the first patches) not.  The step reads ``params`` with the
    tied embedding scaled by 1/sqrt(d), so that a scaled text embedding
    has unit entries like the patches and the attention's outputs: at
    the reference's init (entries of sqrt(d) N(0, 1)) a token's own
    embedding is ~45x an attention output in the residual stream and its
    self logit leads every step, and dropping 224 patches moved the step
    by 3.2e-4-7.0e-4 of the largest entry (on an H100 80GB HBM3 at 700
    W), under the bar."""
    from repro_torch.models.api import build_model

    b32 = build_model(dataclasses.replace(cfg, compute_dtype="float32"))
    params = dict(params, embed={"w": params["embed"]["w"]
                                 / math.sqrt(cfg.d_model)})
    g = torch.Generator(device=dev).manual_seed(6)
    P, Sp = cfg.n_prefix, S11_PROMPT
    batch = {"patches": torch.randn((1, P, cfg.d_model), generator=g,
                                    device=dev),
             "tokens": torch.randint(0, cfg.vocab_size, (1, Sp),
                                     dtype=torch.int32, device=dev,
                                     generator=g)}
    steps, tok = {}, None
    t0 = time.time()
    with torch.no_grad():
        for name, L in (("held", P + Sp + FAMILY_NEW),
                        ("reference", Sp + FAMILY_NEW)):
            logits, cache = b32.prefill(params, batch, cache_len=L)
            if tok is None:
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
            steps[name] = b32.decode(params, cache, tok)[0].float()
            del cache
        full, _ = b32.prefill(params, dict(
            batch, tokens=torch.cat([batch["tokens"], tok[:, None]], 1)))
    torch.cuda.synchronize()
    scale = float(full.abs().max())
    err = {k: float((v - full).abs().max()) / scale
           for k, v in steps.items()}
    print(f"[19d] S11: paligemma-3b at full width and depth, fp32 (TF32 "
          f"off), {P} patches + {Sp} tokens, one decode step against a full "
          f"forward over the same {P + Sp + 1} positions (the tied "
          f"embedding scaled by 1/sqrt(d)): cache of "
          f"{P + Sp + FAMILY_NEW} (prefix held) {err['held']:.2e} of the "
          f"largest entry ({scale:.1f}), cache of {Sp + FAMILY_NEW} (the "
          f"reference's sizing, {P - FAMILY_NEW} of {P} patches dropped) "
          f"{err['reference']:.2e}; bar 1e-3 ({time.time() - t0:.1f} s)",
          flush=True)
    require(err["held"] <= 1e-3, "19d: the decode step with the prefix "
                                 "held misses the full forward")
    require(err["reference"] > 1e-3, "19d: the reference's cache sizing "
                                     "met the bar (S11 not shown)")


def family_agreement(torch, arch, dev):
    """Phase 19e: ``arch`` at full width with one layer (for the
    encoder-decoder one encoder and one decoder layer) in fp32, one
    example of ``FAMILY_AGREE_S`` from ``make_batch`` (256 frames or 256
    patches and 256 tokens), card kernels against the CPU's plain
    versions: per-example loss (1e-4), the stage-A sketch (1e-3 of its
    largest entry), then the prefill and ``FAMILY_AGREE_STEPS``
    teacher-forced decode steps (logits within 1e-4 of their largest
    entry, argmaxes equal where the CPU's top-2 margin exceeds 10x that
    bar): phase 4's bars."""
    from repro_torch.configs import get_config
    from repro_torch.core.lastlayer import units_gradients
    from repro_torch.core.sketch import make_projections
    from repro_torch.models.api import build_model
    from repro_torch.models.common import tree_map

    base = get_config(arch)
    cfg = dataclasses.replace(
        base, n_layers=1, n_enc_layers=1 if base.n_enc_layers else 0,
        compute_dtype="float32")
    bd = build_model(cfg)
    p_dev = bd.init_params(torch.Generator(device=dev).manual_seed(0), dev)
    p_cpu = tree_map(lambda x: x.cpu(), p_dev)
    batch = bd.make_batch(torch.Generator().manual_seed(1), 1,
                          FAMILY_AGREE_S)
    proj = make_projections(torch.Generator().manual_seed(2), cfg.d_model,
                            cfg.vocab_size)
    P = cfg.n_prefix if cfg.family == "vlm" else 0
    S = batch["tokens"].shape[1]
    runs, fed = {}, []
    for where, p in (("cpu", p_cpu), ("cuda", p_dev)):
        on = torch.device(where) if where == "cpu" else dev
        u = {k: v.to(on) for k, v in batch.items()}
        pr = type(proj)(*(x.to(on) for x in proj))
        t0 = time.time()
        with torch.no_grad():
            loss = bd.per_example_loss(p, u)
        sk = units_gradients(bd, p, {k: v[None] for k, v in u.items()}, pr)
        serve = {k: v for k, v in u.items() if k != "loss_mask"
                 and k != "weights"}
        with torch.no_grad():
            logits, cache = bd.prefill(
                p, serve, cache_len=P + S + FAMILY_AGREE_STEPS)
            steps = [logits.float().cpu()[0]]
            for i in range(FAMILY_AGREE_STEPS):
                if where == "cpu":
                    fed.append(int(torch.argmax(steps[-1])))
                tok = torch.tensor([fed[i]], dtype=torch.int32, device=on)
                logits, cache = bd.decode(p, cache, tok)
                steps.append(logits.float().cpu()[0])
        if where == "cuda":
            torch.cuda.synchronize()
        runs[where] = (loss.cpu(), sk.cpu(), steps, time.time() - t0)
        del cache
    (l_c, s_c, st_c, t_c), (l_g, s_g, st_g, t_g) = runs["cpu"], runs["cuda"]
    require(bool(torch.isfinite(l_g).all()) and bool(torch.isfinite(s_g)
                                                     .all()),
            f"19e {arch}: non-finite loss or sketch on the card")
    loss_rel = float(((l_g - l_c).abs() / l_c.abs()).max())
    sk_rel = float((s_g - s_c).abs().max() / s_c.abs().max())
    worst, held = 0.0, 0
    for i, (a, b) in enumerate(zip(st_g, st_c)):
        bar = 1e-4 * float(b.abs().max())
        e = float((a - b).abs().max())
        worst = max(worst, e / float(b.abs().max()))
        require(bool(torch.isfinite(a).all()) and e <= bar,
                f"19e {arch}: step {i} logits err {e} > {bar}")
        top2 = torch.topk(b, 2).values
        if float(top2[0] - top2[1]) > 10 * bar:
            require(int(torch.argmax(a)) == int(torch.argmax(b)),
                    f"19e {arch}: step {i} argmax differs")
            held += 1
    what = ("1 encoder + 1 decoder layer, 256 frames"
            if cfg.family == "encdec" else f"1 layer, {P} patches")
    print(f"[19e] {arch} at full width, {what} + {S} tokens, fp32: loss "
          f"rel err {loss_rel:.2e}, stage-A sketch err {sk_rel:.2e} of its "
          f"largest entry, prefill + {FAMILY_AGREE_STEPS} teacher-forced "
          f"decode steps' logits at most {worst:.2e} of their largest "
          f"entry, {held} of {FAMILY_AGREE_STEPS + 1} argmaxes held (the "
          f"rest within 10x the bar of a tie) (card {t_g:.1f} s vs CPU "
          f"{t_c:.1f} s)", flush=True)
    require(loss_rel < 1e-4 and sk_rel < 1e-3,
            f"19e {arch}: card and CPU disagree")


def family_phase(torch, np, dev, mark):
    """Phase 19: the encoder-decoder and VLM families at full width and
    depth.  (a) ``seamless-m4t-medium`` and (b) ``paligemma-3b`` trained 2
    epochs under PGM on the scan engine with resident rounds, on units of
    ``UNIT_SIZE`` stacked from ``make_batch`` (``frames`` / ``patches``
    resident beside the tokens), seamless twice with one seed (bitwise),
    then resident stage A against the host's on the trained params (P7);
    (c) each trained model served through ``generate``; (d) S11 on
    paligemma-3b; (e) card against CPU at one layer.  -> {path: {kernel:
    launches}}."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PGMConfig, TrainConfig
    from repro_torch.core.lastlayer import make_proj_for
    from repro_torch.models.api import build_model
    from repro_torch.train.engine import to_device

    zero, read = launch_counters()
    gb = lambda: torch.cuda.max_memory_allocated() / 1e9
    out = {}
    for arch, S, runs in FAMILY_TRAIN:
        cfg = get_config(arch)
        bd = build_model(cfg)
        tag = "19a" if cfg.family == "encdec" else "19b"
        gen = torch.Generator().manual_seed(0)
        us_np = stack_units(bd, gen, FAMILY_N_UNITS, S)
        vs_np = stack_units(bd, gen, FAMILY_N_VAL, S)
        pc = PGMConfig(subset_fraction=0.5, n_partitions=4, select_every=1,
                       warm_start_epochs=1, val_matching=True)
        tc = TrainConfig(lr=0.05, optimizer="sgd", epochs=2, seed=0, pgm=pc)
        extra = ", ".join(f"{k} {v.shape[2:]}" for k, v in us_np.items()
                          if k in ("frames", "patches"))
        params, n_run = train_twice(
            torch, np, bd, us_np, vs_np, tc, dev, tag, f" ({extra} a "
            f"example)", zero, read, gb, ("grad_sketch", "omp_gram"),
            runs=runs)
        us, vs = to_device(us_np, dev), to_device(vs_np, dev)
        proj = make_proj_for(bd, torch.Generator().manual_seed(0),
                             pc.sketch_dim_h, pc.sketch_dim_v, dev)
        sel, _, err, same, bitwise, counted = resident_against_host(
            torch, bd, pc, params, us, vs, proj, read)
        print(f"[{tag}] {arch}: resident stage A against host "
              f"units_gradients on the trained params: max err {err:.2e} "
              f"of the largest entry (1e-5); same subsets and weights "
              f"(1e-4): {same}; two replays bitwise equal: {bitwise}; "
              f"launches counted at the warm-ups and captures {counted}",
              flush=True)
        require(err <= 1e-5 and same and bitwise,
                f"{tag}: resident stage A disagrees with the host's")
        family = "encdec" if cfg.family == "encdec" else "vlm"
        out[f"{family}-resident"] = {"grad_sketch": n_run["grad_sketch"],
                                     "omp_gram": n_run["omp_gram"]}
        del sel, us, vs, proj, us_np, vs_np
        gc.collect()
        torch.cuda.empty_cache()
        mark(f"{tag} {arch} trained at full width and depth")
        family_serve(torch, bd, params, dev, zero, read, gb)
        if cfg.family == "vlm":
            s11_check(torch, cfg, params, dev)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        mark(f"19c-d {arch} served")
    for arch, _, _ in FAMILY_TRAIN:
        family_agreement(torch, arch, dev)
        gc.collect()
        torch.cuda.empty_cache()
    mark("19e card against CPU at one layer")
    return out


class engine_spy:
    """Within the block every ``EpochEngine`` that captures its step graph
    is kept in ``self.engines`` (with ``kept_graphs``, its graph's kernel
    nodes stay readable by ``graph_kernels``)."""

    def __init__(self, engine_cls):
        self.cls, self.engines = engine_cls, []

    def __enter__(self):
        orig, engines = self.cls._ensure_graph, self.engines
        self.orig = orig

        def ensure(eng):
            orig(eng)
            if eng._graph is not None and eng not in engines:
                engines.append(eng)
        self.cls._ensure_graph = ensure
        return self

    def __exit__(self, *exc):
        self.cls._ensure_graph = self.orig


#: the band's forward (bf16 wgmma body) and backward (one dk / dv kernel a
#: call) in a captured graph
BAND_MARKERS = {"swa_attn": "swa_attn_bf16_kernel",
                "swa_attn_bwd": "swa_bwd_dkdv"}


def long_phase(torch, np, dev, mark):
    """Phase 20: long-context training through the band.  (a)
    ``starcoder2-3b`` at full width and depth trained at S ``LONG_SEQ``
    under PGM with group remat on the scan engine with resident rounds
    (the warm start and one round): its peak memory, the band's forward
    and backward launches in the step graph's nodes x its replays (two
    forwards a local layer, the recompute, and one backward), one replayed
    step under the profiler; (b) the same at ``LONG_REPEAT_LAYERS``
    layers twice with one seed, bitwise, and resident stage A against
    the host's (P7); (c) one step at ``LM_RESIDENT_LAYERS`` layers with
    remat on and off:
    loss and every gradient leaf bitwise equal, the remat peak lower;
    (d) one layer at fp32 on one example of ``LONG_AGREE_S`` tokens
    (past the band's start), card against CPU, per-example loss and
    every gradient leaf at phase 4's bars.  -> {path: {kernel:
    launches}}, a kernel of the step graph as (counted at the warm-ups
    and the capture, nodes x replays)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PGMConfig, TrainConfig
    from repro_torch.core.lastlayer import make_proj_for
    from repro_torch.core.pgm import ResidentSelector
    from repro_torch.launch.train import make_units_for
    from repro_torch.models.api import build_model
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train.engine import EpochEngine, to_device
    from repro_torch.train.loop import train_with_selection

    zero, read = launch_counters()
    gb = lambda: torch.cuda.max_memory_allocated() / 1e9
    out = {}
    # (d)'s CPU side runs on the host while the card trains (a)-(c)
    scratch = ROOT / "build" / "chip_smoke"
    scratch.mkdir(parents=True, exist_ok=True)
    long_cpu = cpu_side(long_agree_cpu, str(scratch / "20d_cpu.pt"))
    arch = "starcoder2-3b"
    cfg = get_config(arch)
    require(LONG_SEQ > cfg.window + 1024 and LONG_AGREE_S > cfg.window + 1024,
            "phase 20: its sequences do not reach the band")
    pc = PGMConfig(subset_fraction=0.5, n_partitions=4, select_every=1,
                   warm_start_epochs=1, val_matching=True)
    tc = TrainConfig(lr=0.05, optimizer="sgd", epochs=2, seed=0, pgm=pc)
    us_np, vs_np = make_units_for(cfg, n=LONG_UNIT * LONG_TRAIN_UNITS,
                                  seq=LONG_SEQ, noise=0.0,
                                  unit_size=LONG_UNIT)
    vs_np = {k: v[:LONG_VAL_UNITS] for k, v in vs_np.items()}

    # (a) full width and depth
    bd = build_model(cfg)
    L = cfg.layer_kinds().count("local")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero()
    ResidentSelector.captures = ResidentSelector.replays = 0
    EpochEngine.captures = EpochEngine.replays = 0
    torch.cuda.synchronize()
    t0 = time.time()
    with kept_graphs(torch), engine_spy(EpochEngine) as spy:
        h = train_with_selection(
            bd, us_np, tc, method="pgm", val_units=vs_np, device="cuda",
            engine="scan", resident_selection=True,
            params=card_init(torch, bd, dev),
            log_fn=lambda m: print(f"[20a {arch} +{time.time() - t0:.1f}s] "
                                   f"{m}", flush=True))
    torch.cuda.synchronize()
    secs, peak = time.time() - t0, gb()
    counted = read()
    replays = EpochEngine.replays
    require(len(spy.engines) == 1, f"20a: {len(spy.engines)} step graphs")
    eng = spy.engines[0]
    nodes = graph_kernels(eng._graph, BAND_MARKERS)
    want = {"swa_attn": 2 * L, "swa_attn_bwd": L}
    ran = {n: v * replays for n, v in nodes.items()}
    steps = EpochEngine.WARMUP_STEPS + 1
    n_par = sum(x.numel() for x in tree_leaves(h.final_params))
    print(f"[20a] {arch} at full width and depth ({cfg.n_layers} layers, "
          f"{n_par:,} params), group remat, S {LONG_SEQ}: "
          f"{LONG_TRAIN_UNITS} units of {LONG_UNIT} x {LONG_SEQ} tokens, "
          f"{LONG_VAL_UNITS} validation units, 2 epochs, scan engine, "
          f"resident rounds: {secs:.1f} s ({h.wall_time:.1f} s after the "
          f"init); rounds {[round(x['seconds'], 3) for x in h.selections]} "
          f"s; stage-A captures {ResidentSelector.captures}; step captures "
          f"{EpochEngine.captures}, replays {replays}; losses train "
          f"{[round(x, 4) for x in h.train_loss]} val "
          f"{[round(x, 4) for x in h.val_loss]}; peak device memory "
          f"{peak:.2f} GB; the step graph's band nodes {nodes} (want "
          f"{want}: a forward, its recompute and a backward a local layer) "
          f"x {replays} replays = {ran}; launches counted (warm-ups, "
          f"captures, validation and stage-A forwards) {counted}",
          flush=True)
    require(nodes == want, f"20a: the step graph holds {nodes} band "
                           f"kernels, not {want}")
    require(len(h.selections) == 1 and len(h.train_loss) == 2
            and all(np.isfinite(h.train_loss + h.val_loss)),
            "20a: the run did not finish its round and epochs")
    require(counted["swa_attn_bwd"] == L * steps
            and counted["grad_sketch"] > 0 and counted["omp_gram"] > 0
            and counted["swa_attn"] > 0,
            f"20a: launches counted {counted}, not {L} x {steps} band "
            f"backwards in the warm-up steps and the capture, and the "
            f"selection kernels")
    out[f"{arch}-long"] = {
        "swa_attn": (counted["swa_attn"], ran["swa_attn"]),
        "swa_attn_bwd": (counted["swa_attn_bwd"], ran["swa_attn_bwd"]),
        "grad_sketch": counted["grad_sketch"],
        "omp_gram": counted["omp_gram"]}
    # one replayed step (one plan row) under the profiler
    idx, w = eng.full_plan(5)
    row = (idx[:1].copy(), w[:1].copy())
    profile_call(torch, lambda: eng.run_epoch(eng.params, eng.opt_state,
                                              tc.lr, row),
                 "20a", f"{arch} one replayed step (B {LONG_UNIT} x "
                        f"{LONG_SEQ}, full depth, remat)")
    # the same row untraced, on the host clock after a synchronize (phase
    # 22's MFU reads it)
    torch.cuda.synchronize()
    t0 = time.time()
    eng.run_epoch(eng.params, eng.opt_state, tc.lr, row)
    torch.cuda.synchronize()
    step_s = time.time() - t0
    print(f"[20a] one replayed step untraced: {step_s * 1e3:.1f} ms (host "
          f"clock, the row's plan copy and loss read included)", flush=True)
    out["times"] = {"step_s": step_s, "peak_gb": peak}
    del h, eng, spy, nodes
    gc.collect()
    torch.cuda.empty_cache()
    mark(f"20a {arch} trained at full width and depth, S {LONG_SEQ}")

    # (b) at LONG_REPEAT_LAYERS twice, P7
    b2 = build_model(dataclasses.replace(cfg, n_layers=LONG_REPEAT_LAYERS))
    params, n_run = train_twice(
        torch, np, b2, us_np, vs_np, tc, dev, "20b", f", S {LONG_SEQ}, "
        f"remat", zero, read, gb,
        ("grad_sketch", "omp_gram", "swa_attn", "swa_attn_bwd"))
    out[f"{arch}-long-{LONG_REPEAT_LAYERS}"] = {
        k: n_run[k] for k in ("swa_attn", "swa_attn_bwd", "grad_sketch",
                              "omp_gram")}
    us, vs = to_device(us_np, dev), to_device(vs_np, dev)
    proj = make_proj_for(b2, torch.Generator().manual_seed(0),
                         pc.sketch_dim_h, pc.sketch_dim_v, dev)
    sel, _, err, same, bitwise, cnt = resident_against_host(
        torch, b2, pc, params, us, vs, proj, read)
    print(f"[20b] {arch} ({LONG_REPEAT_LAYERS} layers): resident stage A "
          f"against host units_gradients on the trained params: max err "
          f"{err:.2e} of the largest entry (1e-5); same subsets and weights "
          f"(1e-4): {same}; two replays bitwise equal: {bitwise}; launches "
          f"counted at the warm-ups and captures {cnt}", flush=True)
    require(err <= 1e-5 and same and bitwise,
            "20b: resident stage A disagrees with the host's")
    del sel, proj, params, b2
    gc.collect()
    torch.cuda.empty_cache()
    mark(f"20b {arch} at {LONG_REPEAT_LAYERS} layers twice, P7")

    # (c) remat on against off, one step
    b6 = build_model(dataclasses.replace(cfg, n_layers=LM_RESIDENT_LAYERS))
    p6 = card_init(torch, b6, dev)
    batch = {k: v[0] for k, v in us.items()}
    runs = {}
    for remat in (True, False):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        live = tree_map(lambda x: x.detach().requires_grad_(True), p6)
        total, _ = b6.loss_fn(live, batch, remat=remat)
        grads = torch.autograd.grad(total, tree_leaves(live))
        torch.cuda.synchronize()
        runs[remat] = (total.detach(), grads,
                       (torch.cuda.max_memory_allocated() - base) / 1e9)
        del live, total, grads
    same = (bool(torch.equal(runs[True][0], runs[False][0]))
            and all(bool(torch.equal(a, b))
                    for a, b in zip(runs[True][1], runs[False][1])))
    print(f"[20c] {arch} ({LM_RESIDENT_LAYERS} layers), one step on {LONG_UNIT} "
          f"x {LONG_SEQ} tokens: loss and all {len(runs[True][1])} gradient "
          f"leaves bitwise equal with remat on and off: {same}; peak above "
          f"the params {runs[True][2]:.2f} GB with remat, "
          f"{runs[False][2]:.2f} GB without", flush=True)
    require(same and runs[True][2] < runs[False][2],
            "20c: remat changed the step's bits or did not lower its peak")
    del runs, p6, batch, us, vs, b6
    gc.collect()
    torch.cuda.empty_cache()
    mark("20c remat on against off")

    # (d) one layer at fp32, one example past the band's start, card
    # against CPU (its CPU side started with the phase)
    b1, p_cpu, batch = long_agree_setup(torch)
    res = {"cuda": long_agree_side(torch, b1, p_cpu, batch, dev)}
    path = long_cpu.result()
    res["cpu"] = torch.load(path)
    os.remove(path)
    loss_rel = float(((res["cuda"][0] - res["cpu"][0]).abs()
                      / res["cpu"][0].abs()).max())
    grad_rel = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(res["cuda"][1], res["cpu"][1]))
    print(f"[20d] {arch} at full width, 1 layer, fp32, one example of "
          f"{LONG_AGREE_S} tokens (the band from {cfg.window + 1025}): loss "
          f"rel err {loss_rel:.2e}, every one of {len(res['cpu'][1])} "
          f"gradient leaves within {grad_rel:.2e} of its largest entry "
          f"(card {res['cuda'][2]:.1f} s vs CPU {res['cpu'][2]:.1f} s)",
          flush=True)
    require(all(bool(torch.isfinite(g).all()) for g in res["cuda"][1])
            and loss_rel < 1e-4 and grad_rel < 1e-3,
            "20d: card and CPU disagree on the training step through the "
            "band")
    del res, p_cpu, b1
    gc.collect()
    torch.cuda.empty_cache()
    mark("20d card against CPU at one layer")
    return out


# phase 21: distribution on torch.distributed at world size 1 on the card
# (ROADMAP hazards D1-D8).  (b) starcoder2-3b at full width and these
# layers, S 512, DIST_STEPS replayed rows a compress mode (k_frac the
# launcher's default); (c) two ranks of rnnt-crdnn on the one card over
# gloo, eager
DIST_LM_LAYERS = 2
DIST_STEPS = 4
DIST_K_FRAC = 0.05
# 21c's agreement, two ranks against one: a resident round on the seed's
# params picks the same subset, weights within 1e-4; from the seed's
# params this many steps of epoch 0 (every unit weight 1), and again this
# many steps of the round's subset epoch at two units a row (each rank
# one unit, so the ranks' weight sums differ and the D1 scale is not 1),
# each step's loss within DIST_GLOO_LOSS_BAR and every params leaf's norm
# after them within DIST_GLOO_NORM_BAR (relative; on an H100 80GB HBM3 at
# 700 W epoch 0's losses were 6e-8 and 2e-7 apart and the norms at most
# 4.7e-5, a leaf of norm 0.02).  Whole epochs are not held to a bar: at
# lr 0.5 this training amplifies the reassociation of the batch's split
# (step losses 8e-6 and 5e-5 apart at steps 3 and 4, up to 0.12 by step
# 8, on that card; a 2-epoch run's losses 0.46 apart).  The witness: the
# first DIST_GLOO_TRACK steps' losses of the two ranks, of one device,
# and of one device summing each row's gradient in two halves as the two
# ranks do (``halves_steps``), printed side by side
DIST_GLOO_STEPS = 2
DIST_GLOO_TRACK = 8
DIST_GLOO_LOSS_BAR = 1e-5
DIST_GLOO_NORM_BAR = 1e-4
NCCL_MARKER = "nccl"


def nccl_share(torch, fn, tag: str, what: str):
    """``fn()`` under ``torch.profiler`` after a warm-up call -> (wall
    ms, device busy ms, the collectives' device ms: kernels whose name
    holds ``nccl``).  In a group of one NCCL enqueues no kernel, so the
    collectives' share reads 0 by construction: it measures nothing
    until a run on more than one card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    busy = comm = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dt = getattr(ev, "self_device_time_total", None)
        dt = (ev.self_cuda_time_total if dt is None else dt) / 1e3
        busy += dt
        if NCCL_MARKER in ev.key.lower():
            comm += dt
    print(f"[profile {tag}] {what}: wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms, collectives (nccl kernels) {comm:.3f} ms "
          f"({100 * comm / max(busy, 1e-9):.2f}% of busy; not a measure "
          f"in a group of one)", flush=True)
    return wall, busy, comm


def rnnt_setup(epochs: int):
    """Phase 5's RNN-T corpus, validation units and config, with
    ``epochs`` epochs."""
    from repro_torch.configs.base import PGMConfig, TrainConfig
    from repro_torch.data.pipeline import asr_units
    from repro_torch.data.synthetic import make_asr_corpus

    units = asr_units(make_asr_corpus(0, **CORPUS), UNIT_SIZE)
    val_units = asr_units(make_asr_corpus(7, N_VAL, **{
        k: v for k, v in CORPUS.items()
        if k not in ("n_examples", "noise_fraction", "snr_db")}), UNIT_SIZE)
    tc = TrainConfig(lr=0.5, optimizer="sgd", epochs=epochs, seed=0,
                     pgm=PGMConfig(subset_fraction=0.5, n_partitions=4,
                                   select_every=1, warm_start_epochs=1,
                                   val_matching=True))
    return units, val_units, tc


def first_steps(torch, bundle, tc, units, val_units, dev, mesh):
    """On ``mesh`` (or one device without), from the seed's params: a
    resident PGM round; ``DIST_GLOO_TRACK`` rows of epoch 0's plan on the
    host engine, every whole params leaf's L2 norm taken after the first
    ``DIST_GLOO_STEPS``; and ``DIST_GLOO_STEPS`` rows of the round's
    subset epoch on a host engine of two units a row -> {losses, norms,
    indices, weights, subset rows' unit weights, subset losses, subset
    norms}."""
    from repro_torch.core.lastlayer import make_proj_for
    from repro_torch.core.pgm import ResidentSelector
    from repro_torch.models.common import tree_leaves
    from repro_torch.train.engine import HostEngine
    from repro_torch.train.optim import make_update_for

    S, T = DIST_GLOO_STEPS, DIST_GLOO_TRACK
    norms = lambda p: [float(torch.linalg.vector_norm(x.double()))
                       for x in tree_leaves(p)]
    init = make_update_for(tc)[0]
    eng = HostEngine(bundle, tc, units, val_units=val_units, device=dev,
                     mesh=mesh)
    gen = torch.Generator().manual_seed(tc.seed)
    p0 = bundle.init_params(gen, dev)
    proj = make_proj_for(bundle, gen, tc.pgm.sketch_dim_h,
                         tc.pgm.sketch_dim_v, dev)
    sel = ResidentSelector(bundle, tc.pgm, proj, mesh=mesh,
                           on_failure="raise")(p0, eng.units,
                                               val_units=eng.val_units)
    idx, w = eng.full_plan(0)
    p, o, head = eng.run_epoch(p0, init(p0), tc.lr, (idx[:S], w[:S]))
    out = {"norms": norms(p)}
    p, o, tail = eng.run_epoch(p, o, tc.lr, (idx[S:T], w[S:T]))
    out["losses"] = [float(x) for x in list(head) + list(tail)]
    out["indices"] = sel.indices.tolist()
    out["weights"] = sel.weights.tolist()
    eng2 = HostEngine(bundle, tc, units, device=dev, mesh=mesh,
                      batch_units=2)
    s_idx, s_w = eng2.subset_plan(sel.indices.cpu().numpy(),
                                  sel.weights.cpu().numpy(), 1)
    p, _, sub = eng2.run_epoch(p0, init(p0), tc.lr, (s_idx[:S], s_w[:S]))
    out["subset_rows"] = s_w[:S].tolist()
    out["subset_losses"] = [float(x) for x in sub]
    out["subset_norms"] = norms(p)
    return out


def halves_steps(torch, bundle, tc, units, dev):
    """The control of 21c on one device: the host engine's first
    ``DIST_GLOO_TRACK`` rows of epoch 0 from the seed's params, each row's
    gradient taken in two halves of its examples as two data ranks take
    it (each half's weighted mean loss scaled by its weight sum over the
    halves' mean, D1), the halves' gradients added in one fp32 buffer and
    halved, as the ranks' all-reduce does, then clipped and applied ->
    each row's loss (the halves' mean)."""
    import numpy as np

    from repro_torch.models.common import tree_leaves, tree_unflatten
    from repro_torch.train.engine import HostEngine, to_device
    from repro_torch.train.optim import clip_by_global_norm, make_update_for

    eng = HostEngine(bundle, tc, units, device=dev)
    init, update = make_update_for(tc)
    p = bundle.init_params(torch.Generator().manual_seed(tc.seed), dev)
    o = init(p)
    idx, w = eng.full_plan(0)
    losses = []
    for sel, wr in zip(idx[:DIST_GLOO_TRACK], w[:DIST_GLOO_TRACK]):
        batch = {k: v[sel].reshape((-1,) + v.shape[2:])
                 for k, v in eng.units_host.items()}
        batch["weights"] = batch["weights"] * np.repeat(wr, eng.unit_size)
        batch = to_device(batch, dev)
        n = int(batch["weights"].shape[0]) // 2
        halves = [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                  for i in range(2)]
        ws = [torch.sum(h["weights"].to(torch.float32)).reshape(1)
              for h in halves]
        w_sum = ws[0] + ws[1]
        live = [x.detach().requires_grad_(True) for x in tree_leaves(p)]
        flats, parts = [], []
        for h, w_r in zip(halves, ws):
            s = (w_r / torch.clamp(w_sum / 2, min=1e-9)).reshape(())
            with torch.enable_grad():
                _, m = bundle.loss_fn(tree_unflatten(p, live), h)
                g = torch.autograd.grad(m["loss"] * s + m["aux_loss"], live)
            flats.append(torch.cat([x.reshape(-1) for x in g]))
            parts.append((m["loss"].detach() * s).to(torch.float32))
        flat = (flats[0] + flats[1]) / 2
        grads, at = [], 0
        for x in live:
            grads.append(flat[at:at + x.numel()].reshape(x.shape))
            at += x.numel()
        with torch.no_grad():
            grads, _ = clip_by_global_norm(tree_unflatten(p, grads),
                                           tc.grad_clip)
            p, o = update(p, grads, o, tc.lr)
        losses.append(float((parts[0] + parts[1]) / 2))
    return losses


def gloo_rank(rank: int, world: int, store_path: str, go_path: str):
    """Phase 21c, one rank of a (world,) data mesh over gloo on the one
    card, eager (the host engine): ``first_steps`` of the RNN-T main
    path.  Waits for ``go_path`` after
    joining the group (its imports and the card's context overlap 21a
    and 21b) -> (``first_steps``' result, the kernels' launches in this
    rank, the backend)."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import backend
    from repro_torch.kernels.grad_sketch.ops import grad_sketch_units_op
    from repro_torch.kernels.omp_gram.ops import omp_gram_batched_op
    from repro_torch.kernels.rnnt_lattice.ops import rnnt_lattice_op
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models.api import build_model

    torch.set_num_threads(2)
    init_distributed("cuda", rank=rank, world_size=world,
                     store=dist.FileStore(store_path, world),
                     allow_shared_card=True)
    backend.fp32_numerics()
    backend.build()
    mesh = make_mesh((world,), ("data",), "cuda")
    bundle = build_model(get_config("rnnt-crdnn"))
    units, val_units, tc = rnnt_setup(1)
    while not os.path.exists(go_path):
        time.sleep(0.05)
    if os.path.exists(go_path + ".stop"):       # the phase failed before
        dist.destroy_process_group()
        return None
    ops = {"rnnt_lattice": rnnt_lattice_op, "omp_gram": omp_gram_batched_op,
           "grad_sketch": grad_sketch_units_op}
    for op in ops.values():
        op.launches = 0
    got = first_steps(torch, bundle, tc, units, val_units,
                      torch.device("cuda"), mesh)
    torch.cuda.synchronize()
    out = (got, {n: op.launches for n, op in ops.items()}, dist.get_backend())
    dist.destroy_process_group()
    return out


def dist_phase(torch, np, dev, mark, bundle, tc, units, val_units,
               rec_15a):
    """Phase 21: distribution at world size 1 on the card (one H100): a
    one-rank NCCL group on a (1, 1) data x pod mesh.  (a) phase 15a's
    RNN-T path (scan engine, resident rounds, sharded stage B) twice at
    ``REPEAT_EPOCHS`` epochs, bitwise each other and 15a's run without a
    group over them (``rec_15a``; the CPU tests hold a group of one
    bitwise the one-device run), its step's capture holding its
    collectives (counted as issued inside it, D6), captures and replays
    counted as phase 14 counts them; (b) ``starcoder2-3b`` at
    full width and ``DIST_LM_LAYERS`` layers, S 512, through the pod step
    in ``none``, ``bf16`` and ``topk`` against the plain step (no group),
    each a fresh engine replaying ``DIST_STEPS`` rows: a replayed step's
    time, the collectives' share of one under the profiler, the peak with
    the fp32 ``err`` state, and (top-k) the collectives' share of one
    under the profiler; on the full-width leaves (the 49,152 x 3,072
    embedding included) top-k sends exactly the k largest of ``g + err``
    (a real gradient and the run's residuals) and ``sent + new_err == g +
    err`` bitwise; then a resident round on the mesh (the grad sketch and
    the Gram); (c) two ranks on the one card over gloo (which carries the
    CUDA tensors of every collective the port uses: all_reduce in fp32
    and bf16, all_gather_into_tensor, barrier), rnnt-crdnn at data = 2 on
    the host engine, eager, against one device (``first_steps``): a
    resident round on the seed's params (stage B sharded over data; the
    same subset, weights within 1e-4), the first ``DIST_GLOO_STEPS``
    steps of epoch 0 and of the round's subset epoch (each rank one unit
    of a row, weight sums that differ: the D1 scale) from the seed's
    params (each loss within ``DIST_GLOO_LOSS_BAR``, every leaf's norm
    after them within ``DIST_GLOO_NORM_BAR``), and, unheld, epoch 0's
    losses over ``DIST_GLOO_TRACK`` steps beside one device's and
    ``halves_steps``'.  -> {path: {kernel: launches}, "times": 21b's
    numbers}."""
    import concurrent.futures
    import multiprocessing
    import tempfile

    import torch.distributed as dist

    from repro_torch.analysis import contracts
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PGMConfig, TrainConfig
    from repro_torch.core.lastlayer import make_proj_for
    from repro_torch.core.pgm import ResidentSelector
    from repro_torch.kernels.grad_sketch.ops import grad_sketch_units_op
    from repro_torch.kernels.omp_gram.ops import omp_gram_batched_op
    from repro_torch.kernels.rnnt_lattice.ops import rnnt_lattice_op
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.launch.train import make_units_for
    from repro_torch.models.api import build_model
    from repro_torch.models.common import tree_leaves, tree_unflatten
    from repro_torch.train.compress import topk_compress
    from repro_torch.train.engine import EpochEngine, to_device
    from repro_torch.train.loop import train_with_selection
    from repro_torch.train.optim import make_update_for

    ops = {"rnnt_lattice": rnnt_lattice_op, "grad_sketch": grad_sketch_units_op,
           "omp_gram": omp_gram_batched_op}
    read = lambda: {n: op.launches for n, op in ops.items()}
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    # (c)'s two ranks start now: imports, the card's context and the
    # gloo rendezvous overlap (a) and (b); they train once (b) is done
    go = os.path.join(tmp, "go")
    pool = concurrent.futures.ProcessPoolExecutor(
        2, mp_context=multiprocessing.get_context("spawn"))
    ranks = [pool.submit(gloo_rank, r, 2, os.path.join(tmp, "gloo"), go)
             for r in range(2)]
    try:
        init_distributed("cuda", rank=0, world_size=1,
                         store=dist.FileStore(os.path.join(tmp, "nccl"), 1))
        mesh = make_mesh((1, 1), ("data", "pod"), "cuda")
        require(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
                "21: not a one-rank NCCL group")
        mark("21 a one-rank NCCL group and its (1, 1) mesh")

        # -- (a) the RNN-T path on the mesh, twice ----------------------
        recs = []
        tc_r = dataclasses.replace(tc, epochs=REPEAT_EPOCHS)
        for tag, tc_ in (("21a", tc_r), ("21a again", tc_r)):
            for op in ops.values():
                op.launches = 0
            ResidentSelector.captures = ResidentSelector.replays = 0
            EpochEngine.captures = EpochEngine.replays = 0
            EpochEngine.warmup_steps = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            with kept_graphs(torch), engine_spy(EpochEngine) as spy, \
                    contracts.record_collectives() as coll:
                h = train_with_selection(
                    bundle, units, tc_, method="pgm", val_units=val_units,
                    device="cuda", engine="scan", resident_selection=True,
                    mesh=mesh,
                    log_fn=lambda s: print(f"[{tag} +{time.time() - t0:.1f}"
                                           f"s] {s}", flush=True))
                torch.cuda.synchronize()
                (eng,) = spy.engines
                nodes = graph_kernels(eng._graph, {
                    "nccl": NCCL_MARKER,
                    "rnnt_lattice": KERNEL_MARKERS["rnnt_lattice"]})
            secs = time.time() - t0
            launches = read()
            recs.append(rnnt_run_record(h))
            print(f"[{tag}] {secs:.1f} s on a (1, 1) data x pod NCCL group "
                  f"(scan engine, resident rounds, sharded stage B); step "
                  f"captures {EpochEngine.captures}, warm-up steps "
                  f"{EpochEngine.warmup_steps}, replays "
                  f"{EpochEngine.replays}; stage-A captures "
                  f"{ResidentSelector.captures}, replays "
                  f"{ResidentSelector.replays}; collectives issued "
                  f"{coll.count}, {coll.captured} of them inside the step's "
                  f"capture; the step graph's kernel nodes {nodes} (NCCL "
                  f"enqueues no kernel in a group of one); launches "
                  f"{launches}; peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
                  flush=True)
            require(EpochEngine.captures == 1 and ResidentSelector.captures
                    == 2 and coll.captured > 0
                    and nodes["rnnt_lattice"] > 0,
                    f"{tag}: the step's capture holds no collective or no "
                    f"lattice, or the run captured another number of "
                    f"graphs")
            require(launches["rnnt_lattice"] > 0 and launches["omp_gram"] > 0,
                    f"{tag}: a kernel of the path was not launched "
                    f"{launches}")
            # the captured step's collectives all at fp32 (compress mode
            # none), every collective over the pod axis's group
            contracts.assert_collective_width(coll.in_capture(),
                                              dtype=torch.float32)
            contracts.assert_replica_groups(coll, mesh, "pod",
                                            min_count=coll.count)
            print(f"[{tag}] contracts: the step's {coll.captured} captured "
                  f"collectives at fp32; all {coll.count} over the pod "
                  f"axis's groups {contracts.expected_groups(mesh, 'pod')}",
                  flush=True)
            if tag == "21a":
                # (counted, graph nodes x replays): a replay runs every
                # node once, so the second is what the replays launched
                out["rnnt-mesh"] = {
                    "rnnt_lattice": (launches["rnnt_lattice"],
                                     nodes["rnnt_lattice"]
                                     * EpochEngine.replays),
                    "omp_gram": (launches["omp_gram"], 0)}
            del h, eng, spy
        again = recs[1] == recs[0]
        bitwise = recs[0] == run_prefix(rec_15a)
        print(f"[21a] two runs of seed {tc.seed} ({REPEAT_EPOCHS} epochs) "
              f"bitwise equal: {again}; bitwise 15a's run without a group "
              f"over its first {REPEAT_EPOCHS} epochs: {bitwise}",
              flush=True)
        require(again and bitwise, "21a: the mesh run is not bitwise the "
                                   "run without a group, or not repeatable")
        gc.collect()
        torch.cuda.empty_cache()
        mark("21a rnnt-crdnn on a one-rank NCCL group")

        # -- (b) starcoder2-3b through the pod step -----------------------
        lm_full = get_config("starcoder2-3b")
        lm = build_model(dataclasses.replace(lm_full,
                                             n_layers=DIST_LM_LAYERS))
        lm_us, lm_vs = make_units_for(lm_full, n=LM_N, seq=LM_SEQ,
                                      noise=0.0)
        plan = (np.arange(DIST_STEPS, dtype=np.int32)[:, None],
                np.ones((DIST_STEPS, 1), np.float32))
        times = {}
        err = params_b = None
        t_b = time.time()
        for mode in ("plain", "none", "bf16", "topk"):
            tc_b = TrainConfig(lr=0.05, optimizer="sgd", epochs=1, seed=0,
                               compress_mode="none" if mode == "plain"
                               else mode, compress_k_frac=DIST_K_FRAC)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            eng = EpochEngine(lm, tc_b, lm_us, batch_units=1, device=dev,
                              mesh=None if mode == "plain" else mesh)
            p = card_init(torch, lm, dev)
            o = make_update_for(tc_b)[0](p)
            eng.adopt(p, o)
            with contracts.record_collectives() as coll:  # warm-up, capture
                eng.run_epoch(p, o, tc_b.lr, plan)
            torch.cuda.synchronize()
            t0 = time.time()
            _, _, losses = eng.run_epoch(p, o, tc_b.lr, plan)
            torch.cuda.synchronize()
            step_ms = (time.time() - t0) * 1e3 / DIST_STEPS
            peak = torch.cuda.max_memory_allocated() / 1e9
            require(bool(np.all(np.isfinite(losses))),
                    f"21b {mode}: non-finite loss")
            if mode == "topk":
                # the collectives' share of a replayed step, traced
                one = (plan[0][:1], plan[1][:1])
                times["trace"] = nccl_share(
                    torch, lambda: eng.run_epoch(p, o, tc_b.lr, one),
                    f"21b {mode}", "one replayed step")
            times[mode] = (step_ms, peak)
            print(f"[21b +{time.time() - t_b:.1f}s] starcoder2-3b "
                  f"{DIST_LM_LAYERS} layers, S {LM_SEQ}, "
                  f"{mode}: a replayed step {step_ms:.2f} ms (host clock over "
                  f"{DIST_STEPS}); peak {peak:.2f} GB; collectives inside "
                  f"the step's capture {coll.captured}; losses "
                  f"{[round(float(x), 4) for x in losses]}", flush=True)
            require((mode == "plain") == (coll.captured == 0),
                    f"21b {mode}: {coll.captured} collectives in the "
                    f"step's capture")
            if mode != "plain":
                # the pod mean at bf16 in bf16 mode, one a step (the warm-up
                # steps and the capture), the rest fp32; fp32 in none and
                # topk; every collective over the pod axis's group
                if mode == "bf16":
                    contracts.assert_collective_width(
                        coll, dtype=torch.bfloat16,
                        n_expected=EpochEngine.WARMUP_STEPS + 1)
                else:
                    contracts.assert_collective_width(coll,
                                                      dtype=torch.float32)
                contracts.assert_replica_groups(coll, mesh, "pod",
                                                min_count=coll.count)
                widths = sorted({str(c.dtype) for c in coll.calls})
                print(f"[21b] {mode} contracts: {coll.count} collectives "
                      f"at {widths}, over the pod axis's groups", flush=True)
            if mode == "topk":
                err, params_b = eng.compress_state, eng.params
            else:
                del p, o
            del eng
        # top-k on the full-width leaves: a real gradient of one unit and
        # the run's residuals
        batch = {k: torch.as_tensor(v[0]).to(dev) for k, v in lm_us.items()}
        live = [x.detach().requires_grad_(True) for x in tree_leaves(params_b)]
        with torch.enable_grad():
            total, _ = lm.loss_fn(tree_unflatten(params_b, live), batch)
            grads = torch.autograd.grad(total, live)
        g_tree = tree_unflatten(params_b, list(grads))
        sent, new = topk_compress(g_tree, err, DIST_K_FRAC)
        checked = []
        for g, e, s_, n_ in zip(grads, tree_leaves(err), tree_leaves(sent),
                                tree_leaves(new)):
            flat = (g + e).reshape(-1)
            k = max(int(flat.numel() * DIST_K_FRAC), 1)
            top = torch.topk(flat.abs(), k).values
            on = s_.reshape(-1) != 0
            got = torch.sort(s_.reshape(-1)[on].abs(), descending=True).values
            ok = (bool(torch.equal(s_ + n_, g + e))
                  and int(on.sum()) == int((top != 0).sum())
                  and bool(torch.equal(got, top[top != 0])))
            checked.append((tuple(g.shape), k, ok))
        emb = [c for c in checked if c[0] == (lm_full.vocab_size,
                                              lm_full.d_model)]
        print(f"[21b] top-k on {len(checked)} full-width leaves (k_frac "
              f"{DIST_K_FRAC}; the embedding {emb}): exactly the k largest "
              f"|g + err| sent and sent + new_err == g + err bitwise on every "
              f"leaf: {all(c[2] for c in checked)}", flush=True)
        require(emb and all(c[2] for c in checked),
                f"21b: top-k sent another set than the k largest, or the "
                f"error-feedback invariant broke: "
                f"{[c for c in checked if not c[2]]}")
        del live, grads, g_tree, sent, new, total, err
        # a resident round on the mesh: the grad sketch and the Gram
        for op in ops.values():
            op.launches = 0
        pc = PGMConfig(subset_fraction=0.5, n_partitions=4, select_every=1,
                       warm_start_epochs=1, val_matching=True)
        proj = make_proj_for(lm, torch.Generator().manual_seed(0),
                             pc.sketch_dim_h, pc.sketch_dim_v, dev)
        sel = ResidentSelector(lm, pc, proj, mesh=mesh, on_failure="raise")
        s_ = sel(params_b, to_device(lm_us, dev),
                 val_units=to_device(lm_vs, dev))
        torch.cuda.synchronize()
        launches = read()
        print(f"[21b] a resident round on the mesh (sharded stage B over "
              f"data): {s_.n_selected} units; launches {launches}",
              flush=True)
        require(launches["grad_sketch"] > 0 and launches["omp_gram"] > 0
                and s_.n_selected > 0,
                f"21b: the round launched {launches}")
        out["lm-mesh"] = {k: launches[k] for k in ("grad_sketch", "omp_gram")}
        out["times"] = times
        del sel, params_b, s_, proj
        gc.collect()
        torch.cuda.empty_cache()
        mark("21b starcoder2-3b through the pod step, 3 modes")

        # -- (c) two ranks on the one card over gloo ----------------------
        # the two ranks start; meanwhile the round and the first steps on
        # one device, which theirs are held to, and the control that
        # splits each row's gradient in two halves on one device
        with open(go, "w"):
            pass
        u1, v1, tc1 = rnnt_setup(1)
        one = first_steps(torch, bundle, tc1, u1, v1, dev, None)
        halves = halves_steps(torch, bundle, tc1, u1, dev)
        got = [r.result(timeout=600) for r in ranks]
        (two, l0, be0), (two1, l1, _) = got
        S = DIST_GLOO_STEPS
        rel = lambda a, b: max(abs(x - y) / abs(y) for x, y in zip(a, b))
        loss_rel = rel(two["losses"][:S], one["losses"][:S])
        norm_rel = rel(two["norms"], one["norms"])
        sub_loss_rel = rel(two["subset_losses"], one["subset_losses"])
        sub_norm_rel = rel(two["subset_norms"], one["subset_norms"])
        # the D1 scale is not 1: the two units of a subset row (one a
        # rank) carry different weights
        d1 = any(r[0] != r[1] for r in two["subset_rows"])
        same = two["indices"] == one["indices"]
        w_gap = float(np.abs(np.subtract(two["weights"],
                                         one["weights"])).max())
        w_ok = w_gap <= 1e-4
        gaps = lambda a: ", ".join(f"{abs(x - y) / abs(y):.1e}" for x, y in
                                   zip(a, one["losses"]))
        print(f"[21c] rnnt-crdnn on two ranks sharing the card over "
              f"{be0} (host engine, eager, data = 2) against one device, "
              f"from the seed's params: a resident round (stage B sharded "
              f"over data): the same subset {same} "
              f"({sum(i >= 0 for i in two['indices'])} units), weights at "
              f"most {w_gap:.2e} apart (1e-4); epoch 0's first {S} steps: "
              f"losses {two['losses'][:S]} against {one['losses'][:S]}, at "
              f"most {loss_rel:.2e} apart ({DIST_GLOO_LOSS_BAR}), every "
              f"params leaf's norm after them at most {norm_rel:.2e} apart "
              f"({DIST_GLOO_NORM_BAR}); the subset epoch's first {S} steps "
              f"at two units a row (the rows' unit weights "
              f"{two['subset_rows']}, weight sums that differ {d1}): losses "
              f"{two['subset_losses']} against {one['subset_losses']}, at "
              f"most {sub_loss_rel:.2e} apart, norms at most "
              f"{sub_norm_rel:.2e} apart; both ranks the same results "
              f"{two == two1}; launches rank 0 {l0}, rank 1 {l1}",
              flush=True)
        print(f"[21c] epoch 0's first {DIST_GLOO_TRACK} steps, unheld: one "
              f"device's losses {one['losses']}; the two ranks' relative "
              f"gaps to them per step [{gaps(two['losses'])}]; one device "
              f"summing each row's gradient in two halves [{gaps(halves)}]; "
              f"the two ranks against the halves at most "
              f"{rel(two['losses'], halves):.2e} apart", flush=True)
        require(two == two1 and be0 == "gloo" and same and w_ok and d1
                and loss_rel <= DIST_GLOO_LOSS_BAR
                and norm_rel <= DIST_GLOO_NORM_BAR
                and sub_loss_rel <= DIST_GLOO_LOSS_BAR
                and sub_norm_rel <= DIST_GLOO_NORM_BAR,
                f"21c: the two ranks' {two} against one device's {one}")
        require(l0["rnnt_lattice"] > 0 and l0["omp_gram"] > 0,
                f"21c: a kernel was not launched {l0}")
        out["rnnt-mesh-gloo"] = {k: l0[k] + l1[k]
                                 for k in ("rnnt_lattice", "omp_gram")}
        mark("21c two ranks on the card over gloo")
    finally:
        if not os.path.exists(go):              # (c) never started
            for path in (go + ".stop", go):
                with open(path, "w"):
                    pass
        pool.shutdown(wait=True, cancel_futures=True)
        if dist.is_initialized():
            dist.destroy_process_group()
    return out


# phase 22: the contracts' card side and the roofline.  A violating graph
# is built through the driver (a host node, a device-to-host memcpy node),
# so nothing of the port is captured wrongly on purpose
HOST_FN = None                       # keeps the host node's callback alive


def driver_graph(torch, kind: str, src=None, dst=None) -> int:
    """A ``CUgraph`` of one node made through the driver API: ``"host"``
    a host-function node, ``"d2h"`` a memcpy node of ``src`` (a card
    tensor) into ``dst`` (pinned host memory) -> the raw handle."""
    import ctypes
    global HOST_FN
    cu = ctypes.CDLL("libcuda.so.1")
    vp = ctypes.c_void_p
    for fn, args in (("cuGraphCreate", (ctypes.POINTER(vp), ctypes.c_uint)),
                     ("cuGraphAddHostNode", (ctypes.POINTER(vp), vp, vp,
                                             ctypes.c_size_t, vp)),
                     ("cuGraphAddMemcpyNode", (ctypes.POINTER(vp), vp, vp,
                                               ctypes.c_size_t, vp, vp)),
                     ("cuCtxGetCurrent", (ctypes.POINTER(vp),))):
        getattr(cu, fn).argtypes = args
        getattr(cu, fn).restype = ctypes.c_int
    g, node = vp(), vp()
    require(cu.cuGraphCreate(ctypes.byref(g), 0) == 0, "cuGraphCreate")
    if kind == "host":
        HOST_FN = ctypes.CFUNCTYPE(None, vp)(lambda _: None)
        params = (vp * 2)(ctypes.cast(HOST_FN, vp), None)
        require(cu.cuGraphAddHostNode(ctypes.byref(node), g, None, 0,
                                      params) == 0, "cuGraphAddHostNode")
        return g.value
    ctx = vp()
    require(cu.cuCtxGetCurrent(ctypes.byref(ctx)) == 0, "cuCtxGetCurrent")
    buf = (ctypes.c_char * 200)()                   # CUDA_MEMCPY3D
    put = lambda off, t, v: t.from_buffer(buf, off).__setattr__("value", v)
    put(32, ctypes.c_int, 2)                        # srcMemoryType device
    put(48, ctypes.c_uint64, src.data_ptr())        # srcDevice
    put(120, ctypes.c_int, 1)                       # dstMemoryType host
    put(128, ctypes.c_uint64, dst.data_ptr())       # dstHost
    put(176, ctypes.c_size_t, src.numel() * src.element_size())
    put(184, ctypes.c_size_t, 1)                    # Height
    put(192, ctypes.c_size_t, 1)                    # Depth
    require(cu.cuGraphAddMemcpyNode(ctypes.byref(node), g, None, 0, buf,
                                    ctx) == 0, "cuGraphAddMemcpyNode")
    return g.value


def raises(fn, exc) -> bool:
    """Whether ``fn()`` raises ``exc`` (a deliberate violation caught by
    a contract); any other error propagates."""
    try:
        fn()
    except exc:
        return True
    return False


def roofline_phase(torch, np, dev, mark, card, long_times, dist_times):
    """Phase 22: (a) the contracts' card side, each on a deliberate
    violation: a host node and a device-to-host memcpy node refused by
    ``assert_graph_device_only``, a captured device graph passed and
    counted by ``track_captures``; ``no_host_sync`` raising on ``.item()``
    (its function mode) and on a stream's ``synchronize()`` (the sync
    debug mode); (b) the dry run of 20a's step (``launch/dryrun.py``:
    fake CUDA tensors, nothing allocated): its op count and its memory
    floor against 20a's measured peak, which it must not exceed; the MFU
    of 20a's replayed step (model FLOPs over its wall time over 989
    TFLOP/s) and the useful ratio (model FLOPs over the counted FLOPs);
    (c) the same for 21b's plain step.  -> the numbers."""
    from repro_torch.analysis import contracts
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, roofline

    # (a) the card side of the contracts
    x = torch.randn(1 << 16, device=dev)
    y, z = torch.empty_like(x), torch.empty_like(x)
    host = torch.empty(x.shape, pin_memory=True)
    y.copy_(x * 2)
    torch.cuda.synchronize()
    with kept_graphs(torch), contracts.track_captures() as log:
        g_dev = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g_dev):
            y.copy_(x * 2)
            z.copy_(y)
    g_dev.replay()
    torch.cuda.synchronize()
    nodes = contracts.graph_nodes(g_dev)
    kinds = device_only(g_dev, "22a: a device graph")
    bad = {k: driver_graph(torch, k, x, host) for k in ("host", "d2h")}
    found = {k: contracts.graph_nodes(g) for k, g in bad.items()}
    refused = {k: raises(lambda g=g: contracts.assert_graph_device_only(
        g, f"22a: a {k} graph"), AssertionError) for k, g in bad.items()}
    guard = contracts.no_host_sync("22a")

    def under_guard(fn):
        with guard:
            fn()
    item = raises(lambda: under_guard(lambda: x.sum().item()),
                  contracts.HostSyncError)
    sync = raises(lambda: under_guard(
        lambda: torch.cuda.current_stream().synchronize()), RuntimeError)
    under_guard(lambda: (x * 2).sum())
    print(f"[22a] contracts on the card: a captured device graph (captures "
          f"counted {log.count}, sites {log.sites}) device-only, its nodes "
          f"{kinds} ({nodes}); graphs built through the driver: a host node "
          f"{found['host']} and a device-to-host memcpy node {found['d2h']}, "
          f"refused: {refused}; no_host_sync raised on .item() {item} and "
          f"on a stream synchronize {sync} (the sync debug mode), not on "
          f"device work", flush=True)
    require(log.count == 1 and kinds.get("KERNEL", 0) >= 1
            and found["host"] == [("HOST", None)]
            and found["d2h"] == [("MEMCPY", ("device", "host"))]
            and all(refused.values()) and item and sync,
            "22a: a contract did not catch its violation on the card")
    del g_dev, bad, host, x, y, z
    mark("22a the contracts on deliberate violations")

    # (b) 20a's step: the dry run against the card
    out = {}
    cfg_steps = (
        ("20a", "starcoder2-3b", ShapeConfig("20a", LONG_SEQ, LONG_UNIT,
                                             "train"), None, long_times),
        ("21b", "starcoder2-3b", ShapeConfig("21b", LM_SEQ, UNIT_SIZE,
                                             "train"), DIST_LM_LAYERS,
         {"step_s": dist_times["plain"][0] / 1e3,
          "peak_gb": dist_times["plain"][1]}))
    for tag, arch, shape, layers, meas in cfg_steps:
        rec = dryrun.run_cell(arch, shape.name, shape=shape, mesh="none",
                              device="cuda", optimizer="sgd",
                              n_layers=layers, verbose=True)
        require(rec["status"] == "ok", f"22 {tag}: the dry run {rec}")
        t = roofline.roofline_terms(rec)
        mf, step_s = rec["model_flops"], meas["step_s"]
        est = rec["memory"]["total"] / 1e9
        res = {"mfu": roofline.mfu(mf, step_s),
               "useful": mf / rec["flops"], "model_flops": mf,
               "counted_flops": rec["flops"], "step_s": step_s,
               "achieved_tflops": rec["flops"] / step_s / 1e12,
               "bound_s": t["bound_s"], "dominant": t["dominant"],
               "memory_gb": est, "peak_gb": meas["peak_gb"],
               "seconds": rec["seconds"]}
        out[tag] = res
        print(f"[22 {tag}] {card}: starcoder2-3b "
              f"({layers or 'all'} layers, B {shape.global_batch} x S "
              f"{shape.seq_len}) step {step_s * 1e3:.1f} ms: model FLOPs "
              f"{mf:.4e} -> MFU {100 * res['mfu']:.2f}% of 989 TFLOP/s; "
              f"counted {rec['flops']:.4e} FLOP ({rec['dot_flops']:.4e} in "
              f"matmuls, kernels {rec['kernels']}), useful ratio "
              f"{res['useful']:.3f}, achieved {res['achieved_tflops']:.1f} "
              f"TFLOP/s of the count; roofline bound {t['bound_s'] * 1e3:.1f}"
              f" ms ({t['dominant']}), the step {step_s / t['bound_s']:.2f}x "
              f"it; the dry run's memory floor {est:.2f} GB "
              f"({rec['memory']}) against the measured peak "
              f"{meas['peak_gb']:.2f} GB: ratio {est / meas['peak_gb']:.3f} "
              f"(dry run {rec['seconds']:.1f} s)", flush=True)
        require(0 < res["mfu"] < 1 and 0 < res["useful"] <= 1,
                f"22 {tag}: MFU {res['mfu']} or useful ratio "
                f"{res['useful']} out of range")
        if tag == "20a":
            require(est <= meas["peak_gb"],
                    f"22 20a: the dry run's floor {est:.2f} GB exceeds the "
                    f"measured peak {meas['peak_gb']:.2f} GB")
    mark("22b-c the roofline and the dry run against 20a and 21b")
    return out


def train_with_selection_logged(bundle, units, tc, val_units, logs, tag, t0,
                                **kw):
    """Phase 5's run (the host engine) with options, its log lines
    printed and kept."""
    from repro_torch.train.loop import train_with_selection

    def log(s):
        logs.append(s)
        print(f"{tag} +{time.time() - t0:.1f}s] {s}", flush=True)

    return train_with_selection(bundle, units, tc, method="pgm",
                                val_units=val_units, device="cuda",
                                engine="host", log_fn=log, **kw)


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
    print(f"[build] the driver's graph node types {check_node_types()}",
          flush=True)

    mark("build")

    # -- 3. kernels against their plain versions ------------------------
    # (phase 4's RWKV unit runs its CPU side meanwhile, on the host)
    rwkv_cpu = cpu_side(rwkv_agree_cpu)
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
    gram_rows = {shape: gram_row(torch, shape, dev)
                 for shape in ((P_main, n_units // P_main, D_sk),
                               (8, 512, 4096))}

    for shape in SKETCH_EDGES:
        sketch_err(torch, grad_sketch_units_op, grad_sketch_units_ref,
                   sketch_inputs(torch, *shape, seed=sum(shape), dev=dev))
    print(f"[kernels] grad_sketch edge shapes (U, n, d, V, k1, k2) in "
          f"{SKETCH_EDGES}: ok, two launches bitwise equal", flush=True)
    # the LM path's stage-A unit (tied head), then the RWKV path's (untied)
    # (drawn on the card: the host's draws of ~500M entries took seconds)
    sk_err, sk_ms, sk_plain, sk_bound, sk_by = sketch_row(
        torch, grad_sketch_units_op, grad_sketch_units_ref, SKETCH_MAIN, 0,
        dev, "lm", on_card=True)
    skr_err, skr_ms, skr_plain, skr_bound, skr_by = sketch_row(
        torch, grad_sketch_units_op, grad_sketch_units_ref, SKETCH_RWKV, 1,
        dev, "rwkv", on_card=True)
    sk4_err, sk4_ms, sk4_plain, sk4_bound, sk4_by = sketch_row(
        torch, grad_sketch_units_op, grad_sketch_units_ref, SKETCH_CHUNK, 2,
        dev, "lm chunk of 4 units", on_card=True)

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
    swa_ms, swa_plain, swa_lib, swa_bound, swa_by = swa_timed(
        torch, swa_attn_op, swa_attn_ref, SWA_MAIN, swa_abs, swa_margin,
        dev)
    # the dense archs' shapes (phase 16): gemma3-27b's prefill band, and
    # the three archs' stage-A units
    dense_rows = dense_kernel_rows(torch, dev)
    # the MoE archs' shapes (phase 17): the two untied heads' stage-A
    # units, the router-term Grams and mixtral-8x7b's prefill band
    moe_rows = moe_kernel_rows(torch, dev)
    # the recurrent families' shapes (phase 18): the band at head dim 256,
    # the WKV prefill with pad rows, recurrentgemma-9b's stage-A unit and
    # stage-B Gram
    hybrid_rows = hybrid_kernel_rows(torch, dev)
    # the encoder-decoder and VLM families' shapes (phase 19): the grad
    # sketch at both archs' stage-A units (V off the 128-wide tile)
    family_rows = family_kernel_rows(torch, dev)
    # long-context training (phase 20, 18c): the band's backward at the
    # edge and training shapes, the grad sketch at phase 20's unit
    mark("kernels")
    long_rows = long_kernel_rows(torch, dev)

    mark("kernels, the band's backward")

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
    cfg2 = dataclasses.replace(lm_cfg, n_layers=AGREE_LAYERS,
                               compute_dtype="float32")
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
    print(f"[agree] starcoder2-3b unit at full width, {AGREE_LAYERS} "
          f"layer(s), fp32 "
          f"(B={UNIT_SIZE}, S={LM_SEQ}, V={lm_cfg.vocab_size}): loss rel "
          f"err {loss_rel:.2e}, stage-A sketch err {unit_rel:.2e} of its "
          f"largest entry (card {out['cuda'][2]:.1f} s vs CPU "
          f"{out['cpu'][2]:.1f} s)", flush=True)
    require(loss_rel < 1e-4 and unit_rel < 1e-3,
            "card and CPU disagree on the full-width LM unit")
    serve_agreement(torch, lm2, p_cpu, dev, tree_map)
    del p_cpu, lm2

    rw_cfg = get_config("rwkv6-3b")
    rw2, p_cpu, proj_cpu, unit = rwkv_agree_setup(torch)
    rw_units, rw_val = make_units_for(rw_cfg, n=LM_N, seq=LM_SEQ, noise=0.0)

    def stage_a_keeps(held=None):
        # stage A copies the untied (d, V) head to (V, d) rows once a
        # unit (671 MB at full width); the copy must not outlive it
        torch.cuda.synchronize()
        if held is None:
            return torch.cuda.memory_allocated()
        kept = torch.cuda.memory_allocated() - held
        require(kept < 1e6, f"stage A kept {kept} bytes on the card after "
                            f"the unit")
    out = {"cuda": rwkv_agree_side(torch, rw2, p_cpu, proj_cpu, unit, dev,
                                   stage_a_keeps),
           "cpu": rwkv_cpu.result()}
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
    print(f"[agree] rwkv6-3b unit at full width, {AGREE_LAYERS} layer(s), "
          f"fp32 "
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
        engine="host",
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

    # F3 is held by phase 4's two training gradients and by the same-seed
    # repeats of 14a, 15a, 18c, 19a and 20b (phase 5's host-engine repeat
    # of its first two epochs, 30.6 s, went to pay for phase 20)
    first = rnnt_run_record(hist)

    # a stage-A round on the trained params (outside the counted run; 15b
    # replays resident stage A twice, bitwise)
    stage_a_rounds(torch, bundle, hist.final_params, units, val_units, tc.pgm,
                   dev, "rnnt", rounds=1)

    mark("main path, RNN-T")

    # -- 6. the reference's own loop: preemption and resume, the guard,
    # the dense loss, exact stage B, greedy decode and TER, the twin ----
    loop_launches, exact_gram = reference_loop(
        torch, np, bundle, tc, units, val_units, val_corpus, first,
        hist.final_params, dev, mark)

    # -- 7. where a training step's time goes (outside the counted run) --
    # the step and its warm-up call launch the lattice kernel through
    # the counter; the traced step must hold as many (14a reads both)
    n0 = rnnt_lattice_op.launches
    eager_step = profile_step(
        torch, bundle, tc, units, dev, hist.final_params, "rnnt",
        count={"rnnt_lattice": KERNEL_MARKERS["rnnt_lattice"]})
    eager_launches = {"rnnt_lattice": (rnnt_lattice_op.launches - n0) // 2}
    print(f"[profile rnnt] the step's launches {eager_launches}, its traced "
          f"kernels {eager_step[3]}", flush=True)
    require(eager_launches == eager_step[3]
            and eager_launches["rnnt_lattice"] > 0,
            f"an eager RNN-T step's launches {eager_launches} against its "
            f"traced kernels {eager_step[3]}")

    mark("profile, RNN-T")

    # -- 8. serving, RNN-T: streaming greedy search ---------------------
    # random weights: the 3-epoch model of phase 5 emits only blanks on
    # these utterances, which would hold nothing token for token
    del hist
    serve_rnnt(torch, np, bundle,
               bundle.init_params(torch.Generator().manual_seed(1), dev))

    mark("serving, RNN-T")

    # -- 9. main path, LM: starcoder2-3b at full width and depth ---------
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
        engine="host", params=card_init(torch, lm, dev),
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

    # -- 10. where an LM training step's time goes -----------------------
    profile_step(torch, lm, tc_lm, lm_units, dev, hist.final_params, "lm")
    stage_a_rounds(torch, lm, hist.final_params, lm_units, lm_val, tc_lm.pgm,
                   dev, "lm")

    mark("profile, LM")

    # -- 11. serving, LM: the same params at full depth ------------------
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

    # -- 12. main path, RWKV: rwkv6-3b at full width and depth -----------
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
        engine="host", params=card_init(torch, rw, dev),
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

    # -- 13. where an RWKV training step's time goes ---------------------
    profile_step(torch, rw, tc_lm, rw_units, dev, hist.final_params, "rwkv")
    stage_a_rounds(torch, rw, hist.final_params, rw_units, rw_val, tc_lm.pgm,
                   dev, "rwkv")
    del hist

    mark("profile, RWKV")

    # -- 14. the scanned epoch engine: captured steps, replayed ---------
    gc.collect()
    torch.cuda.empty_cache()
    sketch_gram = {"grad_sketch": (grad_sketch_units_op, "launches"),
                   "omp_gram": (omp_gram_batched_op, "launches")}
    scan_launches, scan_counted, rec_14a = scan_engine_phase(
        torch, np, bundle, tc, units, val_units, first, eager_step,
        {"lm": (lm_cfg, lm_units, lm_val, sketch_gram),
                    "rwkv": (rw_cfg, rw_units, rw_val, dict(
                        sketch_gram,
                        rwkv6_wkv=(rwkv6_wkv_op, "launches"),
                        rwkv6_wkv_bwd=(rwkv6_wkv_op, "bwd_launches")))},
        dev, mark)

    # -- 15. resident selection: stage A one graph a corpus, replayed ---
    gc.collect()
    torch.cuda.empty_cache()
    kept = {}
    resident = resident_phase(
        torch, np, bundle, tc, units, val_units, rec_14a,
        {"lm": (lm_cfg, lm_units, lm_val), "rwkv": (rw_cfg, rw_units,
                                                    rw_val)}, dev, mark,
        keep=kept)

    # -- 16. the other dense archs and examples: gemma3-27b served at
    # full width and depth from bf16 weights, the serving weights bitwise
    # the masters, the three archs trained at full width, the twins ------
    gc.collect()
    torch.cuda.empty_cache()
    dense = dense_phase(torch, np, dev, mark)

    # -- 17. the MoE family: olmoe-1b-7b served at full depth, mixtral-8x7b
    # at 21 layers, both trained with the router term, profiled --------
    gc.collect()
    torch.cuda.empty_cache()
    moe = moe_phase(torch, np, dev, mark)

    # -- 18. recurrent-state serving and the hybrid family: recurrentgemma-9b
    # and rwkv6-3b served at full width and depth, recurrentgemma-9b
    # trained at 3 layers, profiled ------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    hybrid = hybrid_phase(torch, np, dev, mark)

    # -- 19. the encoder-decoder and VLM families: seamless-m4t-medium and
    # paligemma-3b trained under PGM at full width and depth and served,
    # S11, card against CPU ---------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    family = family_phase(torch, np, dev, mark)

    # -- 20. long-context training through the band: starcoder2-3b at
    # full width and depth at S 8,192 with group remat, repeated at 6
    # layers, remat on against off, one layer card against CPU ---------
    gc.collect()
    torch.cuda.empty_cache()
    long = long_phase(torch, np, dev, mark)

    # -- 21. distribution at world size 1: the RNN-T path and the pod
    # step on a one-rank NCCL group, two ranks on the card over gloo ----
    gc.collect()
    torch.cuda.empty_cache()
    dist = dist_phase(torch, np, dev, mark, bundle, tc, units, val_units,
                      kept["15a"])

    # -- 22. the contracts' card side, the roofline and the dry run
    # against 20a's and 21b's steps ------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    roofline_phase(torch, np, dev, mark, card, long["times"], dist["times"])

    g_err, g_ms, g_plain, g_lib, g_bound, g_by = \
        gram_rows[(P_main, n_units // P_main, D_sk)]
    print(f"[launches] RNN-T path {launches}, its preempted and resumed "
          f"runs {loop_launches}, exact stage B {{'omp_gram': "
          f"{exact_gram['launches']}}}, LM path {lm_launches}, RWKV "
          f"path {rw_launches}, serving path {{'swa_attn': {swa_launches}}}, "
          f"scan engine {scan_launches} (counted in its runs "
          f"{scan_counted}), resident selection (traced in a replayed "
          f"round, counted at the warm-ups and captures) {resident}, the "
          f"dense archs (phase 16) {dense}, the MoE archs (phase 17) {moe}, "
          f"the recurrent families (phase 18) {hybrid}, the encoder-decoder "
          f"and VLM families (phase 19) {family}, long-context training "
          f"(phase 20; a step-graph kernel as (counted, nodes x replays)) "
          f"{ {k: v for k, v in long.items() if k != 'times'} }, "
          f"distribution (phase 21) "
          f"{ {k: v for k, v in dist.items() if k != 'times'} }",
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
        exact_gram,
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
    # the scan engine's runs (phase 14) launch the same kernels at the
    # same shapes (the 2-layer models have the full width): one row per
    # kernel and scan path.  A kernel of the captured step has the
    # launches of the replayed rows ("launches", its graph's nodes x the
    # replays) and
    # the warm-up steps' and the capture's ("counted", its scan run's
    # counter); a kernel outside the step has its scan run's count in both
    for row in list(kernels):
        base, kernel = row.get("path"), row["name"]
        src = {"rnnt": "rnnt", "lm": "lm", "rwkv": "rwkv"}.get(base)
        key = {"omp_gram_batched": "omp_gram",
               "grad_sketch_units": "grad_sketch"}.get(kernel, kernel)
        if src is not None and key in scan_launches.get(src, {}):
            kernels.append(dict(row, path=f"{src}-scan",
                                launches=scan_launches[src][key],
                                counted=scan_counted[src][key]))
    # phase 15's resident rounds: a kernel inside the stage-A graphs has
    # the instances one replayed round ran ("launches") and the
    # selector's warm-up and capture launches ("counted"); stage B's Gram
    # its count in both.  The kernels run at the same shapes as on the
    # host paths, but for the LM's chunk of 4 units (phase 3's U = 4 row)
    for row in list(kernels):
        base, kernel = row.get("path"), row["name"]
        key = {"omp_gram_batched": "omp_gram",
               "grad_sketch_units": "grad_sketch"}.get(kernel, kernel)
        got = resident.get(f"{base}-resident", {}).get(key)
        if got is not None:
            kernels.append(dict(row, path=f"{base}-resident",
                                launches=got[0], counted=got[1]))
    sk4 = resident["lm-resident-chunk4"]["grad_sketch"]
    kernels.append(
        {"name": "grad_sketch_units", "path": "lm-resident-chunk4",
         "route": "cuda",
         "source": "src/repro_torch/kernels/grad_sketch/csrc/grad_sketch.cu",
         "replaces": "src/repro/kernels/grad_sketch/kernel.py:128",
         "launches": sk4[0], "counted": sk4[1], "max_abs_err": sk4_err,
         "ms": sk4_ms, "plain_ms": sk4_plain, "bound_ms": sk4_bound,
         "bound_by": sk4_by, "library_ms": None})
    # phase 16: the band kernel at gemma3-27b's prefill, the grad sketch
    # at each dense arch's stage-A unit, with the Gram of each run's stage
    # B; launches counted in phase 16's runs (in a resident run, the
    # selector's warm-ups and captures)
    kernels.append(dict(
        dense_rows["swa_attn"], name="swa_attn", path="serve-gemma3-27b",
        route="cuda",
        source="src/repro_torch/kernels/swa_attn/csrc/swa_attn.cu",
        replaces="src/repro/kernels/swa_attn/kernel.py:79",
        launches=dense["serve-gemma3-27b"]["swa_attn"]))
    for arch, _ in DENSE_TRAIN:
        got = dense[f"{arch}-resident"]
        kernels.append(dict(
            dense_rows["grad_sketch"][arch], name="grad_sketch_units",
            path=f"{arch}-resident", route="cuda",
            source="src/repro_torch/kernels/grad_sketch/csrc/grad_sketch.cu",
            replaces="src/repro/kernels/grad_sketch/kernel.py:128",
            launches=got["grad_sketch"]))
        kernels.append(dict(gram, path=f"{arch}-resident",
                            launches=got["omp_gram"]))
    # phase 17: the band kernel at mixtral-8x7b's prefill with its serving
    # launches, and for each MoE arch's resident run the grad sketch at
    # its stage-A unit and the Gram at its router-term D (M6), with the
    # first run's counts (the selector's warm-ups and captures)
    kernels.append(dict(
        moe_rows["swa_attn"], name="swa_attn", path="serve-mixtral-8x7b",
        route="cuda",
        source="src/repro_torch/kernels/swa_attn/csrc/swa_attn.cu",
        replaces="src/repro/kernels/swa_attn/kernel.py:79",
        launches=moe["serve-mixtral-8x7b"]["swa_attn"]))
    for arch, _, _ in MOE_TRAIN:
        got = moe[f"{arch}-resident"]
        kernels.append(dict(
            moe_rows["grad_sketch"][arch], name="grad_sketch_units",
            path=f"{arch}-resident", route="cuda",
            source="src/repro_torch/kernels/grad_sketch/csrc/grad_sketch.cu",
            replaces="src/repro/kernels/grad_sketch/kernel.py:128",
            launches=got["grad_sketch"]))
        kernels.append(dict(
            moe_rows["omp_gram"][arch], name="omp_gram_batched",
            path=f"{arch}-resident", route="cuda",
            source="src/repro_torch/kernels/omp_gram/csrc/omp_gram.cu",
            replaces="src/repro/kernels/omp_gram/kernel.py:54",
            launches=got["omp_gram"]))
    # phase 18: the band at recurrentgemma-9b's prefill and the WKV
    # forward with pad rows, with their serving launches; the grad sketch
    # at recurrentgemma-9b's stage-A unit and its stage-B Gram, with the
    # first resident run's counts
    kernels.append(dict(
        hybrid_rows["swa_attn"], name="swa_attn",
        path="serve-recurrentgemma-9b", route="cuda",
        source="src/repro_torch/kernels/swa_attn/csrc/swa_attn.cu",
        replaces="src/repro/kernels/swa_attn/kernel.py:79",
        launches=hybrid["serve-recurrentgemma-9b"]["swa_attn"]))
    kernels.append(dict(
        hybrid_rows["rwkv6_wkv"], name="rwkv6_wkv", path="serve-rwkv6-3b",
        route="cuda",
        source="src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_wkv.cu",
        replaces="src/repro/kernels/rwkv6_scan/kernel.py:88",
        launches=hybrid["serve-rwkv6-3b"]["rwkv6_wkv"]))
    got = hybrid["recurrentgemma-9b-resident"]
    kernels.append(dict(
        hybrid_rows["grad_sketch"], name="grad_sketch_units",
        path="recurrentgemma-9b-resident", route="cuda",
        source="src/repro_torch/kernels/grad_sketch/csrc/grad_sketch.cu",
        replaces="src/repro/kernels/grad_sketch/kernel.py:128",
        launches=got["grad_sketch"]))
    kernels.append(dict(
        hybrid_rows["omp_gram"], name="omp_gram_batched",
        path="recurrentgemma-9b-resident", route="cuda",
        source="src/repro_torch/kernels/omp_gram/csrc/omp_gram.cu",
        replaces="src/repro/kernels/omp_gram/kernel.py:54",
        launches=got["omp_gram"]))
    # phase 19: the grad sketch at each family's stage-A unit and the Gram
    # of its stage B, with the first resident run's counts
    for arch, _, _ in FAMILY_TRAIN:
        path = ("encdec-resident" if arch.startswith("seamless")
                else "vlm-resident")
        got = family[path]
        kernels.append(dict(
            family_rows[arch], name="grad_sketch_units", path=path,
            route="cuda",
            source="src/repro_torch/kernels/grad_sketch/csrc/grad_sketch.cu",
            replaces="src/repro/kernels/grad_sketch/kernel.py:128",
            launches=got["grad_sketch"]))
        kernels.append(dict(gram, path=path, launches=got["omp_gram"]))
    # the band's backward (no pallas_call: it replaces jax.grad of the
    # reference's band gather) and the forward that writes lse, on the
    # training paths through the band: 18c (recurrentgemma-9b, the first
    # resident run's counts) and phase 20's full-depth run (a kernel of
    # the step graph with the warm-ups' and capture's launches plus its
    # graph's nodes x replays, "counted" the first) and its 6-layer runs
    swa_src = {"swa_attn": "src/repro_torch/kernels/swa_attn/csrc/swa_attn.cu",
               "swa_attn_bwd": "src/repro_torch/kernels/swa_attn/csrc/"
                               "swa_attn_bwd.cu"}
    for path, arch, got in (
            ("recurrentgemma-9b-resident", "recurrentgemma-9b",
             hybrid["recurrentgemma-9b-resident"]),
            ("starcoder2-3b-long", "starcoder2-3b",
             long["starcoder2-3b-long"]),
            (f"starcoder2-3b-long-{LONG_REPEAT_LAYERS}", "starcoder2-3b",
             long[f"starcoder2-3b-long-{LONG_REPEAT_LAYERS}"])):
        r = long_rows["swa_attn_bwd"][arch]
        for name, launched in (("swa_attn_bwd", got["swa_attn_bwd"]),
                               ("swa_attn", got["swa_attn"])):
            counted, graph = (launched if isinstance(launched, tuple)
                              else (launched, 0))
            fwd = name == "swa_attn"
            kernels.append({
                "name": name, "path": path, "route": "cuda",
                "source": swa_src[name],
                "replaces": ("src/repro/kernels/swa_attn/kernel.py:79" if fwd
                             else "jax.grad of src/repro/models/"
                                  "attention.py:_mha_band"),
                "launches": counted + graph, "counted": counted,
                "max_abs_err": r["fwd_max_abs_err" if fwd else "max_abs_err"],
                "ms": r["fwd_lse_ms" if fwd else "ms"],
                "plain_ms": r["fwd_plain_ms" if fwd else "plain_ms"],
                "bound_ms": r["fwd_bound_ms" if fwd else "bound_ms"],
                "bound_by": r["fwd_bound_by" if fwd else "bound_by"],
                "library_ms": r["fwd_library_ms" if fwd else "library_ms"]})
    got = long["starcoder2-3b-long"]
    kernels.append(dict(
        long_rows["grad_sketch"], name="grad_sketch_units",
        path="starcoder2-3b-long", route="cuda",
        source="src/repro_torch/kernels/grad_sketch/csrc/grad_sketch.cu",
        replaces="src/repro/kernels/grad_sketch/kernel.py:128",
        launches=got["grad_sketch"]))
    kernels.append(dict(gram, path="starcoder2-3b-long",
                        launches=got["omp_gram"]))
    # phase 21: the RNN-T path on the one-rank mesh (the lattice of its
    # step graph as (counted, nodes x replays)), the LM's resident round
    # on it, and the two gloo ranks' RNN-T run (their launches summed)
    row = lambda name, path: next(r for r in kernels if r["name"] == name
                                  and r.get("path") == path)
    for path, name, launched in (
            ("rnnt-mesh", "rnnt_lattice", dist["rnnt-mesh"]["rnnt_lattice"]),
            ("rnnt-mesh", "omp_gram", dist["rnnt-mesh"]["omp_gram"]),
            ("lm-mesh", "grad_sketch", (dist["lm-mesh"]["grad_sketch"], 0)),
            ("lm-mesh", "omp_gram", (dist["lm-mesh"]["omp_gram"], 0)),
            ("rnnt-mesh-gloo", "rnnt_lattice",
             (dist["rnnt-mesh-gloo"]["rnnt_lattice"], 0)),
            ("rnnt-mesh-gloo", "omp_gram",
             (dist["rnnt-mesh-gloo"]["omp_gram"], 0))):
        base = {"rnnt_lattice": row("rnnt_lattice", "rnnt"),
                "omp_gram": gram,
                "grad_sketch": row("grad_sketch_units", "lm")}[name]
        kernels.append(dict(base, path=path, launches=sum(launched),
                            counted=launched[0]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def phase_alone(phase: int, rows_only: bool = False) -> None:
    """``--phase N``: phases 1 and 2, then phase N on its own; with
    ``--rows`` (phases 16-20) only the phase's kernel rows, phase 3's
    checks and times of the kernels that phase runs."""
    t00 = time.time()
    require((SRC / "repro_torch" / "kernels" / "backend.py").is_file(),
            f"the port's sources are not beside this script ({SRC})")
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import backend

    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    dev = backend.resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[env] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    backend.fp32_numerics()
    backend.build()
    print(f"[build] the driver's graph node types {check_node_types()}",
          flush=True)

    def mark(p: str) -> None:
        print(f"[time] {p}: {time.time() - t00:.1f} s", flush=True)

    if phase in (21, 22):
        from repro_torch.configs.base import PGMConfig, TrainConfig
        from repro_torch.data.pipeline import asr_units
        from repro_torch.data.synthetic import make_asr_corpus
        from repro_torch.models.api import build_model
        from repro_torch.train.loop import train_with_selection

        bundle = build_model(get_config("rnnt-crdnn"))
        units = asr_units(make_asr_corpus(0, **CORPUS), UNIT_SIZE)
        val_units = asr_units(make_asr_corpus(7, N_VAL, **{
            k: v for k, v in CORPUS.items()
            if k not in ("n_examples", "noise_fraction", "snr_db")}),
            UNIT_SIZE)
        tc = TrainConfig(lr=0.5, optimizer="sgd", epochs=3, seed=0,
                         pgm=PGMConfig(subset_fraction=0.5, n_partitions=4,
                                       select_every=1, warm_start_epochs=1,
                                       val_matching=True))
        # 15a's run without a group, which 21a is held to
        h = train_with_selection(bundle, units, tc, method="pgm",
                                 val_units=val_units, device="cuda",
                                 engine="scan", resident_selection=True)
        torch.cuda.synchronize()
        rec = rnnt_run_record(h)
        del h
        mark("15a the RNN-T path, resident, without a group")
        long = long_phase(torch, np, dev, mark) if phase == 22 else None
        out = dist_phase(torch, np, dev, mark, bundle, tc, units, val_units,
                         rec)
        times = out.pop("times")
        if phase == 22:
            # 22 reads 20a's replayed step and 21b's plain step
            out = roofline_phase(torch, np, dev, mark, card,
                                 long.pop("times"), times)
    elif phase == 15:
        from repro_torch.configs.base import PGMConfig, TrainConfig
        from repro_torch.data.pipeline import asr_units
        from repro_torch.data.synthetic import make_asr_corpus
        from repro_torch.kernels.grad_sketch.ops import grad_sketch_units_op
        from repro_torch.kernels.grad_sketch.ref import grad_sketch_units_ref
        from repro_torch.launch.train import make_units_for
        from repro_torch.models.api import build_model
        from repro_torch.train.loop import train_with_selection

        sketch_row(torch, grad_sketch_units_op, grad_sketch_units_ref,
                   SKETCH_CHUNK, 2, dev, "lm chunk of 4 units")
        bundle = build_model(get_config("rnnt-crdnn"))
        units = asr_units(make_asr_corpus(0, **CORPUS), UNIT_SIZE)
        val_units = asr_units(make_asr_corpus(7, N_VAL, **{
            k: v for k, v in CORPUS.items()
            if k not in ("n_examples", "noise_fraction", "snr_db")}),
            UNIT_SIZE)
        tc = TrainConfig(lr=0.5, optimizer="sgd", epochs=3, seed=0,
                         pgm=PGMConfig(subset_fraction=0.5, n_partitions=4,
                                       select_every=1, warm_start_epochs=1,
                                       val_matching=True))
        h = train_with_selection(bundle, units, tc, method="pgm",
                                 val_units=val_units, device="cuda",
                                 engine="scan")
        torch.cuda.synchronize()
        mark("14a the RNN-T path on the scan engine with host stage A")
        rec = rnnt_run_record(h)
        del h
        models = {
            key: (cfg,) + make_units_for(cfg, n=LM_N, seq=LM_SEQ, noise=0.0)
            for key, cfg in (("lm", get_config("starcoder2-3b")),
                             ("rwkv", get_config("rwkv6-3b")))}
        out = resident_phase(torch, np, bundle, tc, units, val_units, rec,
                             models, dev, mark)
    else:
        rows_of, phase_of = {16: (dense_kernel_rows, dense_phase),
                             17: (moe_kernel_rows, moe_phase),
                             18: (hybrid_kernel_rows, hybrid_phase),
                             19: (family_kernel_rows, family_phase),
                             20: (long_kernel_rows, long_phase)}[phase]
        print(f"[kernels] {rows_of(torch, dev)}", flush=True)
        mark(f"phase {phase}'s kernel rows")
        if rows_only:
            print(card)
            return
        out = phase_of(torch, np, dev, mark)
    print(f"[launches] phase {phase} {out}", flush=True)
    print(card)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase"]:
        rows = sys.argv[3:] == ["--rows"]
        require((len(sys.argv) == 3 or rows)
                and sys.argv[2] in ("15", "16", "17", "18", "19", "20", "21",
                                    "22")
                and not (rows and sys.argv[2] in ("15", "21", "22")),
                "usage: chip_smoke.py [--phase 15|16|17|18|19|20|21|22 "
                "[--rows (not 15, 21, 22)]]")
        phase_alone(int(sys.argv[2]), rows)
    else:
        require(len(sys.argv) == 1, "usage: chip_smoke.py [--phase N]")
        main()
