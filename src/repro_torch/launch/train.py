"""Training launcher of the port (the reference's
``repro.launch.train``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch rnnt-crdnn \
      --method pgm --epochs 6 [--noise 0.2 --snr-db 5] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
      --seq 512 --method pgm --epochs 3 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \
      --seq 512 --method pgm --epochs 3 --lr 0.05 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch recurrentgemma-9b-smoke --seq 24 --method pgm --epochs 3 \
      [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch rnnt-crdnn \
      --optimizer adamw --lr 0.05 --ckpt DIR [--resume] \
      [--nonfinite-guard --max-skipped-steps 4] [--loss-impl dense] \
      [--exact-gradients] [--engine scan|host] [--epoch-chunk N] \
      [--resident-selection] [--selection-kernels auto|pallas|xla]

Runs on the card unless ``--device cpu`` is given, and prints the same
``epoch N: train X val Y lr Z`` lines as the reference.  RNN-T archs
train on the synthetic ASR corpus, LMs (dense, MoE, RWKV6 and the
RG-LRU hybrid) on the
synthetic LM corpus of ``--seq`` tokens; the encoder-decoder and VLM
families are refused (ROADMAP S12).  ``--noise`` corrupts that fraction of training
examples (additive feature noise at ``--snr-db`` for ASR, corrupted
labels for LM) and turns validation matching on.  ``--ckpt DIR`` writes
a checkpoint after every epoch in the reference's format, ``--resume``
continues from the newest intact one; ``--nonfinite-guard`` gates
non-finite steps off on the device and ``--max-skipped-steps K`` arms
the divergence watchdog.  ``--engine scan`` (the default) trains
through the scanned epoch engine, one captured CUDA graph of the step
replayed over each epoch's plan, and ``--epoch-chunk N`` runs up to N
epochs at a time with validation and newbob on the device;
``--engine host`` is the per-batch loop.  ``--resident-selection`` runs
PGM stage A over the engine's device-resident units, on the card as one
captured CUDA graph per unit corpus replayed every round.
``--selection-kernels xla`` runs the selection round's grad sketch and
Gram as their plain versions on the card (``auto`` and ``pallas``, the
reference's other values, launch the kernels).

Distribution: one process a rank, started by ``torchrun`` (whose
environment gives the ranks):

  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
      --arch starcoder2-3b-smoke --device cpu --mesh 2x2 \
      --mesh-axes data,pod --compress-mode topk [--compress-k-frac 0.05] \
      [--spec-mode tp|expert|fsdp_sp|fsdp_batch]

``--mesh AxB`` over the two ``--mesh-axes`` (default ``data,model``)
trains data-parallel with params whole on every rank (``train/engine.py``),
selection's stage B spread over ``data``; a ``pod`` axis averages the
pods' gradients through ``--compress-mode``.  Gloo on the CPU, NCCL on
the card (a card a rank).  A mesh whose size is not the number of
ranks raises, saying how to launch.  Rank 0 alone prints.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import PGMConfig, TrainConfig
from repro_torch.data.pipeline import asr_units, lm_units
from repro_torch.data.synthetic import make_asr_corpus, make_lm_corpus
from repro_torch.kernels.backend import fp32_numerics, resolve_device
from repro_torch.models.api import build_model
from repro_torch.train.loop import METHODS, History, train_with_selection


def parse_mesh(spec: Optional[str], axes: str = "data,model",
               device_type: str = "cuda"):
    """``'2x4'`` -> a 2-axis ``DeviceMesh`` over ``axes`` (comma
    separated; ``data,pod`` is the two-level mesh of the compressed pod
    collective), joining the process group ``torchrun`` set up;
    ``None``/``''`` -> no mesh."""
    if not spec:
        return None
    from repro_torch.launch.mesh import (check_world, init_distributed,
                                         make_mesh)
    dims = tuple(int(x) for x in spec.lower().split("x"))
    names = tuple(a.strip() for a in axes.split(","))
    if len(dims) != 2 or len(names) != 2:
        raise ValueError(f"mesh spec must be AxB over two named axes, "
                         f"got {spec!r} over {axes!r}")
    check_world(dims, names)
    init_distributed(device_type)
    return make_mesh(dims, names, device_type)


def make_units_for(cfg, *, n: int, noise: float, seq: int = 24,
                   seed: int = 0, unit_size: int = 4, snr_db: float = 10.0):
    """(train units, val units) for the arch family, as the reference
    builds them: RNN-T gets the ASR corpus, an LM the LM corpus of
    ``seq`` tokens; validation (seed + 7) stays clean.  The reference
    gives the encoder-decoder and VLM families LM units too, which carry
    no ``frames`` and no ``patches``, so its training run dies on them
    (ROADMAP S12); the port refuses them here.  Train those through
    ``train_with_selection`` on units stacked from the bundle's
    ``make_batch``."""
    if cfg.family in ("encdec", "vlm"):
        raise ValueError(
            f"{cfg.name}: the launcher's corpora carry no "
            f"{'frames' if cfg.family == 'encdec' else 'patches'} for the "
            f"{cfg.family!r} family (ROADMAP S12: the reference's launcher "
            f"feeds it LM units); stack units from the bundle's make_batch "
            f"and call train_with_selection")
    if cfg.family == "rnnt":
        r = cfg.rnnt
        corpus = make_asr_corpus(seed, n, n_feats=r.n_feats,
                                 vocab_size=r.vocab_size,
                                 noise_fraction=noise, snr_db=snr_db)
        vc = make_asr_corpus(seed + 7, max(n // 4, 8), n_feats=r.n_feats,
                             vocab_size=r.vocab_size)
        return asr_units(corpus, unit_size), asr_units(vc, unit_size)
    corpus = make_lm_corpus(seed, n, seq, cfg.vocab_size,
                            noise_fraction=noise)
    vc = make_lm_corpus(seed + 7, max(n // 4, 8), seq, cfg.vocab_size)
    return lm_units(corpus, unit_size), lm_units(vc, unit_size)


def launch_train(arch: str, tc: TrainConfig, *, method: str = "pgm",
                 n: int = 96, seq: int = 24, noise: float = 0.0,
                 snr_db: float = 10.0, loss_impl: Optional[str] = None,
                 engine: str = "scan", resident_selection: bool = False,
                 epoch_chunk: int = 1,
                 ckpt_dir: Optional[str] = None,
                 resume: bool = False, device: Optional[str] = None,
                 mesh=None, data_axis: str = "data", spec_mode: str = "tp",
                 batch_units: int = 1, log_fn=print) -> History:
    cfg = get_config(arch)
    if loss_impl is not None and cfg.family == "rnnt":
        cfg = dataclasses.replace(
            cfg, rnnt=dataclasses.replace(cfg.rnnt, loss_impl=loss_impl))
    units, val = make_units_for(cfg, n=n, seq=seq, noise=noise,
                                seed=tc.seed, snr_db=snr_db)
    return train_with_selection(build_model(cfg), units, tc, method=method,
                                val_units=val, ckpt_dir=ckpt_dir,
                                resume=resume, engine=engine,
                                resident_selection=resident_selection,
                                epoch_chunk=epoch_chunk, device=device,
                                mesh=mesh, data_axis=data_axis,
                                spec_mode=spec_mode, batch_units=batch_units,
                                log_fn=log_fn)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--method", default="pgm", choices=list(METHODS))
    ap.add_argument("--engine", default="scan", choices=["scan", "host"],
                    help="'scan': the scanned epoch engine (a captured "
                         "CUDA graph of the step replayed over the plan); "
                         "'host': the per-batch loop")
    ap.add_argument("--resident-selection", action="store_true",
                    help="PGM stage A as one batched pass over the "
                         "device-resident units (no host round-trip per "
                         "selection round; on the card one captured CUDA "
                         "graph a unit corpus, replayed every round)")
    ap.add_argument("--epoch-chunk", type=int, default=1,
                    help="run up to N epochs as one scan-engine call "
                         "(validation and newbob on the device; metrics "
                         "read once a chunk)")
    ap.add_argument("--mesh", default=None,
                    help="AxB, e.g. 2x2 (default: no mesh): one process "
                         "a rank under torchrun, the batch data-parallel "
                         "over the mesh, params whole on every rank")
    ap.add_argument("--mesh-axes", default="data,model",
                    help="names of the two mesh axes; 'data,pod' builds "
                         "the two-level data x pod mesh whose pod axis "
                         "runs the compressed gradient collective")
    ap.add_argument("--compress-mode", default="none",
                    choices=["none", "bf16", "topk"],
                    help="gradient compressor on the 'pod' mesh axis "
                         "(train/compress.py): bf16 halves the "
                         "collective's wire width, topk sends the k "
                         "largest entries a leaf with error feedback; "
                         "needs --mesh-axes data,pod")
    ap.add_argument("--compress-k-frac", type=float, default=0.05,
                    help="top-k fraction a gradient leaf for "
                         "--compress-mode topk")
    ap.add_argument("--spec-mode", default="tp",
                    choices=["tp", "expert", "fsdp_sp", "fsdp_batch"],
                    help="SpecBuilder policy, whose batch axes split "
                         "the batch (fsdp_batch: every axis but pod and "
                         "expert)")
    ap.add_argument("--subset", type=float, default=0.3)
    ap.add_argument("--partitions", type=int, default=4)
    ap.add_argument("--select-every", type=int, default=5)
    ap.add_argument("--warm-start", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--n", type=int, default=96)
    ap.add_argument("--seq", type=int, default=24,
                    help="tokens per example of the LM corpus")
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adamw"])
    ap.add_argument("--noise", type=float, default=0.0,
                    help="fraction of corrupted training examples "
                         "(feature noise for ASR, label noise for LM)")
    ap.add_argument("--snr-db", type=float, default=10.0,
                    help="SNR of the injected feature noise (dB)")
    ap.add_argument("--loss-impl", default=None, choices=["fused", "dense"],
                    help="RNN-T loss path: the fused lattice (default) or "
                         "the dense autodiff oracle")
    ap.add_argument("--exact-gradients", action="store_true",
                    help="paper-faithful exact last-layer gradients "
                         "(no sketching)")
    ap.add_argument("--selection-kernels", default="auto",
                    choices=["auto", "pallas", "xla"],
                    help="selection-round kernels (PGMConfig.kernel_impl): "
                         "'auto' and 'pallas' launch the CUDA grad-sketch "
                         "and Gram kernels on the card, 'xla' runs their "
                         "plain versions there; the CPU always runs the "
                         "plain versions")
    ap.add_argument("--nonfinite-guard", action="store_true",
                    help="gate NaN/Inf steps off on the device (a "
                         "bit-exact no-op, no host branch) and count them")
    ap.add_argument("--max-skipped-steps", type=int, default=0,
                    help="divergence watchdog: this many consecutive "
                         "guarded-off steps roll back to the last good "
                         "checkpoint with a re-keyed batch plan (0 = "
                         "never; needs --nonfinite-guard)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (one checkpoint an epoch)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest intact checkpoint")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    fp32_numerics()
    mesh = parse_mesh(args.mesh, args.mesh_axes, device.type)
    if mesh is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    tc = TrainConfig(
        lr=args.lr, optimizer=args.optimizer, epochs=args.epochs,
        seed=args.seed,
        compress_mode=args.compress_mode,
        compress_k_frac=args.compress_k_frac,
        nonfinite_guard=args.nonfinite_guard,
        max_skipped_steps=args.max_skipped_steps,
        pgm=PGMConfig(subset_fraction=args.subset,
                      n_partitions=args.partitions,
                      select_every=args.select_every,
                      warm_start_epochs=args.warm_start,
                      val_matching=args.noise > 0,
                      use_sketch=not args.exact_gradients,
                      kernel_impl=args.selection_kernels))
    h = launch_train(args.arch, tc, method=args.method, n=args.n,
                     seq=args.seq, noise=args.noise, snr_db=args.snr_db,
                     loss_impl=args.loss_impl, engine=args.engine,
                     resident_selection=args.resident_selection,
                     epoch_chunk=args.epoch_chunk, ckpt_dir=args.ckpt,
                     resume=args.resume, device=str(device), mesh=mesh,
                     spec_mode=args.spec_mode)
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    if mesh is not None:
        torch.distributed.destroy_process_group()
    if h.val_loss and rank0:
        print(f"done: val {h.val_loss[-1]:.4f}, "
              f"cost {h.cost_units:.2f} epoch-units, "
              f"wall {h.wall_time:.1f}s on {device}")
    return h


if __name__ == "__main__":
    main()
