"""Train a decoder LM with PGM subset selection, the twin of the
reference's ``examples/train_lm_pgm.py`` (any ported ``--arch``; smoke
variants run on the CPU in seconds, full configs on the card).

  PYTHONPATH=src python -m repro_torch.examples.train_lm_pgm
      --arch starcoder2-3b-smoke [--method pgm] [--subset 0.3]
      [--epochs 6] [--n 96] [--noise 0.0] [--engine scan|host]
      [--ckpt DIR] [--resume] [--selection-kernels auto|pallas|xla]
      [--device cpu]

``--engine scan`` (the default) runs each epoch as one captured CUDA
graph of the step replayed over the plan; ``--engine host`` is the
per-batch loop kept as the parity oracle.  ``--selection-kernels xla``
runs the round's grad sketch and Gram as their plain versions on the
card (``PGMConfig.kernel_impl``).  Runs on the card unless ``--device
cpu`` is given, and prints the reference's lines; the initial draws
come from a ``torch.Generator`` unless handed in (``run(params=...,
proj=...)``).
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional

from repro_torch.configs import get_config
from repro_torch.configs.base import PGMConfig, TrainConfig
from repro_torch.data.pipeline import lm_units
from repro_torch.data.synthetic import make_lm_corpus
from repro_torch.kernels.backend import fp32_numerics, resolve_device
from repro_torch.models.api import build_model
from repro_torch.train.loop import METHODS, train_with_selection


def run(*, arch: str = "starcoder2-3b-smoke", method: str = "pgm",
        subset: float = 0.3, epochs: int = 6, n: int = 96, seq: int = 24,
        noise: float = 0.0, engine: str = "scan", ckpt: Optional[str] = None,
        resume: bool = False, kernel_impl: str = "auto",
        device: Optional[str] = None, params=None, proj=None,
        log_fn: Callable[[str], None] = print):
    """The reference example's run: the LM corpus (seed 0, 40% hard
    examples, ``noise`` of them with corrupted labels) in units of 4,
    validation of seed 99, SGD at lr 0.5, PGM every 2 epochs after 1
    warm epoch over 4 partitions with 32 x 32 sketches, validation
    matching when ``noise`` > 0.  -> History."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    bundle = build_model(cfg)
    corpus = make_lm_corpus(0, n, seq, cfg.vocab_size, hard_fraction=0.4,
                            noise_fraction=noise)
    units = lm_units(corpus, unit_size=4)
    val = lm_units(make_lm_corpus(99, max(n // 4, 8), seq, cfg.vocab_size),
                   unit_size=4)
    tc = TrainConfig(
        lr=0.5, optimizer="sgd", epochs=epochs,
        pgm=PGMConfig(subset_fraction=subset, n_partitions=4,
                      select_every=2, warm_start_epochs=1,
                      sketch_dim_h=32, sketch_dim_v=32,
                      val_matching=noise > 0, kernel_impl=kernel_impl))
    h = train_with_selection(bundle, units, tc, method=method,
                             val_units=val, ckpt_dir=ckpt, resume=resume,
                             engine=engine, device=str(dev), params=params,
                             proj=proj, log_fn=log_fn)
    if h.val_loss:
        log_fn(f"\nfinal: val loss {h.val_loss[-1]:.4f}, cost "
               f"{h.cost_units:.2f} full-epoch units, "
               f"{len(h.selections)} selection rounds")
    return h


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b-smoke")
    ap.add_argument("--method", default="pgm", choices=list(METHODS))
    ap.add_argument("--subset", type=float, default=0.3)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--n", type=int, default=96)
    ap.add_argument("--seq", type=int, default=24)
    ap.add_argument("--noise", type=float, default=0.0)
    ap.add_argument("--engine", default="scan", choices=["scan", "host"])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--selection-kernels", default="auto",
                    choices=["auto", "pallas", "xla"],
                    help="PGMConfig.kernel_impl: 'xla' runs the selection "
                         "round's plain versions on the card")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)
    fp32_numerics()
    return run(arch=args.arch, method=args.method, subset=args.subset,
               epochs=args.epochs, n=args.n, seq=args.seq, noise=args.noise,
               engine=args.engine, ckpt=args.ckpt, resume=args.resume,
               kernel_impl=args.selection_kernels, device=args.device)


if __name__ == "__main__":
    main()
