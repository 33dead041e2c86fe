"""Quickstart of the port, the twin of the reference's
``examples/quickstart.py``: PGM data-subset selection on a tiny LM.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Walks the paper's loop once: a corpus with easy/hard structure,
per-unit last-layer gradient sketches, partitioned gradient matching
(Algorithm 1/2), and training on the weighted subset, against
Random-Subset and full-data training.  Runs on the card unless
``--device cpu`` is given, and prints the reference's lines.  The
initial draws come from a ``torch.Generator`` (the reference draws from
``jax.random``), so the numbers differ from the reference example's
unless its draws are handed in (``run(params=..., proj=...)``).
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
from repro_torch.train.loop import train_with_selection

ARCH = "starcoder2-3b-smoke"
METHODS = ("pgm", "random", "full")


def run(*, device: Optional[str] = None, params=None, proj=None,
        log_fn: Callable[[str], None] = print):
    """The reference example's runs: 64 examples of 16 tokens in units of
    4 (validation: 16 examples of seed 9), SGD at lr 0.5 for 5 epochs,
    PGM every 2 epochs after 1 warm epoch over 4 partitions with 32 x 32
    sketches, for ``pgm``, ``random`` and ``full``, each from the same
    initial draws.  -> {method: History}."""
    dev = resolve_device(device)
    cfg = get_config(ARCH)
    bundle = build_model(cfg)
    corpus = make_lm_corpus(seed=0, n_examples=64, seq_len=16,
                            vocab_size=cfg.vocab_size, hard_fraction=0.4)
    units = lm_units(corpus, unit_size=4)
    val = lm_units(make_lm_corpus(9, 16, 16, cfg.vocab_size), unit_size=4)
    tc = TrainConfig(
        lr=0.5, optimizer="sgd", epochs=5,
        pgm=PGMConfig(subset_fraction=0.3, n_partitions=4, select_every=2,
                      warm_start_epochs=1, sketch_dim_h=32, sketch_dim_v=32))
    results = {}
    for method in METHODS:
        h = train_with_selection(
            bundle, units, tc, method=method, val_units=val, device=str(dev),
            params=params, proj=proj,
            log_fn=lambda s, m=method: log_fn(f"  [{m}] {s}"))
        results[method] = h
        log_fn(f"{method:7s}: final val loss {h.val_loss[-1]:.4f}, "
               f"cost {h.cost_units:.2f} full-epoch units")
    sp = results["full"].cost_units / results["pgm"].cost_units
    log_fn(f"\nPGM speedup vs full training: {sp:.2f}x "
           f"(paper reports 2.6-6.3x at production scale)")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)
    fp32_numerics()
    return run(device=args.device)


if __name__ == "__main__":
    main()
