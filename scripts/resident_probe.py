"""Phase 15 of ``chip_smoke.py`` (resident selection) on its own, on one
card, in about a third of the whole script's time:

    python3 scripts/resident_probe.py

from the root of a checkout.  It builds the kernels, checks and times
the grad-sketch kernel at the LM resident path's chunk of 4 units
(``chip_smoke.SKETCH_CHUNK``), runs phase 14a's RNN-T main path once on
the scan engine with host stage A (the reference run that phase 15a is
held against), then ``chip_smoke.resident_phase``, and prints the card's
name and power limit and the phase's per-kernel launch counts.  Any
failed check exits non-zero.
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PGMConfig, TrainConfig
    from repro_torch.data.pipeline import asr_units
    from repro_torch.data.synthetic import make_asr_corpus
    from repro_torch.kernels import backend
    from repro_torch.kernels.grad_sketch.ops import grad_sketch_units_op
    from repro_torch.kernels.grad_sketch.ref import grad_sketch_units_ref
    from repro_torch.launch.train import make_units_for
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import train_with_selection

    t00 = time.time()
    dev = backend.resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[env] {card}", flush=True)
    backend.fp32_numerics()
    backend.build()
    cs.sketch_row(torch, grad_sketch_units_op, grad_sketch_units_ref,
                  cs.SKETCH_CHUNK, 2, dev, "lm chunk of 4 units")
    bundle = build_model(get_config("rnnt-crdnn"))
    corpus = make_asr_corpus(0, **cs.CORPUS)
    val_corpus = make_asr_corpus(7, cs.N_VAL, **{
        k: v for k, v in cs.CORPUS.items()
        if k not in ("n_examples", "noise_fraction", "snr_db")})
    units = asr_units(corpus, cs.UNIT_SIZE)
    val_units = asr_units(val_corpus, cs.UNIT_SIZE)
    tc = TrainConfig(lr=0.5, optimizer="sgd", epochs=3, seed=0,
                     pgm=PGMConfig(subset_fraction=0.5, n_partitions=4,
                                   select_every=1, warm_start_epochs=1,
                                   val_matching=True))
    t0 = time.time()
    h = train_with_selection(bundle, units, tc, method="pgm",
                             val_units=val_units, device="cuda",
                             engine="scan")
    torch.cuda.synchronize()
    print(f"[14a] {time.time() - t0:.1f} s on the scan engine with host "
          f"stage A; rounds (stage A + B) "
          f"{[round(s['seconds'], 3) for s in h.selections]} s", flush=True)
    rec = cs.rnnt_run_record(h)
    del h
    lm_cfg, rw_cfg = get_config("starcoder2-3b"), get_config("rwkv6-3b")
    models = {"lm": (lm_cfg,) + make_units_for(lm_cfg, n=cs.LM_N,
                                               seq=cs.LM_SEQ, noise=0.0),
              "rwkv": (rw_cfg,) + make_units_for(rw_cfg, n=cs.LM_N,
                                                 seq=cs.LM_SEQ, noise=0.0)}
    out = cs.resident_phase(
        torch, np, bundle, tc, units, val_units, rec, models, dev,
        lambda p: print(f"[time] {p}: {time.time() - t00:.1f} s",
                        flush=True))
    print(f"[launches] resident selection (traced in a replayed round, "
          f"counted at the warm-ups and captures) {out}", flush=True)
    print(card)


if __name__ == "__main__":
    main()
