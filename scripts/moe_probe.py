"""Phase 17 of ``chip_smoke.py`` (the MoE family) on its own, on one
card:

    python3 scripts/moe_probe.py

from the root of a checkout.  It builds the kernels, checks and times
the grad sketch at both MoE archs' stage-A units, the Gram at their
router-term stage-B shapes and the band kernel at mixtral-8x7b's
prefill (``chip_smoke.moe_kernel_rows``), then runs
``chip_smoke.moe_phase`` and prints the card's name and power limit and
the phase's per-kernel launch counts.  Any failed check exits non-zero.
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
    from repro_torch.kernels import backend

    t00 = time.time()
    dev = backend.resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[env] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    backend.fp32_numerics()
    backend.build()
    rows = cs.moe_kernel_rows(torch, dev)
    print(f"[kernels] {rows}", flush=True)
    out = cs.moe_phase(
        torch, np, dev,
        lambda p: print(f"[time] {p}: {time.time() - t00:.1f} s",
                        flush=True))
    print(f"[launches] the MoE archs (phase 17) {out}", flush=True)
    print(card)


if __name__ == "__main__":
    main()
