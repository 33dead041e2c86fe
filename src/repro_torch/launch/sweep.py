"""Dry-run sweep of the port: every (arch x shape) cell of
``configs.cells`` on the single-pod and multi-pod meshes, each in a
subprocess of its own with a time limit (a fake process group is one
per process).  Records go to ``artifacts/dryrun_torch/*.json``; skipped
cells (a full-attention arch at 500k tokens) are recorded too.  The
counterpart of the reference's ``repro/launch/sweep.py``.

  python -m repro_torch.launch.sweep [--only arch] [--shape name]
      [--mesh single|multi|both] [--device cuda|cpu] [--jobs N]
      [--timeout S] [--force]
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import time

from repro_torch.configs import cells

ART = os.path.join("artifacts", "dryrun_torch")


def cell_path(arch: str, shape: str, mesh: str) -> str:
    return os.path.join(ART, f"{arch}__{shape}__{mesh}.json")


def run_one(arch: str, shape: str, mesh: str, device: str,
            timeout: int) -> str:
    out = cell_path(arch, shape, mesh)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--mesh", mesh, "--device", device,
           "--out", out]
    t0 = time.time()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout)
    except subprocess.TimeoutExpired:
        return f"TIMEOUT after {timeout} s"
    if p.returncode != 0:
        tail = "\n".join(p.stderr.strip().splitlines()[-15:])
        return f"FAIL ({time.time() - t0:.0f} s):\n{tail}"
    with open(out) as f:
        rec = json.load(f)
    if rec["status"] != "ok":
        return f"refused ({time.time() - t0:.0f} s): {rec['reason']}"
    return (f"ok ({time.time() - t0:.0f} s): "
            f"{rec['memory']['total'] / 1e9:.1f} GB a rank, fits "
            f"{rec['fits']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.sweep")
    ap.add_argument("--only", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    os.makedirs(ART, exist_ok=True)
    todo = []
    for arch, shape, status in cells(include_skips=True):
        if (args.only and arch != args.only) or \
                (args.shape and shape != args.shape):
            continue
        if status == "skip":
            with open(cell_path(arch, shape, "skipped"), "w") as f:
                json.dump({"arch": arch, "shape": shape, "status": "skip",
                           "reason": "full-attention arch at 500k tokens"},
                          f)
            continue
        for mesh in meshes:
            if args.force or not os.path.exists(cell_path(arch, shape,
                                                          mesh)):
                todo.append((arch, shape, mesh))
    print(f"{len(todo)} cells to run", flush=True)
    failures = 0
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        futs = {pool.submit(run_one, *cell, args.device, args.timeout): cell
                for cell in todo}
        for i, fut in enumerate(concurrent.futures.as_completed(futs)):
            arch, shape, mesh = futs[fut]
            msg = fut.result()
            print(f"[{i + 1}/{len(todo)}] {arch} x {shape} x {mesh}: {msg}",
                  flush=True)
            failures += not msg.startswith(("ok", "refused"))
    print(f"done; {failures} failures", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
