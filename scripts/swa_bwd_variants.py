"""Variants of the band's backward kernel, side by side on one card.

    python3 scripts/swa_bwd_variants.py

Builds the backward's source (``src/repro_torch/kernels/swa_attn/csrc/
swa_attn_bwd.cu``) as it is and in variants made by editing its text:

* ``whole128``: at head dim 128 each dk / dv warpgroup owns 64 keys and
  all 128 output columns (the head dim split only at 256);
* ``dqsplit128``: dq's two warpgroups split the head dim from 128 on, as
  dk / dv do, instead of only at 256;
* ``regs224`` and ``regs232``: ``setmaxnreg`` gives the consumers 224
  registers a thread and the producer 56, or 232 and 40, instead of 240
  and 24.

One ``nvcc`` a variant, all started together, into a temporary directory.
It prints ptxas's register and spill report for each tensor-core kernel,
holds every variant at ``chip_smoke.py``'s three training shapes
(``SWA_BWD_TRAIN``) with that script's ``swa_bwd_err`` (the plain backward
at one bf16 ulp plus 1e-5 of the largest gradient, autograd of the plain
forward, two launches bitwise), times the variants in turns (CUDA events,
two rounds) on the same inputs, and splits the source's own backward
into its four kernels under the profiler.  The card's name and power
limit come first.  Needs one card.
"""
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "swa_attn" / "csrc"


def _edit(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"swa_bwd_variants: {old!r} is not in the source")
    return text.replace(old, new)


def variants(src: str) -> dict:
    whole = _edit(src, "DkdvTile = BwdTc<HD, (HD > 64)>",
                  "DkdvTile = BwdTc<HD, (HD > 128)>")
    dqsplit = _edit(src, "DqTile = BwdTc<HD, (HD > 128)>",
                    "DqTile = BwdTc<HD, (HD > 64)>")
    out = {"source": src, "whole128": whole, "dqsplit128": dqsplit}
    for consumer, producer in ((224, 56), (232, 40)):
        regs = src
        for old, new in (("setmaxnreg.dec.sync.aligned.u32 24",
                          f"setmaxnreg.dec.sync.aligned.u32 {producer}"),
                         ("setmaxnreg.inc.sync.aligned.u32 240",
                          f"setmaxnreg.inc.sync.aligned.u32 {consumer}"),
                         ("PRODUCER_REGS = 24", f"PRODUCER_REGS = {producer}"),
                         ("CONSUMER_REGS = 240",
                          f"CONSUMER_REGS = {consumer}")):
            regs = _edit(regs, old, new)
        out[f"regs{consumer}"] = regs
    return out


def build(texts: dict, out: Path) -> dict:
    from repro_torch.kernels import backend

    (out / "hopper.cuh").write_bytes((CSRC / "hopper.cuh").read_bytes())
    procs = {}
    for name, text in texts.items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [backend._nvcc(), *backend.NVCC_FLAGS, "-o",
             str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"swa_bwd_variants: {name} did not build\n{log}")
        kernel = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '.*?"
                          r"(dq_tc_kernel|dkdv_tc_kernel)ILi(\d+)", line)
            if m:
                kernel = f"{m.group(1)}<{m.group(2)}>"
            elif "Compiling entry" in line:
                kernel = None
            elif kernel and ("spill" in line or "Used" in line):
                print(f"[ptxas] {name} {kernel}: {line.strip()}")
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


def main() -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import backend
    from repro_torch.kernels.swa_attn.ops import _launch, swa_attn_bwd

    if not torch.cuda.is_available():
        raise SystemExit("swa_bwd_variants: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"[env] {card.splitlines()[0]} | torch {torch.__version__}",
          flush=True)
    backend.fp32_numerics()
    backend.build(["swa_attn"])
    dev = torch.device("cuda")
    src = (CSRC / "swa_attn_bwd.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(variants(src), Path(tmp))
        for name, lib in libs.items():
            backend._LIBS["swa_attn_bwd"] = lib
            for arch, shape in cs.SWA_BWD_TRAIN:
                err, margin, auto = cs.swa_bwd_err(torch, shape, dev)
                print(f"[held] {name} {arch}: max abs err {err:.3e}, "
                      f"{margin:.3f} of the bar, {auto:.2e} from autograd",
                      flush=True)
            torch.cuda.empty_cache()
        for arch, shape in cs.SWA_BWD_TRAIN:
            q, k, v, dout, _ = cs.swa_bwd_inputs(torch, shape, dev)
            W = shape[5]
            out, lse = _launch(q, k, v, None, W, with_lse=True)
            runs = {name: [] for name in libs}
            for _ in range(2):
                for name, lib in libs.items():
                    backend._LIBS["swa_attn_bwd"] = lib
                    runs[name].append(cs.cuda_ms(torch, lambda: swa_attn_bwd(
                        q, k, v, out, lse, dout, W), reps=3, warmup=1))
            print(f"[ms] {arch} {shape[:6]}: " + "; ".join(
                f"{n} {sum(t) / 2:.4f} ({t[0]:.4f}, {t[1]:.4f})"
                for n, t in runs.items()), flush=True)
            backend._LIBS["swa_attn_bwd"] = libs["source"]
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    swa_attn_bwd(q, k, v, out, lse, dout, W)
                torch.cuda.synchronize()
            parts = []
            for e in prof.key_averages():
                t = getattr(e, "self_device_time_total", 0)
                m = re.search(r"swa_bwd_(\w+?)_(?:tc_)?kernel", e.key)
                if t > 0 and m:
                    parts.append(f"{m.group(1)} {t / e.count / 1e3:.4f}")
            print(f"[split] {arch}: source's kernels, ms a call: "
                  + ", ".join(parts), flush=True)
            del q, k, v, dout, out, lse
            torch.cuda.empty_cache()
        backend._LIBS.pop("swa_attn_bwd", None)


if __name__ == "__main__":
    main()
