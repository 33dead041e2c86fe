"""Roofline of the port on an NVIDIA H100, from op counts
(``launch/op_analysis.py``) and dry-run records (``launch/dryrun.py``):
the counterpart of the reference's ``repro/launch/roofline.py``, whose
constants are another device's.

Per record, per rank:
  compute_term    = FLOPs / PEAK_FLOPS
  memory_term     = HBM bytes / HBM_BW
  collective_term = wire bytes / NVLINK_BW
and ``model_flops`` (6 N D training, 2 N D prefill, 2 N a decoded token;
N the active params), the useful ratio (model FLOPs over counted FLOPs:
remat and redundancy lower it) and the roofline fraction.  ``mfu`` is a
measured step's share of the card: model FLOPs over wall time over
``PEAK_FLOPS``, the metric a benchmark's step share reads.

  python -m repro_torch.launch.roofline [artifacts/dryrun_torch]
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.configs import SHAPES, get_config, get_shape

# NVIDIA H100 SXM5 80GB HBM3 at its 700 W limit, the published dense
# peaks (no sparsity)
PEAK_FLOPS = 989e12          # bf16 tensor cores, FLOP/s
PEAK_TF32 = 495e12           # TF32 tensor cores, FLOP/s
PEAK_FP32 = 67e12            # fp32 SIMT (FMA), FLOP/s
HBM_BW = 3.35e12             # HBM3, B/s
NVLINK_BW = 450e9            # NVLink 4, B/s each direction (900 GB/s both)
HBM_BYTES = 80e9             # device memory


def step_model_flops(cfg, batch: int, seq: int, step: str) -> float:
    """Ideal model FLOPs of one step over ``batch`` sequences of ``seq``
    tokens (global): 6*N*D for training, 2*N*D for prefill, 2*N*tokens
    for decode (one token per sequence); N the active params."""
    n_active = cfg.n_active_params()
    if step == "train":
        tokens = batch * seq
        return 6.0 * n_active * tokens
    if step == "prefill":
        tokens = batch * seq
        return 2.0 * n_active * tokens
    tokens = batch                          # decode: 1 new token per seq
    return 2.0 * n_active * tokens


def model_flops(arch: str, shape_name: str, step: str) -> float:
    """The reference's model FLOPs of a named (arch, shape) cell."""
    shape = get_shape(shape_name)
    return step_model_flops(get_config(arch), shape.global_batch,
                            shape.seq_len, step)


def ideal_decode_bytes(arch: str, shape_name: str, n_dev: int) -> float:
    """Decode is memory-bound by construction: the floor per step is
    reading the active params (bf16) + the KV/state cache once."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    params_b = cfg.n_active_params() * 2
    cache_b = 0.0
    for kind in cfg.layer_kinds():
        if kind in ("attn", "global"):
            cache_b += (shape.global_batch * shape.seq_len * cfg.kv_dim
                        * 2 * 2)
        elif kind == "local":
            cache_b += (shape.global_batch * min(cfg.window or shape.seq_len,
                                                 shape.seq_len)
                        * cfg.kv_dim * 2 * 2)
        elif kind == "rwkv":
            cache_b += (shape.global_batch * cfg.n_heads
                        * cfg.rwkv_head_dim ** 2 * 4)
        elif kind == "rec":
            cache_b += shape.global_batch * (cfg.lru_width or cfg.d_model) * 4
    return (params_b + cache_b) / n_dev


def mfu(model_flops_: float, seconds: float) -> float:
    """A measured step's model FLOP utilisation: model FLOPs over wall
    time over the bf16 peak."""
    return model_flops_ / seconds / PEAK_FLOPS


def generic_terms(rec: Dict) -> Dict:
    """Roofline terms from a record's per-rank ``flops``,
    ``bytes_accessed`` and ``wire_bytes``."""
    flops = rec.get("flops") or 0.0
    bytes_acc = rec.get("bytes_accessed") or 0.0
    wire = rec.get("wire_bytes") or 0.0
    compute_t = flops / PEAK_FLOPS
    memory_t = bytes_acc / HBM_BW
    coll_t = wire / NVLINK_BW
    return {
        "compute_s": compute_t,
        "memory_s": memory_t,
        "collective_s": coll_t,
        "dominant": max([("compute", compute_t), ("memory", memory_t),
                         ("collective", coll_t)], key=lambda kv: kv[1])[0],
        "bound_s": max(compute_t, memory_t, coll_t, 1e-30),
        "flops_per_byte": (flops / bytes_acc) if bytes_acc else None,
    }


def roofline_terms(rec: Dict) -> Dict:
    """``generic_terms`` of a dry-run record plus its model FLOPs a rank,
    the useful ratio and the roofline fraction (decode: the ideal bytes'
    time over the bound; else the model FLOPs' time over it)."""
    terms = generic_terms(rec)
    n_dev = rec["n_devices"]
    mf = rec.get("model_flops")
    if mf is None:
        mf = model_flops(rec["arch"], rec["shape"], rec["step"])
    mf_per_dev = mf / n_dev
    flops = rec.get("flops") or 0.0
    if rec["step"] == "decode" and rec["shape"] in SHAPES:
        frac = ideal_decode_bytes(rec["arch"], rec["shape"], n_dev) \
            / HBM_BW / terms["bound_s"]
    else:
        frac = mf_per_dev / PEAK_FLOPS / terms["bound_s"]
    terms.update(model_flops_per_dev=mf_per_dev, flops_per_dev=flops,
                 useful_ratio=(mf_per_dev / flops) if flops else None,
                 roofline_fraction=frac)
    return terms


def selection_round_records(n_examples: int = 32, seq: int = 12,
                            unit_size: int = 2,
                            arch: str = "starcoder2-3b-smoke"
                            ) -> List[Dict]:
    """One PGM selection round (stage A's grad sketch over every unit,
    stage B's partitioned Gram and OMP) counted on the CPU with the
    selection kernels' route ``auto`` and ``xla``: the two records are
    the same work, since each kernel counts by its formula whichever
    route computes it."""
    import torch

    from repro_torch.configs.base import PGMConfig
    from repro_torch.core.lastlayer import make_proj_for, \
        units_gradients_batched
    from repro_torch.core.pgm import partitioned_gm
    from repro_torch.data.pipeline import lm_units
    from repro_torch.data.synthetic import make_lm_corpus
    from repro_torch.launch.op_analysis import count_ops
    from repro_torch.models.api import build_model

    cfg = get_config(arch)
    bundle = build_model(cfg)
    corpus = make_lm_corpus(0, n_examples, seq, cfg.vocab_size,
                            hard_fraction=0.4)
    units = {k: torch.as_tensor(v)
             for k, v in lm_units(corpus, unit_size=unit_size).items()}
    n_units = int(units["tokens"].shape[0])
    dev = torch.device("cpu")
    params = bundle.init_params(torch.Generator().manual_seed(0), dev)
    proj = make_proj_for(bundle, torch.Generator().manual_seed(17), 32, 32,
                         dev)
    recs = []
    for impl in ("auto", "xla"):
        pc = PGMConfig(subset_fraction=0.3, n_partitions=4, sketch_dim_h=32,
                       sketch_dim_v=32, kernel_impl=impl)
        budget = max(int(pc.subset_fraction * n_units) // pc.n_partitions, 1)
        with torch.no_grad(), count_ops() as c:
            g = units_gradients_batched(bundle, params, units, proj,
                                        kernel_impl=impl)
            partitioned_gm(g, pc.n_partitions, budget, pc.lam, pc.eps,
                           pc.nonneg_weights, kernel_impl=impl)
        rec = {"variant": f"selection_round[{impl}]", "kernel_impl": impl,
               "arch": arch, "n_units": n_units, "flops": c.flops,
               "bytes_accessed": c.bytes, "wire_bytes": c.wire_bytes,
               "kernels": c.to_dict()["kernels"]}
        rec["terms"] = generic_terms(rec)
        recs.append(rec)
    return recs


def load_artifacts(art_dir: str = "artifacts/dryrun_torch") -> List[Dict]:
    out = []
    for p in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(p) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            continue
        rec["terms"] = roofline_terms(rec)
        out.append(rec)
    return out


def table(art_dir: str = "artifacts/dryrun_torch",
          mesh: Optional[str] = None) -> str:
    rows = [r for r in load_artifacts(art_dir)
            if mesh is None or r["mesh"] == mesh]
    hdr = (f"{'arch':22s} {'shape':12s} {'mesh':18s} {'step':7s} "
           f"{'compute_s':>10s} {'memory_s':>10s} {'coll_s':>10s} "
           f"{'domin':>10s} {'useful':>7s} {'roofl%':>7s} {'GB/rank':>8s} "
           f"{'fits':>5s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        t = r["terms"]
        ur = f"{t['useful_ratio']:.2f}" if t["useful_ratio"] else "n/a"
        lines.append(
            f"{r['arch']:22s} {r['shape']:12s} {r['mesh']:18s} "
            f"{r['step']:7s} {t['compute_s']:10.4f} {t['memory_s']:10.4f} "
            f"{t['collective_s']:10.4f} {t['dominant']:>10s} {ur:>7s} "
            f"{100 * t['roofline_fraction']:6.1f}% "
            f"{r['memory']['total'] / 1e9:8.1f} {str(r['fits']):>5s}")
    return "\n".join(lines)


if __name__ == "__main__":
    import sys
    print(table(sys.argv[1] if len(sys.argv) > 1
                else "artifacts/dryrun_torch"))
