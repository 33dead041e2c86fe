"""PyTorch port, the dry run (``repro_torch/launch/dryrun.py``) and its
sweep's records (``launch/sweep.py``, ``launch/roofline.py:table``).

- a full-size cell (``starcoder2-3b`` x ``train_4k``) completes on the
  CPU under fake tensors without allocating: the process's peak
  resident memory grows by far less than the 48 GB of fp32 params,
  gradients and AdamW moments it records, and its param bytes are the
  analytic ``n_params`` plus the norms that count leaves out, 4 bytes
  each;
- ``-smoke`` cells counted on fake tensors equal the same step counted
  on real CPU tensors: FLOPs, bytes, each kernel's calls and formula,
  the memory record (training through the band and through the WKV
  kernel, a prefill and a decode step);
- a mesh cell's collective schedule from the step's real
  ``MeshContext`` on a fake process group, at the ring models' wire
  bytes, bf16 on the pod axis in ``bf16`` mode;
- a refusal of the port's (an MoE batch that does not split into whole
  groups, hazard D7) is recorded, and the roofline table reads records.
"""
import json
import math
import resource

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.common import flatten_with_path, tree_leaves  # noqa: E402
from repro_torch.sharding.specs import SpecBuilder  # noqa: E402


def test_a_full_size_cell_runs_without_allocating():
    cfg = get_config("starcoder2-3b")
    r0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    rec = dryrun.run_cell("starcoder2-3b", "train_4k", mesh="none",
                          device="cpu", verbose=False)
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 - r0
    m = rec["memory"]
    assert rec["status"] == "ok" and rec["step"] == "train"
    norms = cfg.d_model * (2 * cfg.n_layers + 1)
    assert m["params"] == 4 * (cfg.n_params() + norms)
    assert m["grads"] == m["params"] and m["opt_state"] >= 2 * m["params"]
    assert m["params"] + m["grads"] + m["opt_state"] > 48e9
    assert grown < 2e9, grown
    assert m["activations"] > 0 and not rec["fits"]
    assert rec["rank_batch"] == 256 and rec["n_devices"] == 1
    assert rec["model_flops"] == roofline.model_flops("starcoder2-3b",
                                                      "train_4k", "train")
    # remat recomputes each group's forward: below 1 but above a half
    useful = rec["model_flops"] / rec["flops"]
    assert 0.5 < useful < 1.0, useful


# (arch, shape, step): the band at S past window + 1024 (smoke window
# 16), the WKV kernel at S % 64 == 0 and S >= 128; a prefill below the
# band (its check of the positions' form reads them back, which a fake
# run cannot and does not count)
SMOKE = [("starcoder2-3b-smoke", ShapeConfig("t", 1088, 1, "train"), "train"),
         ("rwkv6-3b-smoke", ShapeConfig("t", 128, 2, "train"), "train"),
         ("starcoder2-3b-smoke", ShapeConfig("p", 64, 2, "prefill"),
          "prefill"),
         ("gemma3-27b-smoke", ShapeConfig("d", 64, 2, "decode"), "decode")]


@pytest.mark.parametrize("case", range(len(SMOKE)))
def test_a_smoke_cell_counts_the_same_fake_and_real(case):
    arch, shape, step = SMOKE[case]
    kw = dict(step=step, mesh={}, device="cpu")
    fake = dryrun.build_and_count(arch, shape, **kw)
    real = dryrun.build_and_count(arch, shape, fake=False, **kw)
    for key in ("flops", "dot_flops", "kernel_flops", "bytes_accessed",
                "kernels", "memory", "rank_batch"):
        assert fake[key] == real[key], key
    if step == "train":
        want = {"starcoder2": {"swa_attn", "swa_attn_bwd"},
                "rwkv6": {"rwkv6_wkv", "rwkv6_wkv_bwd"}}[arch.split("-")[0]]
        assert set(fake["kernels"]) == want
        assert fake["memory"]["activations"] > 0


def test_a_mesh_cell_records_its_collective_schedule():
    shape = ShapeConfig("t", 16, 8, "train")
    mesh = {"pod": 2, "data": 2}
    recs = {mode: dryrun.run_cell("starcoder2-3b-smoke", "t", shape=shape,
                                  mesh=mesh, device="cpu", verbose=False,
                                  optimizer="sgd", compress_mode=mode)
            for mode in ("none", "bf16")}
    # a rank stores its shards (sharded storage): the elements it holds,
    # and those of the leaves whose spec names no axis (whole)
    n_stored = recs["none"]["memory"]["params"] // 4
    spec = SpecBuilder(mesh, mode="tp", pod_axis="pod")
    params = build_model(get_config("starcoder2-3b-smoke")).init_params(
        torch.Generator().manual_seed(0), torch.device("cpu"))
    whole = [l.numel() for p, l in flatten_with_path(params)
             if not any(spec.param_spec(p, l.shape))]
    n_whole, n_cut = sum(whole), len(tree_leaves(params)) - len(whole)
    for mode, rec in recs.items():
        assert rec["status"] == "ok" and rec["rank_batch"] == 2
        ar = rec["collectives"]["all_reduce"]
        # the weight sums and the metrics over data and pod, the data
        # axis's fp32 mean of the whole leaves' gradients, the clip's sum
        # of the shards' squares over their storage group, the pod axis's
        # compressed mean of every gradient the rank stores
        assert ar["count"] == 7
        grad_bytes = n_whole * 4 + n_stored * (2 if mode == "bf16" else 4)
        assert abs(ar["bytes"] - grad_bytes) < 64 + 4 * n_cut
        assert math.isclose(ar["wire_bytes"], ar["bytes"], rel_tol=1e-9)
        # each gathered leaf: one fp32 reduce-scatter of its gradient into
        # the shard, a gather in the forward and one in the backward (a
        # remat group's recompute); but the stack's two leaves whose spec
        # splits the layer axis are gathered whole once, before the
        # groups, and the tied embedding three times (the lookup, the
        # head, and the head's saved weight unpacked; the lookup saves
        # no weight)
        rs = rec["collectives"]["reduce_scatter_tensor"]
        ag = rec["collectives"]["all_gather_into_tensor"]
        assert rs["count"] > 0 and ag["count"] == 2 * rs["count"] - 2 + 1
        assert rs["bytes"] == 4 * (n_stored - n_whole)
    assert recs["bf16"]["wire_bytes"] < recs["none"]["wire_bytes"]



def test_refusals_and_records_reach_the_table(tmp_path):
    shape = ShapeConfig("t", 16, 4, "train")
    rec = dryrun.run_cell("olmoe-1b-7b-smoke", "t", shape=shape,
                          mesh={"data": 4}, device="cpu", verbose=False,
                          out_path=str(tmp_path / "a.json"))
    assert rec["status"] == "refused" and "D7" in rec["reason"]
    ok = dryrun.run_cell("starcoder2-3b-smoke", "t", shape=shape,
                         mesh={"data": 2}, device="cpu", verbose=False,
                         out_path=str(tmp_path / "b.json"))
    assert json.loads((tmp_path / "b.json").read_text())["status"] == "ok"
    table = roofline.table(str(tmp_path))
    assert "starcoder2-3b-smoke" in table and "olmoe" not in table
    assert ok["status"] == "ok" and ok["n_devices"] == 2
