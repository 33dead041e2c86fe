"""PyTorch port, the two-level ``data x pod`` step (``repro_torch/train/
engine.py`` ``PodSpec`` and ``MeshContext``, ``train/compress.py``) on
4 gloo ranks, against the JAX reference on the CPU.

- The pod step on a 2 x 2 data x pod mesh in ``none``, ``bf16`` and
  ``topk`` (k_frac 0.1), against the reference's (2, 2) data x pod
  ``EpochEngine`` on 4 host devices (one subprocess for the file), two
  full-data epochs from the reference's initial draws: every rank reads
  the same losses, within 1e-3 relative of the reference's.  The
  reference's mesh has ``Auto`` axes: JAX 0.9.0's ``jax.make_mesh``
  defaults to ``Explicit`` axes, which the reference engine's
  ``with_sharding_constraint`` refuses (the reason its own pod tests in
  ``tests/test_compressed_engine.py`` fail under it).
- A ``topk`` run cut after 2 of 4 epochs and resumed from its
  checkpoint reproduces the uninterrupted run's last epochs bitwise (its
  per-pod residuals restored under ``err``), with no reshard line, and
  the manifest carries ``mesh_shape`` and ``compress_mode``.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import lm_units  # noqa: E402
from repro.data.synthetic import make_lm_corpus  # noqa: E402
from torch_dist_helpers import spawn  # noqa: E402
from torch_dist_ranks import topk_resume, train_runs  # noqa: E402
from torch_engine_helpers import _reference_draws  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
MODES = ("none", "bf16", "topk")
_POD_REF = """
import sys
import numpy as np, jax
from jax.sharding import AxisType
from repro.configs import get_config
from repro.configs.base import PGMConfig, TrainConfig
from repro.models.api import build_model
from repro.train.loop import train_with_selection
assert jax.device_count() == 4
inp = np.load(sys.argv[1], allow_pickle=True)
units, val = inp["units"].item(), inp["val"].item()
mesh = jax.make_mesh((2, 2), ("data", "pod"),
                     axis_types=(AxisType.Auto,) * 2)
m = build_model(get_config("starcoder2-3b-smoke"))
out = {}
for mode in ("none", "bf16", "topk"):
    tc = TrainConfig(lr=0.5, optimizer="sgd", epochs=2, compress_mode=mode,
                     compress_k_frac=0.1, pgm=PGMConfig())
    h = train_with_selection(m, units, tc, method="full", val_units=val,
                             engine="scan", mesh=mesh, batch_units=2)
    out[mode + "_train"] = np.asarray(h.train_loss)
    out[mode + "_val"] = np.asarray(h.val_loss)
np.savez(sys.argv[2], **out)
print("POD-REF-OK")
"""


def _pod_units():
    cfg = jax_get_config("starcoder2-3b-smoke")
    units = lm_units(make_lm_corpus(0, 16, 12, cfg.vocab_size,
                                    hard_fraction=0.4), 4)
    val = lm_units(make_lm_corpus(7, 8, 12, cfg.vocab_size), 4)
    return units, val


@pytest.fixture(scope="module")
def pod_reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("pod_ref")
    units, val = _pod_units()
    np.savez(d / "in.npz", units=np.array(units, dtype=object),
             val=np.array(val, dtype=object))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(_POD_REF),
                        str(d / "in.npz"), str(d / "out.npz")],
                       capture_output=True, text=True, env=env, timeout=400)
    assert p.returncode == 0 and "POD-REF-OK" in p.stdout, p.stderr[-3000:]
    with np.load(d / "out.npz") as z:
        return {k: z[k] for k in z.files}


def test_pod_step_matches_reference_pod_engine(pod_reference, tmp_path):
    units, val = _pod_units()
    _, params, proj = _reference_draws("starcoder2-3b-smoke")
    run = dict(lr=0.5, optimizer="sgd", epochs=2)
    runs = [("starcoder2-3b-smoke", "scan", units, val, run, {}, params,
             proj, {"method": "full", "batch_units": 2,
                    "tc": {"compress_mode": mode, "compress_k_frac": 0.1}})
            for mode in MODES]
    got = spawn(train_runs, 4, tmp_path, runs, (2, 2), ("data", "pod"))
    for i, mode in enumerate(MODES):
        for r in range(1, 4):
            assert got[r][i] == got[0][i], (mode, r)
        np.testing.assert_allclose(got[0][i]["train_loss"],
                                   pod_reference[mode + "_train"],
                                   rtol=1e-3, atol=0, err_msg=mode)
        np.testing.assert_allclose(got[0][i]["val_loss"],
                                   pod_reference[mode + "_val"],
                                   rtol=1e-3, atol=0, err_msg=mode)


def test_topk_resume_is_bitwise(tmp_path):
    units, val = _pod_units()
    _, params, proj = _reference_draws("starcoder2-3b-smoke")
    got = spawn(topk_resume, 4, tmp_path, units, val, params, proj,
                str(tmp_path))
    full, res, manifest, logs = got[0]
    assert len(full["selections"]) == 2
    assert res["train_loss"] == full["train_loss"][2:]
    assert res["val_loss"] == full["val_loss"][2:]
    assert [s["indices"] for s in res["selections"]] == \
        [s["indices"] for s in full["selections"][1:]]
    assert manifest["mesh_shape"] == {"data": 2, "pod": 2}
    assert manifest["compress_mode"] == "topk"
    assert any("'err'" in k for k in manifest["arrays"])
    assert all(meta["shape"][0] == 2 for k, meta in
               manifest["arrays"].items() if k.startswith("['err']"))
    assert not any("resharded" in line for line in logs)
    assert "resumed at epoch 2" in logs
    for r in range(1, 4):
        assert got[r][:3] == got[0][:3]
        assert got[r][3] == []          # rank 0 alone logs
