"""PyTorch port, the data axis (``repro_torch/train/engine.py``
``MeshContext``, ``train/loop.py`` with a mesh) on 2 gloo ranks, against
the JAX reference on the CPU.

On a (2,) data mesh, ``rnnt-crdnn-smoke`` and ``starcoder2-3b-smoke`` on
both engines: a warm epoch, a PGM round and a subset epoch, from the
reference's initial draws.  Held against the reference's single-device
engine within 1e-3 relative on each epoch's loss (its own bar for a
sharded run against one device) with the same subsets, and against the
port's one-device run within 1e-5 relative.  With the guard on, a
padding row and a NaN in one rank's examples leave the state bitwise on
every rank (ROADMAP hazard D5).

``torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train
--mesh 2x2 --mesh-axes data,pod --compress-mode topk`` (ranks from
torchrun's environment) exits 0 and prints each epoch's line once, from
rank 0.

The pod step is held in ``tests/test_torch_dist_pod.py``, resume and
the launcher against the reference in ``tests/test_torch_dist_launch.py``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

from repro.configs.base import PGMConfig as JaxPGMConfig  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train.loop import train_with_selection as jax_train  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import PGMConfig, TrainConfig  # noqa: E402
from repro_torch.kernels.backend import fp32_numerics  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.train.loop import train_with_selection  # noqa: E402
from torch_dist_helpers import spawn  # noqa: E402
from torch_dist_ranks import guard_checks, history, train_runs  # noqa: E402
from torch_engine_helpers import _reference_draws, _setup  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ("rnnt-crdnn-smoke", "starcoder2-3b-smoke")


def _two_epochs(arch):
    units, val, run, sel = _setup(arch)
    return units, val, dict(run, epochs=2), dict(sel, select_every=1)


def _assert_close(got, want, rtol, what):
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=0,
                                   err_msg=f"{what} {key}")
    assert [s["indices"] for s in got["selections"]] == \
        [s["indices"] for s in want["selections"]], what
    for a, b in zip(got["selections"], want["selections"]):
        np.testing.assert_allclose(a["weights"], b["weights"], atol=1e-4)


@pytest.fixture(scope="module")
def data_axis_runs(tmp_path_factory):
    """Every (arch, engine) at 2 ranks (one spawn), the reference's
    single-device run and the port's one-device run of each arch."""
    fp32_numerics()
    runs, ref, one = [], {}, {}
    for arch in ARCHS:
        units, val, run, sel = _two_epochs(arch)
        mj, params, proj = _reference_draws(arch)
        ref[arch] = history(jax_train(
            mj, units, JaxTrainConfig(**run, pgm=JaxPGMConfig(**sel)),
            method="pgm", val_units=val, engine="host"))
        one[arch] = history(train_with_selection(
            build_model(get_config(arch)), units,
            TrainConfig(**run, pgm=PGMConfig(**sel)), method="pgm",
            val_units=val, engine="host", device="cpu", params=params,
            proj=proj))
        for engine in ("scan", "host"):
            runs.append((arch, engine, units, val, run, sel, params, proj,
                         {"method": "pgm"}))
    got = spawn(train_runs, 2, tmp_path_factory.mktemp("data_axis"), runs,
                (2,), ("data",))
    return runs, got, ref, one


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("engine", ["scan", "host"])
def test_data_axis_matches_reference_and_one_device(data_axis_runs, arch,
                                                    engine):
    runs, got, ref, one = data_axis_runs
    i = next(i for i, r in enumerate(runs) if r[:2] == (arch, engine))
    ranks = [g[i] for g in got]
    assert ranks[0] == ranks[1]         # every rank reads the same losses
    assert len(ranks[0]["selections"]) == 1
    _assert_close(ranks[0], ref[arch], 1e-3, f"{arch} {engine} vs reference")
    _assert_close(ranks[0], one[arch], 1e-5, f"{arch} {engine} vs one device")
    assert ranks[0]["cost_units"] == pytest.approx(one[arch]["cost_units"])


def test_guard_and_padding_rows_on_the_data_axis(tmp_path):
    """D5 at 2 ranks: a padding row and a NaN in rank 1's examples leave
    params and optimizer state bitwise on both ranks, the NaN step
    flagged skipped on both; a live row moves them.  D7: an MoE engine
    whose rank share splits the reference's token group raises."""
    arch = "starcoder2-3b-smoke"
    units, _, run, sel = _two_epochs(arch)
    _, params, _ = _reference_draws(arch)
    got = spawn(guard_checks, 2, tmp_path, arch, units, run, sel, params)
    for pad_held, nan_held, skipped, moved, d7 in got:
        assert pad_held and nan_held and moved
        assert skipped == 1.0
        # D7: 2 examples x 12 tokens, one group of 24 in the reference;
        # a rank's 12 tokens cannot reproduce it
        assert d7 is not None and "M1 and D7" in d7, d7


LAUNCH = ["--arch", "starcoder2-3b-smoke", "--device", "cpu", "--mesh",
          "2x2", "--mesh-axes", "data,pod", "--compress-mode", "topk",
          "--compress-k-frac", "0.1", "--epochs", "3", "--n", "16",
          "--warm-start", "1", "--select-every", "1", "--partitions", "2"]


def test_launcher_under_torchrun():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train"]
        + LAUNCH,
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.splitlines()
    for e in range(3):
        assert sum(ln.startswith(f"epoch {e}: train ") for ln in lines) == 1
    assert sum(ln.startswith("done: val ") for ln in lines) == 1


def test_world_of_one_is_the_one_device_run(data_axis_runs, tmp_path):
    """A group of one on a (1, 1) data x pod mesh (compress ``none``) and
    on a (1,) data mesh: every epoch's loss, subset and weight bitwise the
    one-device run's (the bar ``chip_smoke.py`` phase 21a holds on the
    card), on both engines, with resident rounds on the scan engine."""
    runs, _, _, one = data_axis_runs
    arch = "rnnt-crdnn-smoke"
    units, val, run, sel = _two_epochs(arch)
    _, params, proj = _reference_draws(arch)
    base = (arch, "scan", units, val, run, sel, params, proj)
    resident = {"method": "pgm", "resident_selection": True}
    want = train_with_selection(
        build_model(get_config(arch)), units,
        TrainConfig(**run, pgm=PGMConfig(**sel)), val_units=val,
        engine="scan", device="cpu", params=params, proj=proj, **resident)
    for shape, axes in (((1, 1), ("data", "pod")), ((1,), ("data",))):
        got = spawn(train_runs, 1, tmp_path, [base + (dict(resident),),
                                              base[:1] + ("host",) + base[2:]
                                              + ({"method": "pgm"},)],
                    shape, axes)[0]
        assert got[0] == history(want), axes
        assert got[1] == one[arch], axes
