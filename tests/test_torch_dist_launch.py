"""PyTorch port, resharded checkpoints and the launcher's mesh
(``repro_torch/train/loop.py``, ``train/checkpoint.py``,
``launch/train.py`` ``--mesh``, ``--mesh-axes``, ``--compress-mode``,
``--compress-k-frac``, ``--spec-mode``) on gloo ranks, on the CPU.

- A checkpoint written at 2 ranks (a (2,) data mesh; whole arrays from
  rank 0, ``mesh_shape`` in the manifest) restores at 1 rank and at 4,
  each printing the reference's ``resharded checkpoint (saved mesh ...
  -> current ...)`` line, and the resumed epoch's losses are within
  1e-5 relative of the uninterrupted 2-rank run's.  At 4 ranks the
  partitions do not divide the data axis, so stage B runs whole on every
  rank (ROADMAP hazard D4).
- ``repro_torch.launch.train --mesh 2x2 --mesh-axes data,pod
  --compress-mode topk`` on 4 ranks, its run given the reference's
  initial draws, prints the reference launcher's loss lines (its
  ``launch_train`` on 4 host devices, one subprocess for the file, its
  mesh's axes ``Auto`` as in ``tests/test_torch_dist_pod.py``): the
  same selections, every number within 1e-3 relative; rank 0 alone
  prints.  (The launch under
  ``torchrun`` is held in ``tests/test_torch_dist_engine.py``.)
- The config errors raise with the reference's messages: a compressor
  without a pod axis, a batch that does not split into the pods, a mesh
  spec of three axes; a mesh whose size is not the world's says how to
  launch, the production 16 x 16 and 2 x 16 x 16 meshes among them.
"""
import os
import re
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402

import repro.launch.train as jax_launcher  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.core.lastlayer import make_proj_for as jax_make_proj  # noqa: E402
from repro.data.pipeline import lm_units  # noqa: E402
from repro.data.synthetic import make_lm_corpus  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.train.engine import EpochEngine as JaxEpochEngine  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from torch_dist_helpers import spawn  # noqa: E402
from torch_dist_ranks import (launcher_lines, reshard_resume,  # noqa: E402
                              reshard_save)
from torch_engine_helpers import _reference_draws, _setup  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCH = "starcoder2-3b-smoke"
LAUNCH = ["--arch", ARCH, "--mesh", "2x2", "--mesh-axes", "data,pod",
          "--compress-mode", "topk", "--compress-k-frac", "0.1",
          "--epochs", "3", "--n", "16", "--warm-start", "1",
          "--select-every", "1", "--partitions", "2", "--subset", "0.5"]


def _odd_units():
    cfg = jax_get_config(ARCH)
    return lm_units(make_lm_corpus(0, 12, 10, cfg.vocab_size), 3)


# -- resharded restore --------------------------------------------------------

def test_checkpoint_from_two_ranks_restores_at_one_and_four(tmp_path):
    units, val, _, _ = _setup(ARCH)
    _, params, proj = _reference_draws(ARCH)
    got = spawn(reshard_save, 2, tmp_path, units, val, params, proj,
                str(tmp_path))
    whole = got[0]
    assert got[1] == got[0]
    # the run as if cut after epoch 1: its later checkpoint taken away
    cut = tmp_path / "cut"
    shutil.copytree(tmp_path / "whole", cut)
    shutil.rmtree(cut / "step_2")
    (cut / "LATEST").write_text("1")
    manifest = ckpt.read_manifest(str(cut))
    assert manifest["mesh_shape"] == {"data": 2}
    assert manifest["compress_mode"] is None
    assert manifest["extra"]["epoch"] == 1
    for world, now in ((1, "None"), (4, "{'data': 4}")):
        d = tmp_path / f"cut{world}"
        shutil.copytree(tmp_path / "cut", d)
        if world == 1:
            hist, logs = reshard_resume(0, 1, units, val, params, proj,
                                        str(d))
        else:
            hist, logs = spawn(reshard_resume, world, tmp_path, units, val,
                               params, proj, str(d))[0]
        assert f"resharded checkpoint (saved mesh {{'data': 2}} -> " \
            f"current {now})" in logs, logs
        assert "resumed at epoch 2" in logs
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(hist[key], whole[key][2:], rtol=1e-5,
                                       atol=0, err_msg=f"{world} {key}")


# -- the launcher -------------------------------------------------------------

_REF = """
import io, sys, contextlib
import numpy as np, jax
from jax.sharding import AxisType
from repro.configs import get_config
from repro.configs.base import PGMConfig, TrainConfig
from repro.data.pipeline import lm_units
from repro.data.synthetic import make_lm_corpus
from repro.launch.train import launch_train
from repro.models.api import build_model
from repro.train.engine import EpochEngine
assert jax.device_count() == 4
mesh = jax.make_mesh((2, 2), ("data", "pod"),
                     axis_types=(AxisType.Auto,) * 2)
tc = TrainConfig(lr=0.5, optimizer="sgd", epochs=3, seed=0,
                 compress_mode="topk", compress_k_frac=0.1,
                 pgm=PGMConfig(subset_fraction=0.5, n_partitions=2,
                               select_every=1, warm_start_epochs=1,
                               val_matching=False, use_sketch=True,
                               kernel_impl="auto"))
lines = []
launch_train("starcoder2-3b-smoke", tc, n=16, mesh=mesh,
             log_fn=lines.append)
cfg = get_config("starcoder2-3b-smoke")
odd = lm_units(make_lm_corpus(0, 12, 10, cfg.vocab_size), 3)
try:
    EpochEngine(build_model(cfg), TrainConfig(compress_mode="bf16"), odd,
                batch_units=1, mesh=mesh)
    lines.append("ODD-ACCEPTED")
except ValueError as e:
    lines.append("ODD " + str(e))
print("\\n".join(lines))
print("LAUNCH-REF-OK")
"""


@pytest.fixture(scope="module")
def reference_lines():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode == 0 and "LAUNCH-REF-OK" in p.stdout, \
        p.stderr[-3000:]
    return p.stdout.splitlines()


def _numbers(line):
    return [float(x) for x in re.findall(r"-?\d+\.\d+|nan", line)]


def test_launcher_prints_the_reference_lines(reference_lines, tmp_path):
    mj = jax_build(jax_get_config(ARCH))
    key = jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, mj.init_params(key))
    proj = [np.asarray(x) for x in jax_make_proj(
        mj, jax.random.fold_in(key, 17), 64, 64)]
    got = spawn(launcher_lines, 4, tmp_path, LAUNCH + ["--device", "cpu"],
                params, proj, _odd_units())
    lines, odd = got[0]
    for r in range(1, 4):
        assert got[r][0] == []              # rank 0 alone prints
        assert got[r][1] == odd
    want = [ln for ln in reference_lines if ln.startswith("epoch ")]
    mine = [ln for ln in lines if ln.startswith("epoch ")]
    assert len(mine) == len(want) == 5, (mine, want)
    for a, b in zip(mine, want):
        assert a.split(":")[0] == b.split(":")[0]
        if "selected" in b:
            assert a.split("(")[0] == b.split("(")[0]
        np.testing.assert_allclose(_numbers(a), _numbers(b), rtol=1e-3,
                                   err_msg=f"{a!r} vs {b!r}")
    assert lines[-1].startswith("done: val ")
    ref_odd = next(ln for ln in reference_lines if ln.startswith("ODD"))
    assert ref_odd == "ODD " + odd, (ref_odd, odd)


def test_config_errors_carry_the_reference_messages():
    mj = jax_build(jax_get_config(ARCH))
    units = _odd_units()
    with pytest.raises(ValueError) as want:
        JaxEpochEngine(mj, JaxTrainConfig(compress_mode="topk"), units)
    with pytest.raises(ValueError) as got:
        launcher.main(["--arch", ARCH, "--device", "cpu", "--epochs", "1",
                       "--n", "16", "--compress-mode", "topk"])
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jax_launcher.parse_mesh("2x2x2", "data,pod")
    with pytest.raises(ValueError) as got:
        launcher.parse_mesh("2x2x2", "data,pod", "cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=r"torchrun --standalone "
                       r"--nproc-per-node 4 -m repro_torch.launch.train"):
        launcher.main(["--arch", ARCH, "--device", "cpu", "--mesh", "2x2"])
    # the production meshes are named and refused past the world's size
    for multi, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {n} ranks"):
            make_production_mesh(multi_pod=multi, device_type="cpu")
