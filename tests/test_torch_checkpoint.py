"""PyTorch port, checkpoints (``repro_torch/train/checkpoint.py``)
against the reference's ``repro/train/checkpoint.py``, on the CPU.

Both packages write one format (C1): ``step_<n>/manifest.json`` plus
``arrays.npz`` keyed by ``jax.tree_util.keystr`` paths, each array with
its sha256, ``opt['step']`` an int32 of shape (), ``mesh_shape`` and
``compress_mode`` null, an ``inf`` prev_loss written as ``Infinity``.
Held here: a reference save restores into the port bitwise and a port
save into the reference's ``restore(template=...)`` bitwise (C2: cast
to the template's dtypes); the manifests' ``arrays`` entries are equal;
tamper and corruption are detected key by key and
``restore_latest_intact`` falls back; and a port run resumed from a
reference-written checkpoint matches the reference's own resumed run
(the same subsets, losses within rtol 1e-3, the ``tests/test_train_engine.py``
bar)."""
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import PGMConfig as JaxPGMConfig  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.core.lastlayer import make_proj_for as jax_make_proj  # noqa: E402
from repro.data.pipeline import asr_units  # noqa: E402
from repro.data.synthetic import make_asr_corpus  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.train import checkpoint as jax_ckpt  # noqa: E402
from repro.train import faults as jax_faults  # noqa: E402
from repro.train.loop import train_with_selection as jax_train  # noqa: E402
from repro.train.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import PGMConfig, TrainConfig  # noqa: E402
from repro_torch.convert import from_numpy  # noqa: E402
from repro_torch.kernels.backend import fp32_numerics  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import faults  # noqa: E402
from repro_torch.train.loop import train_with_selection  # noqa: E402
from repro_torch.train.optim import adamw_init  # noqa: E402

ARCH = "rnnt-crdnn-smoke"


def _state(seed=0):
    """A reference training state as numpy: the smoke RNN-T's params and
    an AdamW state with a step count and random moments."""
    mj = jax_build(jax_get_config(ARCH))
    params = jax.tree.map(np.asarray,
                          mj.init_params(jax.random.PRNGKey(seed)))
    opt = jax.tree.map(np.asarray, jax_adamw_init(params))
    rng = np.random.default_rng(seed)
    opt = {"step": np.asarray(7, np.int32),
           "m": jax.tree.map(lambda a: rng.normal(size=a.shape)
                             .astype(np.float32), opt["m"]),
           "v": jax.tree.map(lambda a: rng.uniform(size=a.shape)
                             .astype(np.float32), opt["v"])}
    return {"params": params, "opt": opt}


EXTRA = {"epoch": 1, "lr": 0.05, "prev_loss": float("inf"),
         "sel_indices": [3, -1, 0], "sel_weights": [0.5, 0.0, 1.25]}


def _jax_leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(l))
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _assert_bitwise(port_tree, ref_tree):
    """Port tree of tensors == reference tree of arrays: same leaves in
    the same flatten order, dtypes and bits."""
    got = [t.numpy() for t in tree_leaves(port_tree)]
    want = _jax_leaves(ref_tree)
    assert len(got) == len(want)
    for g, (k, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


def test_keystr_paths_match_jax():
    tree = {"params": {"b": np.zeros(2), "a": (np.ones(1), {"w": 1.0})},
            "opt": {"step": np.int32(0)}}
    want = [k for k, _ in _jax_leaves(tree)]
    assert [k for k, _ in ckpt._flatten(tree)] == want
    assert "['params']['a'][1]['w']" in want


def test_reference_save_restores_into_port_bitwise(tmp_path):
    state = _state()
    d = str(tmp_path / "ck")
    jax_ckpt.save(d, 4, state, extra=EXTRA)
    template = {"params": from_numpy(state["params"]),
                "opt": adamw_init(from_numpy(state["params"]))}
    got, manifest = ckpt.restore(d, template=template)
    _assert_bitwise(got, state)
    assert got["opt"]["step"].dtype == torch.int32
    assert got["opt"]["step"].shape == ()
    assert manifest["extra"] == EXTRA


def test_port_save_restores_into_reference_bitwise(tmp_path):
    state = _state(1)
    d = str(tmp_path / "ck")
    ckpt.save(d, 2, from_numpy(state), extra=EXTRA)
    template = jax.tree.map(jnp.zeros_like, state)
    got, manifest = jax_ckpt.restore(d, template=template)
    port, _ = ckpt.restore(d, template=from_numpy(state))
    _assert_bitwise(port, jax.tree.map(np.asarray, got))
    _assert_bitwise(from_numpy(state), jax.tree.map(np.asarray, got))
    assert manifest["extra"] == EXTRA
    assert jax_ckpt.latest_step(d) == ckpt.latest_step(d) == 2


def test_manifests_are_equal(tmp_path):
    state = _state(2)
    dj, dt = str(tmp_path / "ref"), str(tmp_path / "port")
    jax_ckpt.save(dj, 3, state, extra=EXTRA)
    ckpt.save(dt, 3, from_numpy(state), extra=EXTRA)
    mj, mt = jax_ckpt.read_manifest(dj), ckpt.read_manifest(dt)
    assert mt["arrays"] == mj["arrays"]
    assert list(mt["arrays"]) == list(mj["arrays"])
    assert set(mt) == set(mj)
    for k in ("step", "mesh_shape", "compress_mode", "extra"):
        assert mt[k] == mj[k], k
    assert mt["mesh_shape"] is None and mt["compress_mode"] is None
    assert mt["arrays"]["['opt']['step']"] == mj["arrays"]["['opt']['step']"]
    assert mt["arrays"]["['opt']['step']"]["dtype"] == "int32"
    assert mt["arrays"]["['opt']['step']"]["shape"] == []
    with open(os.path.join(dt, "step_3", "manifest.json")) as f:
        assert '"prev_loss": Infinity' in f.read()
    with open(os.path.join(dt, "LATEST")) as f:
        assert f.read() == "3"


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_tamper_lists_every_bad_key(tmp_path, writer):
    d = str(tmp_path / "ck")
    tree = {"a": np.arange(6, dtype=np.float32),
            "b": np.ones((2, 3), np.float32),
            "c": np.zeros(4, np.int32)}
    (jax_ckpt if writer == "reference" else ckpt).save(d, 0, tree)
    targets = faults.tamper_arrays(d, keys=["['a']", "['c']"])
    for restore in (ckpt.restore, jax_ckpt.restore):
        with pytest.raises(IOError, match="2 array") as e:
            restore(d)
        for k in targets:
            assert k in str(e.value)
    arrays, _ = ckpt.restore(d, verify=False)
    assert np.array_equal(arrays["['b']"], tree["b"])
    assert np.array_equal(arrays["['a']"], tree["a"] + 1)


@pytest.mark.parametrize("damage", ["corrupt", "tamper"])
def test_restore_latest_intact_falls_back(tmp_path, damage):
    d = str(tmp_path / "ck")
    for step in range(3):
        ckpt.save(d, step, {"w": np.full(4096, step, np.float32)},
                  extra={"epoch": step})
    if damage == "corrupt":
        path = faults.corrupt_checkpoint(d)
        assert path.endswith(os.path.join("step_2", "arrays.npz"))
    else:
        faults.tamper_arrays(d)
    logs, ref_logs = [], []
    tree, manifest = ckpt.restore_latest_intact(
        d, template={"w": torch.zeros(4096)}, log_fn=logs.append)
    assert manifest["step"] == 1
    assert torch.equal(tree["w"], torch.full((4096,), 1.0))
    assert any("step_2 unusable" in l and "falling back" in l
               for l in logs)
    # the reference walks the same steps and logs the same line
    _, ref_manifest = jax_ckpt.restore_latest_intact(d,
                                                     log_fn=ref_logs.append)
    assert ref_manifest["step"] == 1
    assert [l.split(" (")[0] for l in logs] == \
        [l.split(" (")[0] for l in ref_logs]


def test_no_intact_checkpoint_raises(tmp_path):
    d = str(tmp_path / "ck")
    with pytest.raises(FileNotFoundError):
        ckpt.restore_latest_intact(d)
    ckpt.save(d, 0, {"w": np.ones(8, np.float32)})
    faults.tamper_arrays(d)
    with pytest.raises(IOError, match="no intact checkpoint"):
        ckpt.restore_latest_intact(d)


def test_async_writer_prunes_staging_and_tracks_latest(tmp_path):
    d = str(tmp_path / "ck")
    os.makedirs(os.path.join(d, ".tmp_9"))
    w = ckpt.AsyncCheckpointer(d)
    t = {"p": torch.arange(5, dtype=torch.float32)}
    w.submit(0, t, {"epoch": 0})
    # the snapshot is a copy: a later in-place write does not reach it
    t["p"].add_(100.0)
    w.submit(1, t, {"epoch": 1})
    w.close()
    assert not os.path.exists(os.path.join(d, ".tmp_9"))
    assert sorted(os.listdir(d)) == ["LATEST", "step_0", "step_1"]
    assert ckpt.latest_step(d) == 1
    got, m = ckpt.restore(d, 0, template={"p": torch.zeros(5)})
    assert torch.equal(got["p"], torch.arange(5, dtype=torch.float32))
    assert m["extra"] == {"epoch": 0}
    os.remove(os.path.join(d, "LATEST"))
    assert ckpt.latest_step(d) == 1


def _units(seed, n, noise=0.0):
    r = jax_get_config(ARCH).rnnt
    return asr_units(make_asr_corpus(seed, n, n_feats=r.n_feats,
                                     vocab_size=r.vocab_size,
                                     noise_fraction=noise), 4)


def test_port_resumes_from_reference_checkpoint(tmp_path):
    """The reference trains 2 of 4 epochs and is preempted after epoch 1
    (a checkpoint carrying a selection); the reference and the port both
    resume from copies of it: the same subsets, losses within rtol
    1e-3."""
    fp32_numerics()
    units, val = _units(0, 16, noise=0.25), _units(5, 8)
    run = dict(lr=0.05, optimizer="adamw", epochs=4)
    sel = dict(subset_fraction=0.5, n_partitions=2, select_every=2,
               warm_start_epochs=1, sketch_dim_h=16, sketch_dim_v=16,
               val_matching=True)
    tj = JaxTrainConfig(**run, pgm=JaxPGMConfig(**sel))
    mj = jax_build(jax_get_config(ARCH))
    d = str(tmp_path / "ref")
    h_cut = jax_train(mj, units, tj, method="pgm", val_units=val,
                      engine="host", ckpt_dir=d,
                      fault_plan=jax_faults.FaultPlan(preempt_after_epoch=1))
    assert h_cut.preempted and len(h_cut.train_loss) == 2
    manifest = jax_ckpt.read_manifest(d)
    assert manifest["extra"]["preempted"] is True
    assert manifest["extra"]["sel_indices"] is not None
    d_port = str(tmp_path / "port")
    shutil.copytree(d, d_port)
    h_j = jax_train(mj, units, tj, method="pgm", val_units=val,
                    engine="host", ckpt_dir=d, resume=True)
    key = jax.random.PRNGKey(tj.seed)
    proj = [np.asarray(x) for x in jax_make_proj(
        mj, jax.random.fold_in(key, 17), 16, 16)]
    logs = []
    h_t = train_with_selection(
        build_model(get_config(ARCH)), units,
        TrainConfig(**run, pgm=PGMConfig(**sel)), method="pgm",
        val_units=val, ckpt_dir=d_port, resume=True, engine="host",
        device="cpu", proj=proj, log_fn=logs.append)
    assert logs[0] == "resumed at epoch 2"
    assert len(h_t.train_loss) == len(h_j.train_loss) == 2
    assert [s["epoch"] for s in h_t.selections] == [3]
    for st, sj in zip(h_t.selections, h_j.selections):
        assert st["epoch"] == sj["epoch"]
        assert st["indices"] == sj["indices"], (st, sj)
        np.testing.assert_allclose(st["weights"], sj["weights"], atol=1e-4)
    np.testing.assert_allclose(h_t.train_loss, h_j.train_loss, rtol=1e-3)
    np.testing.assert_allclose(h_t.val_loss, h_j.val_loss, rtol=1e-3)
    np.testing.assert_allclose(h_t.lr, h_j.lr, rtol=1e-6)
    # both wrote their epoch-3 checkpoints in the one format
    mt, mj3 = ckpt.read_manifest(d_port), jax_ckpt.read_manifest(d)
    assert mt["step"] == mj3["step"] == 3
    assert {k: (v["shape"], v["dtype"]) for k, v in mt["arrays"].items()} \
        == {k: (v["shape"], v["dtype"]) for k, v in mj3["arrays"].items()}
    assert mt["extra"]["sel_indices"] == mj3["extra"]["sel_indices"]
