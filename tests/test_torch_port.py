"""PyTorch port, package contract: ``src/repro_torch/`` and
``chip_smoke.py`` import neither ``jax`` nor anything of ``repro``; the
entry points (the training and serving launchers) refuse to run without
a card unless the CPU is asked for by name; the port's copied corpora (ASR and LM), units and plans equal the
reference's byte for byte; the converter round-trips the LM params tree
(tuples of stacked dicts) bit-exactly; and the launcher prints the
reference's epoch lines for an RNN-T and an LM arch."""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.data import synthetic as jax_synthetic  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.convert import from_numpy, to_numpy  # noqa: E402
from repro_torch.data import pipeline, synthetic  # noqa: E402
from repro_torch.launch import serve as serve_launch  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.train.loop import train_with_selection  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


def test_port_imports_no_jax_and_nothing_of_the_reference():
    files = _port_files()
    assert len(files) > 20 and (ROOT / "chip_smoke.py").exists()
    bad = [f"{p.relative_to(ROOT)}:{line}: {mod}" for p in files
           for mod, line in _imported_roots(p) if mod in FORBIDDEN]
    assert not bad, "forbidden imports in the port:\n" + "\n".join(bad)


def test_entry_points_need_a_card_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("rnnt-crdnn-smoke")
    units, val = launch.make_units_for(cfg, n=8, noise=0.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_with_selection(build_model(cfg), units,
                             TrainConfig(epochs=1), val_units=val)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--arch", "rnnt-crdnn-smoke", "--epochs", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--arch", "starcoder2-3b-smoke", "--epochs", "1"])
    for argv in (["--arch", "starcoder2-3b-smoke"],
                 ["--arch", "starcoder2-3b-smoke", "--engine", "slots"],
                 ["--arch", "rnnt-crdnn-smoke"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_launch.main(argv)


@pytest.mark.parametrize("kw", [
    dict(seed=0, n_examples=12, n_feats=8, vocab_size=37,
         noise_fraction=0.25),
    dict(seed=3, n_examples=16, n_feats=80, vocab_size=1000,
         min_tokens=16, max_tokens=32, frames_per_token=16, snr_db=5.0,
         noise_fraction=0.5),
])
def test_corpus_units_and_plans_are_byte_identical(kw):
    mine = synthetic.make_asr_corpus(**kw)
    ref = jax_synthetic.make_asr_corpus(**kw)
    for f in ("feats", "feat_lens", "tokens", "token_lens", "durations",
              "noisy"):
        a, b = getattr(mine, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    u_mine, u_ref = pipeline.asr_units(mine, 4), jax_pipeline.asr_units(ref, 4)
    assert sorted(u_mine) == sorted(u_ref)
    for k in u_ref:
        assert u_mine[k].dtype == u_ref[k].dtype
        assert u_mine[k].tobytes() == u_ref[k].tobytes(), k
    assert pipeline.unit_durations(u_mine).tobytes() == \
        jax_pipeline.unit_durations(u_ref).tobytes()
    n = u_ref["tokens"].shape[0]
    for epoch in range(3):
        assert pipeline.epoch_plan(n, 5, epoch, 1).tobytes() == \
            jax_pipeline.epoch_plan(n, 5, epoch, 1).tobytes()
        idx = np.array([2, -1, 0, 3][:n], np.int32)
        w = np.linspace(0.5, 2.0, len(idx)).astype(np.float32)
        for a, b in zip(pipeline.subset_epoch_plan(idx, w, 5, epoch, 1, 4),
                        jax_pipeline.subset_epoch_plan(idx, w, 5, epoch, 1,
                                                       4)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kw", [
    dict(seed=0, n_examples=12, seq_len=24, vocab_size=277,
         noise_fraction=0.25),
    dict(seed=5, n_examples=17, seq_len=512, vocab_size=49152),
])
def test_lm_corpus_and_units_are_byte_identical(kw):
    mine = synthetic.make_lm_corpus(**kw)
    ref = jax_synthetic.make_lm_corpus(**kw)
    for f in ("tokens", "lengths", "difficulty", "noisy"):
        a, b = getattr(mine, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    u_mine, u_ref = pipeline.lm_units(mine, 4), jax_pipeline.lm_units(ref, 4)
    assert sorted(u_mine) == sorted(u_ref) == ["loss_mask", "tokens",
                                               "weights"]
    for k in u_ref:
        assert u_mine[k].dtype == u_ref[k].dtype
        assert u_mine[k].tobytes() == u_ref[k].tobytes(), k
    assert pipeline.unit_durations(u_mine).tobytes() == \
        jax_pipeline.unit_durations(u_ref).tobytes()


def test_converter_round_trips_the_lm_tree_bit_exactly():
    params = jax.tree.map(
        np.asarray, jax_build(jax_get_config("starcoder2-3b-smoke"))
        .init_params(jax.random.PRNGKey(0)))
    tp = from_numpy(params)
    assert isinstance(tp["stack"]["groups"], tuple)
    assert isinstance(tp["stack"]["tail"], tuple)
    back = to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    # the port's flatten order is JAX's (dict keys sorted, tuples in order)
    from repro_torch.models.common import tree_leaves
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(params)):
        assert a.numpy().tobytes() == b.tobytes()


def test_launcher_prints_the_reference_epoch_lines(capsys):
    h = launch.main(["--arch", "rnnt-crdnn-smoke", "--epochs", "3",
                     "--n", "16", "--warm-start", "1", "--select-every", "1",
                     "--subset", "0.5", "--partitions", "2", "--noise",
                     "0.25", "--optimizer", "adamw", "--lr", "0.05",
                     "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    for e in range(3):
        assert any(line.startswith(f"epoch {e}: train ") for line in out)
    assert sum("selected" in line for line in out) == 2
    assert all(np.isfinite(h.train_loss)) and all(np.isfinite(h.val_loss))
    assert out[-1].startswith("done: val ")


def test_launcher_prints_the_reference_epoch_lines_for_an_lm(capsys):
    h = launch.main(["--arch", "starcoder2-3b-smoke", "--seq", "24",
                     "--epochs", "3", "--n", "16", "--warm-start", "1",
                     "--select-every", "1", "--subset", "0.5",
                     "--partitions", "2", "--noise", "0.25",
                     "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    for e in range(3):
        assert any(line.startswith(f"epoch {e}: train ") for line in out)
    assert sum("selected 2 units" in line for line in out) == 2
    assert all(np.isfinite(h.train_loss)) and all(np.isfinite(h.val_loss))
    assert out[-1].startswith("done: val ")
