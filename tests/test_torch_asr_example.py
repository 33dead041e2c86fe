"""PyTorch port, the twin of ``examples/train_asr_pgm.py``
(``repro_torch/examples/train_asr_pgm.py``) against the reference
example, on the CPU.

The reference example's ``main`` runs with ``--engine host`` (its own
code, corpora and settings, E3), its initial draws handed to the twin
(H4): the same subset in every round, per-epoch losses within rtol 1e-3
(the ``tests/test_train_engine.py`` bar), the same hypotheses and the
same TER.  ``greedy_decode`` (E1) is held exactly on random params whose
hypotheses hold non-blank symbols; ``token_error_rate`` (E2) to equal
floats on fixed arrays.  ``--exact-gradients`` (unsketched stage A,
D = joint_dim x vocab) picks the reference's subsets; ``--method
random`` keeps its invariants (G3).  The scanned engine's entry points
are held against the reference in ``tests/test_torch_engine.py``."""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.train.loop as jax_loop  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import PGMConfig as JaxPGMConfig  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.core.lastlayer import make_proj_for as jax_make_proj  # noqa: E402
from repro.data.pipeline import asr_units  # noqa: E402
from repro.data.synthetic import make_asr_corpus  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import PGMConfig, TrainConfig  # noqa: E402
from repro_torch.convert import from_numpy  # noqa: E402
from repro_torch.examples import train_asr_pgm as twin  # noqa: E402
from repro_torch.kernels.backend import fp32_numerics  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.train.loop import train_with_selection  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "rnnt-crdnn-smoke"


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "reference_train_asr_pgm", ROOT / "examples" / "train_asr_pgm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_draws(k1, k2, seed=0):
    """The reference loop's initial params and projections for a seed."""
    mj = jax_build(jax_get_config(ARCH))
    key = jax.random.PRNGKey(seed)
    params = jax.tree.map(np.asarray, mj.init_params(key))
    proj = [np.asarray(x) for x in jax_make_proj(
        mj, jax.random.fold_in(key, 17), k1, k2)]
    return params, proj


def _val_corpus():
    r = jax_get_config(ARCH).rnnt
    return make_asr_corpus(31, 16, n_feats=r.n_feats,
                           vocab_size=r.vocab_size)


def test_twin_matches_reference_example(monkeypatch, capsys):
    fp32_numerics()
    ref = _reference_example()
    seen = {}
    run_ref = jax_loop.train_with_selection
    decode_ref = ref.greedy_decode

    def record_run(*a, **kw):
        seen["hist"] = run_ref(*a, **kw)
        return seen["hist"]

    def record_decode(*a, **kw):
        seen["decode"] = decode_ref(*a, **kw)
        return seen["decode"]

    monkeypatch.setattr(jax_loop, "train_with_selection", record_run)
    monkeypatch.setattr(ref, "greedy_decode", record_decode)
    monkeypatch.setattr(sys, "argv", ["train_asr_pgm.py", "--n", "32",
                                      "--epochs", "4", "--engine", "host"])
    ref.main()
    ref_lines = capsys.readouterr().out.strip().splitlines()
    h_j, (hyp_j, n_j) = seen["hist"], seen["decode"]

    params, proj = _reference_draws(32, 32)
    lines = []
    h_t, hyp_t, n_t, ter_t = twin.train_and_decode(
        n=32, epochs=4, engine="host", device="cpu", params=params,
        proj=proj, log_fn=lines.append)
    assert lines[0] == ref_lines[0]           # the corrupted-corpus line
    assert len(h_t.selections) == len(h_j.selections) == 1
    for st, sj in zip(h_t.selections, h_j.selections):
        assert st["epoch"] == sj["epoch"] == 2
        assert st["indices"] == sj["indices"], (st, sj)
        np.testing.assert_allclose(st["weights"], sj["weights"], atol=1e-4)
    np.testing.assert_allclose(h_t.train_loss, h_j.train_loss, rtol=1e-3)
    np.testing.assert_allclose(h_t.val_loss, h_j.val_loss, rtol=1e-3)
    np.testing.assert_allclose(h_t.lr, h_j.lr, rtol=1e-6)
    assert np.array_equal(hyp_t, np.asarray(hyp_j))
    assert np.array_equal(n_t, np.asarray(n_j))
    ter_line = ref_lines[-1]
    assert ter_line.startswith("method=pgm: token error rate ")
    assert f"token error rate {ter_t:.3f}," in ter_line
    assert lines[-1].strip().split(", val loss")[0] == \
        ter_line.split(", val loss")[0]


@pytest.mark.parametrize("seed,max_symbols", [(3, 20), (3, 2), (11, 20)])
def test_greedy_decode_matches_reference_exactly(seed, max_symbols):
    """E1 on random params, which emit: the same hypotheses and counts,
    symbol caps included."""
    fp32_numerics()
    ref = _reference_example()
    mj = jax_build(jax_get_config(ARCH))
    params = jax.tree.map(np.asarray, mj.init_params(
        jax.random.PRNGKey(seed)))
    vc = _val_corpus()
    hyp_j, n_j = ref.greedy_decode(mj, params, jnp.asarray(vc.feats),
                                   jnp.asarray(vc.feat_lens),
                                   max_symbols=max_symbols)
    hyp_t, n_t = twin.greedy_decode(build_model(get_config(ARCH)),
                                    from_numpy(params), vc.feats,
                                    vc.feat_lens, max_symbols=max_symbols)
    assert hyp_t.dtype == np.int32 and n_t.dtype == np.int32
    assert np.array_equal(hyp_t, np.asarray(hyp_j))
    assert np.array_equal(n_t, np.asarray(n_j))
    assert n_t.sum() > 0 and (hyp_t != 0).any()    # not vacuous
    if max_symbols == 2:
        assert n_t.max() == 2                       # the cap binds


def test_token_error_rate_matches_reference():
    """E2: equal floats, the empty hypothesis and an empty reference
    (``max(total, 1)``) included."""
    ref = _reference_example()
    hyp = np.asarray([[3, 4, 5, 0], [7, 0, 0, 0], [1, 2, 2, 9],
                      [0, 0, 0, 0]], np.int32)
    n_sym = np.asarray([3, 1, 4, 0], np.int32)
    refs = np.asarray([[3, 5, 5, 6], [8, 0, 0, 0], [2, 2, 9, 9],
                       [4, 4, 0, 0]], np.int32)
    for lens in ([4, 1, 3, 2], [0, 0, 0, 0], [3, 1, 4, 1]):
        ref_lens = np.asarray(lens, np.int32)
        want = ref.token_error_rate(hyp, n_sym, refs, ref_lens)
        got = twin.token_error_rate(hyp, n_sym, refs, ref_lens)
        assert type(got) is type(want) and got == want


def _units(seed, n, noise=0.0):
    r = jax_get_config(ARCH).rnnt
    return asr_units(make_asr_corpus(seed, n, n_feats=r.n_feats,
                                     vocab_size=r.vocab_size,
                                     noise_fraction=noise), 4)


def test_exact_gradients_pick_the_reference_subsets():
    fp32_numerics()
    units, val = _units(0, 16, noise=0.25), _units(5, 8)
    run = dict(lr=0.05, optimizer="adamw", epochs=4)
    sel = dict(subset_fraction=0.5, n_partitions=2, select_every=1,
               warm_start_epochs=1, val_matching=True, use_sketch=False)
    h_j = jax_loop.train_with_selection(
        jax_build(jax_get_config(ARCH)), units,
        JaxTrainConfig(**run, pgm=JaxPGMConfig(**sel)), method="pgm",
        val_units=val, engine="host")
    params, _ = _reference_draws(64, 64)
    h_t = train_with_selection(
        build_model(get_config(ARCH)), units,
        TrainConfig(**run, pgm=PGMConfig(**sel)), method="pgm",
        val_units=val, engine="host", device="cpu", params=params)
    assert len(h_t.selections) == len(h_j.selections) == 3
    for st, sj in zip(h_t.selections, h_j.selections):
        assert st["indices"] == sj["indices"], (st, sj)
        np.testing.assert_allclose(st["weights"], sj["weights"], atol=1e-4)
    np.testing.assert_allclose(h_t.train_loss, h_j.train_loss, rtol=1e-3)
    np.testing.assert_allclose(h_t.val_loss, h_j.val_loss, rtol=1e-3)


def test_random_method_keeps_its_invariants():
    """G3: the twin's ``--method random`` draws from the port's own
    generator: every round picks the budget of distinct units, each at
    weight 1, and the run decodes."""
    h, hyp, n_sym, ter = twin.train_and_decode(
        method="random", n=32, epochs=4, device="cpu", log_fn=lambda s: None)
    n_units, budget = 8, int(0.3 * 8)
    assert [s["epoch"] for s in h.selections] == [2]
    for s in h.selections:
        idx = s["indices"]
        assert len(idx) == budget == len(set(idx))
        assert all(0 <= i < n_units for i in idx)
        assert s["weights"] == [1.0] * budget
    assert h.cost_units == pytest.approx(2 + 2 * budget / n_units)
    assert hyp.shape == (16, 20) and 0.0 <= ter


def test_twin_cli_prints_the_reference_lines(tmp_path):
    """``python -m repro_torch.examples.train_asr_pgm --device cpu --n 32
    --epochs 4`` prints the epoch lines, the selection line and the TER
    line, and writes a checkpoint an epoch with ``--ckpt``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.train_asr_pgm",
         "--device", "cpu", "--n", "32", "--epochs", "4", "--ckpt",
         str(tmp_path / "ck")], capture_output=True, text=True, env=env,
        cwd=str(tmp_path), timeout=300, check=True).stdout.splitlines()
    assert out[0] == "train corpus: 6/32 utterances corrupted at 10 dB SNR"
    for e in range(4):
        assert any(l.startswith(f"epoch {e}: train ") for l in out)
    assert "epoch 2: selected 4 units (OI=nan)" in out
    assert out[-1].startswith("method=pgm: token error rate ")
    assert sorted(os.listdir(tmp_path / "ck")) == \
        ["LATEST", "step_0", "step_1", "step_2", "step_3"]


def test_launcher_passes_the_reference_flags(monkeypatch, tmp_path):
    """``--loss-impl``, ``--exact-gradients``, ``--nonfinite-guard``,
    ``--max-skipped-steps``, ``--ckpt``, ``--resume`` and ``--engine``
    reach the run with the reference launcher's meanings."""
    seen = {}

    def record(bundle, units, tc, **kw):
        seen.update(kw, bundle=bundle, tc=tc)
        return launcher.History()

    monkeypatch.setattr(launcher, "train_with_selection", record)
    d = str(tmp_path / "ck")
    launcher.main(["--arch", ARCH, "--n", "16", "--device", "cpu",
                   "--loss-impl", "dense", "--exact-gradients",
                   "--nonfinite-guard", "--max-skipped-steps", "3",
                   "--ckpt", d, "--resume"])
    assert seen["bundle"].cfg.rnnt.loss_impl == "dense"
    assert seen["tc"].pgm.use_sketch is False
    assert seen["tc"].nonfinite_guard and seen["tc"].max_skipped_steps == 3
    assert (seen["ckpt_dir"], seen["resume"], seen["engine"]) == \
        (d, True, "scan")
    launcher.main(["--arch", ARCH, "--n", "16", "--device", "cpu"])
    assert seen["bundle"].cfg.rnnt.loss_impl == "fused"
    assert seen["tc"].pgm.use_sketch and not seen["tc"].nonfinite_guard
    assert (seen["ckpt_dir"], seen["resume"]) == (None, False)
