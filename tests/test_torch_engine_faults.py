"""PyTorch port, the scanned epoch engine under faults and through its
entry points, against the reference on the CPU (split out of
``tests/test_torch_engine.py``, whose setup it shares through
``tests/torch_engine_helpers.py``).

Under ``tests/test_chaos.py``'s faults (an epoch of NaN steps with and
without a checkpoint, per epoch and in chunks of 2, and one NaN step),
the watchdog's rollbacks, skips, log lines and subsets equal the
reference scan engine's.

The four calls that raised before the engine was ported (the twin with
``--engine scan`` and with ``--epoch-chunk 2``, the launcher with
``--engine scan --epoch-chunk 2``, ``train_with_selection(engine=
"scan")``) run against the same calls of the reference, with the
reference's initial draws handed to the port."""

import importlib.util
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import PGMConfig as JaxPGMConfig  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.core.lastlayer import make_proj_for as jax_make_proj  # noqa: E402
from repro.data.pipeline import lm_units  # noqa: E402
from repro.data.synthetic import make_lm_corpus  # noqa: E402
import repro.launch.train as jax_launcher  # noqa: E402
import repro.train.loop as jax_loop  # noqa: E402
from repro.train import faults as jax_faults  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.train.loop import train_with_selection as jax_train  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import PGMConfig, TrainConfig  # noqa: E402
from repro_torch.convert import from_numpy  # noqa: E402
from repro_torch.examples import train_asr_pgm as twin  # noqa: E402
from repro_torch.kernels.backend import fp32_numerics  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.train import faults  # noqa: E402
from repro_torch.train.loop import train_with_selection  # noqa: E402
from torch_engine_helpers import (ROOT, SKETCH,  # noqa: E402
                                  _assert_history_parity, _reference_draws,
                                  _setup)


class _ReinitTo:
    """A bundle whose ``init_params`` returns given numpy params: the
    watchdog's re-initialisation then draws what the reference's draws."""

    def __init__(self, bundle, params):
        self._bundle, self._params = bundle, params

    def init_params(self, gen, device):
        return from_numpy(self._params, device)

    def __getattr__(self, name):
        return getattr(self._bundle, name)


# the chaos suite's run at lr 0.2: at its lr 0.5 a fault-free run of the
# two packages drifts 1e-2 apart by epoch 3 on either engine (fp32
# rounding amplified by SGD), at 0.2 it stays within 1e-5
CHAOS = dict(lr=0.2, optimizer="sgd", epochs=4, seed=0, nonfinite_guard=True,
             max_skipped_steps=4)
CHAOS_SEL = dict(subset_fraction=0.75, n_partitions=2, select_every=2,
                 warm_start_epochs=2, **SKETCH)


@pytest.mark.parametrize("kind,ckpt,chunk", [
    ("nan_epoch", True, 1), ("nan_epoch", True, 2), ("nan_epoch", False, 1),
    ("nan_epoch", False, 2), ("nan_step", False, 2)])
def test_faults_on_scan_engine_match_reference(tmp_path, kind, ckpt, chunk):
    """``tests/test_chaos.py``'s LM run on both scan engines under one
    ``FaultPlan``: an epoch of NaN steps trips the watchdog, which rolls
    back to the checkpoint before it (its state copied into the engine's
    buffers) or, without one, re-initialises (the port handed the
    reference's re-initial draws), on re-keyed plans; a NaN step is
    skipped once.  The same rollbacks, skips, log lines other than
    losses, and subsets; losses within atol 1e-3."""
    fp32_numerics()
    cfg = jax_get_config("starcoder2-3b-smoke")
    units = lm_units(make_lm_corpus(0, 32, 10, cfg.vocab_size,
                                    hard_fraction=0.4), 4)
    val = lm_units(make_lm_corpus(7, 8, 10, cfg.vocab_size), 4)
    fault = {kind: 2 if kind == "nan_epoch" else (2, 1)}
    mj, params, proj = _reference_draws("starcoder2-3b-smoke")
    reinit = jax.tree.map(np.asarray, mj.init_params(jax.random.fold_in(
        jax.random.PRNGKey(0), 7919 + 1)))
    logs_j, logs_t = [], []
    h_j = jax_train(mj, units, JaxTrainConfig(**CHAOS, pgm=JaxPGMConfig(
        **CHAOS_SEL)), method="pgm", val_units=val, engine="scan",
        epoch_chunk=chunk, fault_plan=jax_faults.FaultPlan(**fault),
        ckpt_dir=str(tmp_path / "ref") if ckpt else None,
        log_fn=logs_j.append)
    h_t = train_with_selection(
        _ReinitTo(build_model(get_config("starcoder2-3b-smoke")), reinit),
        units, TrainConfig(**CHAOS, pgm=PGMConfig(**CHAOS_SEL)),
        method="pgm", val_units=val, engine="scan", epoch_chunk=chunk,
        fault_plan=faults.FaultPlan(**fault),
        ckpt_dir=str(tmp_path / "port") if ckpt else None, device="cpu",
        params=params, proj=proj, log_fn=logs_t.append)
    want = (1, 0) if kind == "nan_epoch" else (0, 1)
    assert (h_t.rollbacks, h_j.rollbacks) == (want[0], want[0])
    assert h_t.skipped_steps == h_j.skipped_steps
    assert h_t.skipped_steps >= (CHAOS["max_skipped_steps"] if want[0]
                                 else 1)
    _assert_history_parity(h_j, h_t, atol=1e-3)
    no_loss = lambda logs: [l for l in logs if ": train " not in l]
    assert no_loss(logs_t) == no_loss(logs_j)
    if kind == "nan_epoch":
        assert any(("rolled back to epoch" if ckpt else
                    "restarting from re-initialised state") in l
                   for l in logs_t)
    assert np.isfinite(h_t.val_loss).all()


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "reference_train_asr_pgm", ROOT / "examples" / "train_asr_pgm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_reference_main(argv):
    def run():
        sys.argv = argv
        if argv[0] == "train_asr_pgm.py":
            _reference_example().main()
        else:
            jax_launcher.main()
    return run


def _run_reference_loop():
    units, val, run, sel = _setup("rnnt-crdnn-smoke")
    jax_loop.train_with_selection(
        jax_build(jax_get_config("rnnt-crdnn-smoke")), units,
        JaxTrainConfig(**run, pgm=JaxPGMConfig(**sel)), method="pgm",
        val_units=val, engine="scan")


def _run_port_loop():
    units, val, run, sel = _setup("rnnt-crdnn-smoke")
    train_with_selection(
        build_model(get_config("rnnt-crdnn-smoke")), units,
        TrainConfig(**run, pgm=PGMConfig(**sel)), method="pgm",
        val_units=val, engine="scan", device="cpu")


SMALL = ["--n", "32", "--epochs", "4"]
LAUNCH = ["--arch", "rnnt-crdnn-smoke", "--n", "16", "--epochs", "3",
          "--warm-start", "1", "--select-every", "2", "--partitions", "2",
          "--subset", "0.5", "--optimizer", "adamw", "--lr", "0.05",
          "--engine", "scan", "--epoch-chunk", "2"]


@pytest.mark.parametrize("port,ref", [
    (lambda: twin.main(["--engine", "scan", "--device", "cpu"] + SMALL),
     _run_reference_main(["train_asr_pgm.py", "--engine", "scan"] + SMALL)),
    (lambda: twin.main(["--engine", "scan", "--epoch-chunk", "2",
                        "--device", "cpu"] + SMALL),
     _run_reference_main(["train_asr_pgm.py", "--engine", "scan",
                          "--epoch-chunk", "2"] + SMALL)),
    (lambda: launcher.main(LAUNCH + ["--device", "cpu"]),
     _run_reference_main(["train.py"] + LAUNCH)),
    (_run_port_loop, _run_reference_loop),
], ids=["twin-scan", "twin-chunk2", "launcher-scan-chunk2", "loop-scan"])
def test_scan_entry_points_match_reference(monkeypatch, port, ref):
    """Each entry point on the scan engine against the reference's same
    call: the same subsets and weights, losses within atol 1e-3, equal
    ``cost_units`` (the port run given the reference's initial draws)."""
    fp32_numerics()
    seen = {}
    ref_loop, port_loop = jax_loop.train_with_selection, train_with_selection

    def record_ref(*a, **kw):
        assert kw.get("engine", "scan") == "scan"
        seen["ref"] = ref_loop(*a, **kw)
        return seen["ref"]

    def with_reference_draws(bundle, units, tc, **kw):
        mj, params, proj = _reference_draws(bundle.cfg.name, tc.seed)
        if (tc.pgm.sketch_dim_h, tc.pgm.sketch_dim_v) != \
                (SKETCH["sketch_dim_h"], SKETCH["sketch_dim_v"]):
            key = jax.random.fold_in(jax.random.PRNGKey(tc.seed), 17)
            proj = [np.asarray(x) for x in jax_make_proj(
                mj, key, tc.pgm.sketch_dim_h, tc.pgm.sketch_dim_v)]
        assert kw["engine"] == "scan"
        kw.update(params=params, proj=proj)
        seen["port"] = port_loop(bundle, units, tc, **kw)
        return seen["port"]

    monkeypatch.setattr(jax_loop, "train_with_selection", record_ref)
    monkeypatch.setattr(jax_launcher, "train_with_selection", record_ref)
    monkeypatch.setattr(sys.modules[__name__], "train_with_selection",
                        with_reference_draws)
    monkeypatch.setattr(twin, "train_with_selection", with_reference_draws)
    monkeypatch.setattr(launcher, "train_with_selection",
                        with_reference_draws)
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    ref()
    port()
    assert len(seen["port"].selections) >= 1
    _assert_history_parity(seen["ref"], seen["port"], atol=1e-3)
    np.testing.assert_allclose(seen["port"].lr, seen["ref"].lr, rtol=1e-6)
