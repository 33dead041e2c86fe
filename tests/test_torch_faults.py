"""PyTorch port, the non-finite guard, the divergence watchdog and
preemption (``repro_torch/train/{optim,engine,loop,faults}.py``) on the
host engine, against the reference's host engine under the same
``FaultPlan``, with the reference's initial params and projections handed
to the port (H4), on the CPU.

G1 is held bitwise in the port: a guarded run on finite data equals the
unguarded one; a guarded-off step leaves params and AdamW's step, m and
v as they were, so a poisoned epoch equals the same epoch without that
row; a finite gradient tree whose norm overflows is gated off too.
Against the reference (rtol 1e-3 on losses, the
``tests/test_train_engine.py`` bar; identical subsets): ``nan_step``,
``inf_step`` and ``drop_step`` (G2: the host loop runs a dropped row on
unit -1 with weight 0), and ``nan_epoch`` with a checkpoint (the same
rollbacks and the same log lines).  G2: an injected plan-build failure
raises out of both host loops.  G3: a rollback without a checkpoint
re-initialises from the port's own generator, held by its invariants.
Preemption and resume give the uninterrupted run bit for bit."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import PGMConfig as JaxPGMConfig  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.core.lastlayer import make_proj_for as jax_make_proj  # noqa: E402
from repro.data.pipeline import asr_units  # noqa: E402
from repro.data.synthetic import make_asr_corpus  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.train import faults as jax_faults  # noqa: E402
from repro.train.loop import train_with_selection as jax_train  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import PGMConfig, TrainConfig  # noqa: E402
from repro_torch.convert import from_numpy  # noqa: E402
from repro_torch.kernels.backend import fp32_numerics  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import faults  # noqa: E402
from repro_torch.train.engine import HostEngine, make_step_core  # noqa: E402
from repro_torch.train.loop import train_with_selection  # noqa: E402
from repro_torch.train.optim import (gate_step, make_update_for,  # noqa: E402
                                     tree_all_finite)

ARCH = "rnnt-crdnn-smoke"
RUN = dict(lr=0.05, optimizer="adamw", epochs=4, nonfinite_guard=True)
SEL = dict(subset_fraction=0.5, n_partitions=2, select_every=2,
           warm_start_epochs=1, sketch_dim_h=16, sketch_dim_v=16,
           val_matching=True)


def _units(seed, n, noise=0.0):
    r = jax_get_config(ARCH).rnnt
    return asr_units(make_asr_corpus(seed, n, n_feats=r.n_feats,
                                     vocab_size=r.vocab_size,
                                     noise_fraction=noise), 4)


@pytest.fixture(scope="module")
def data():
    """Training and validation units, and the reference's initial draws
    (params and projections, as numpy)."""
    fp32_numerics()
    mj = jax_build(jax_get_config(ARCH))
    key = jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, mj.init_params(key))
    proj = [np.asarray(x) for x in jax_make_proj(
        mj, jax.random.fold_in(key, 17), 16, 16)]
    return _units(0, 16, noise=0.25), _units(5, 8), params, proj


def _bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _run_both(data, fault, fault_ref, ckpt_dirs=(None, None), **run):
    units, val, params, proj = data
    kw = dict(RUN, **run)
    tj = JaxTrainConfig(**kw, pgm=JaxPGMConfig(**SEL))
    logs_j, logs_t = [], []
    h_j = jax_train(jax_build(jax_get_config(ARCH)), units, tj,
                    method="pgm", val_units=val, engine="host",
                    fault_plan=fault_ref, ckpt_dir=ckpt_dirs[0],
                    log_fn=logs_j.append)
    h_t = train_with_selection(
        build_model(get_config(ARCH)), units,
        TrainConfig(**kw, pgm=PGMConfig(**SEL)), method="pgm",
        val_units=val, engine="host", device="cpu", params=params,
        proj=proj, fault_plan=fault, ckpt_dir=ckpt_dirs[1],
        log_fn=logs_t.append)
    return h_j, h_t, logs_j, logs_t


def _assert_same_run(h_t, h_j):
    assert len(h_t.selections) == len(h_j.selections)
    for st, sj in zip(h_t.selections, h_j.selections):
        assert st["epoch"] == sj["epoch"]
        assert st["indices"] == sj["indices"], (st, sj)
        np.testing.assert_allclose(st["weights"], sj["weights"], atol=1e-4)
    np.testing.assert_allclose(h_t.train_loss, h_j.train_loss, rtol=1e-3)
    np.testing.assert_allclose(h_t.val_loss, h_j.val_loss, rtol=1e-3)
    np.testing.assert_allclose(h_t.lr, h_j.lr, rtol=1e-6)
    assert h_t.skipped_steps == h_j.skipped_steps
    assert h_t.rollbacks == h_j.rollbacks
    assert h_t.cost_units == pytest.approx(h_j.cost_units)


def test_tree_all_finite_and_gate_step():
    t = {"a": torch.ones(3), "b": (torch.zeros(2), torch.ones((), ))}
    assert bool(tree_all_finite(t))
    bad = {"a": torch.tensor([1.0, float("inf"), 0.0]), "b": t["b"]}
    assert not bool(tree_all_finite(bad))
    new = {"a": torch.full((3,), float("nan")),
           "b": (torch.ones(2), torch.zeros(()))}
    off = gate_step(torch.tensor(False), new, t)
    on = gate_step(torch.tensor(True), new, t)
    assert _bitwise(off, t)
    assert torch.equal(on["b"][0], new["b"][0]) and on["a"].isnan().all()


@pytest.mark.parametrize("poison", [float("nan"), float("inf")])
@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_guarded_off_step_leaves_state_bitwise(data, poison, optimizer):
    """G1: one guarded step on a poisoned weight returns params and the
    optimizer state (step counter, moments) bit for bit, zeroes its
    metrics and reports the skip."""
    units, _, params, _ = data
    tc = TrainConfig(lr=0.05, optimizer=optimizer, momentum=0.9,
                     nonfinite_guard=True)
    p = from_numpy(params)
    o = make_update_for(tc)[0](p)
    step = make_step_core(build_model(get_config(ARCH)), tc)
    batch = from_numpy({k: v[0] for k, v in units.items()})
    p1, o1, m1 = step(p, o, batch, tc.lr)          # a finite step first
    assert not bool(m1["skipped"]) and int(o1["step"]) == 1
    batch["weights"] = batch["weights"].clone()
    batch["weights"][2] = poison
    p2, o2, m2 = step(p1, o1, batch, tc.lr)
    assert bool(m2["skipped"])
    assert _bitwise(p2, p1) and _bitwise(o2, o1)
    assert all(float(v) == 0.0 for k, v in m2.items() if k != "skipped")


def test_overflowing_gradient_norm_is_gated_off():
    """G1: the check reads the clipped global norm, so a finite gradient
    tree whose norm overflows fp32 is gated off like a NaN."""

    class Linear:
        def loss_fn(self, params, batch):
            total = torch.sum(params["w"] * batch["x"])
            return total, {"loss": total}

    tc = TrainConfig(lr=0.1, optimizer="sgd", nonfinite_guard=True)
    p = {"w": torch.full((4,), 1e-12)}
    o = make_update_for(tc)[0](p)
    x = torch.full((4,), 1e30)                 # |g|^2 = 4e60 overflows
    p2, o2, m = make_step_core(Linear(), tc)(p, o, {"x": x}, tc.lr)
    assert bool(torch.isfinite(m["skipped"])) and bool(m["skipped"])
    assert _bitwise(p2, p) and _bitwise(o2, o)
    _, _, m_ok = make_step_core(Linear(), tc)(p, o, {"x": x * 1e-20},
                                              tc.lr)
    assert not bool(m_ok["skipped"])


def _engine(data, guard):
    units, _, params, _ = data
    tc = TrainConfig(**dict(RUN, nonfinite_guard=guard),
                     pgm=PGMConfig(**SEL))
    eng = HostEngine(build_model(get_config(ARCH)), tc, units)
    p = from_numpy(params)
    return eng, tc, p, make_update_for(tc)[0](p)


def test_guard_on_finite_data_is_bitwise(data):
    """G1: the guard selects the new state everywhere on finite data."""
    runs = {}
    for guard in (False, True):
        eng, tc, p, o = _engine(data, guard)
        runs[guard] = eng.run_epoch(p, o, tc.lr, eng.full_plan(0))
    (p0, o0, l0), (p1, o1, l1) = runs[False], runs[True]
    assert _bitwise(p0, p1) and _bitwise(o0, o1)
    assert np.array_equal(l0, l1)


def test_skipped_step_equals_epoch_without_that_row(data):
    """G1 at the epoch: a poisoned row gated off leaves the epoch's
    (params, opt state) bitwise those of the same plan without it."""
    eng, tc, p, o = _engine(data, True)
    idx, w = eng.full_plan(0)
    poisoned = np.array(w, copy=True)
    poisoned[1] = np.nan
    p_a, o_a, l_a = eng.run_epoch(p, o, tc.lr, (idx, poisoned))
    assert eng.last_n_skipped == 1
    assert eng.last_skipped.tolist() == [0.0, 1.0, 0.0, 0.0]
    assert l_a[1] == 0.0                   # a skipped step reports 0
    keep = np.arange(len(w)) != 1
    p_b, o_b, _ = eng.run_epoch(p, o, tc.lr, (idx[keep], w[keep]))
    assert _bitwise(p_a, p_b) and _bitwise(o_a, o_b)


@pytest.mark.parametrize("kind", ["nan_step", "inf_step", "drop_step"])
def test_step_faults_match_reference_host_engine(data, kind):
    h_j, h_t, logs_j, logs_t = _run_both(
        data, faults.FaultPlan(**{kind: (2, 1)}),
        jax_faults.FaultPlan(**{kind: (2, 1)}))
    _assert_same_run(h_t, h_j)
    assert h_t.skipped_steps == (0 if kind == "drop_step" else 1)
    assert h_t.rollbacks == 0 and len(h_t.val_loss) == RUN["epochs"]
    assert np.isfinite(h_t.val_loss).all()
    guard_lines = lambda logs: [l for l in logs if l.startswith("guard")]
    assert guard_lines(logs_t) == guard_lines(logs_j)


def test_nan_epoch_rollback_matches_reference(data, tmp_path):
    """An epoch of skips trips the watchdog; both packages roll back to
    the checkpoint of the epoch before with re-keyed plans and finish."""
    h_j, h_t, logs_j, logs_t = _run_both(
        data, faults.FaultPlan(nan_epoch=2),
        jax_faults.FaultPlan(nan_epoch=2),
        ckpt_dirs=(str(tmp_path / "ref"), str(tmp_path / "port")),
        max_skipped_steps=2)
    _assert_same_run(h_t, h_j)
    assert h_t.rollbacks == 1 and h_t.skipped_steps >= 2
    assert len(h_t.val_loss) == RUN["epochs"]
    assert any("rolled back to epoch 2" in l for l in logs_t)
    no_loss = lambda logs: [l for l in logs if ": train " not in l]
    assert no_loss(logs_t) == no_loss(logs_j)


def test_plan_build_failure_raises_out_of_both_host_loops(data):
    """G2: the host loops have no prefetcher, so an injected plan-build
    failure is not retried."""
    with pytest.raises(RuntimeError, match="injected prefetch failure"):
        _run_both(data, None,
                  jax_faults.FaultPlan(prefetch_fail_epochs=(1,)))
    units, val, params, proj = data
    with pytest.raises(RuntimeError, match="injected prefetch failure"):
        train_with_selection(
            build_model(get_config(ARCH)), units,
            TrainConfig(**RUN, pgm=PGMConfig(**SEL)), val_units=val,
            engine="host", device="cpu", params=params, proj=proj,
            fault_plan=faults.FaultPlan(prefetch_fail_epochs=(1,)))


class _EveryTime(faults.FaultPlan):
    """A fault plan whose faults fire on every replay."""

    def _once(self, tag):
        return True


def _port_run(data, tc, **kw):
    units, val, params, proj = data
    logs = []
    h = train_with_selection(build_model(get_config(ARCH)), units, tc,
                             method="pgm", val_units=val, device="cpu",
                             params=params, proj=proj, log_fn=logs.append,
                             **kw)
    return h, logs


def test_rollback_without_checkpoint_reinitialises(data):
    """G3: without a checkpoint the watchdog re-initialises from a
    re-keyed generator and restarts at epoch 0; the run finishes finite
    on fresh params (held by invariants, not values)."""
    tc = TrainConfig(**dict(RUN, max_skipped_steps=2), pgm=PGMConfig(**SEL))
    h, logs = _port_run(data, tc, fault_plan=faults.FaultPlan(nan_epoch=1))
    assert h.rollbacks == 1
    assert any("restarting from re-initialised state" in l for l in logs)
    assert len(h.train_loss) == tc.epochs + 1     # epoch 0 ran twice
    assert np.isfinite(h.train_loss).all() and np.isfinite(h.val_loss).all()
    h0, _ = _port_run(data, dataclasses.replace(tc, epochs=1))
    assert h.train_loss[0] == h0.train_loss[0]
    assert h.train_loss[1] != h0.train_loss[0]    # new draws, new run


def test_watchdog_gives_up_after_three_rollbacks(data):
    tc = TrainConfig(**dict(RUN, epochs=2, max_skipped_steps=2),
                     pgm=PGMConfig(**SEL))
    with pytest.raises(RuntimeError, match="giving up after 3 rollbacks"):
        _port_run(data, tc, fault_plan=_EveryTime(nan_epoch=0))


def test_preempt_then_resume_is_bitwise_uninterrupted(data, tmp_path):
    tc = TrainConfig(**RUN, pgm=PGMConfig(**SEL))
    h_full, _ = _port_run(data, tc)
    d = str(tmp_path / "ck")
    h_cut, logs = _port_run(data, tc, ckpt_dir=d,
                            fault_plan=faults.FaultPlan(
                                preempt_after_epoch=1))
    assert h_cut.preempted and len(h_cut.train_loss) == 2
    assert any("emergency checkpoint at epoch 1" in l for l in logs)
    manifest = ckpt.read_manifest(d)
    assert manifest["extra"]["preempted"] is True
    assert manifest["extra"]["epoch"] == 1
    h_res, logs = _port_run(data, tc, ckpt_dir=d, resume=True)
    assert logs[0] == "resumed at epoch 2"
    assert h_cut.train_loss + h_res.train_loss == h_full.train_loss
    assert h_cut.val_loss + h_res.val_loss == h_full.val_loss
    assert h_cut.selections[0]["indices"] == h_full.selections[0]["indices"]
    assert h_res.selections[0]["indices"] == h_full.selections[1]["indices"]
    assert h_res.selections[0]["weights"] == h_full.selections[1]["weights"]
    assert _bitwise(h_res.final_params, h_full.final_params)
