"""PyTorch port, the scanned epoch engine (``repro_torch/train/engine.py:
EpochEngine``, ``newbob_step``, ``make_engine``; ``train/optim.py``'s
in-place commit; the scan branch of ``train/loop.py``) against the
reference's ``EpochEngine``, on the CPU, where the engine runs its step
body once a plan row without a graph.

``train_with_selection(engine="scan")`` on ``rnnt-crdnn-smoke``,
``starcoder2-3b-smoke`` and ``rwkv6-3b-smoke``, per epoch and in chunks
of 2, with the reference's initial params and projections: the same
subsets, losses and weights within atol 1e-3
(``tests/test_train_engine.py``'s ``_assert_history_parity``), the same
``cost_units``.  Bitwise in the port: padding rows and guarded-off steps
are no-ops on params and optimizer state, the guard composes with the
padding gate, a chunk equals its epochs run one by one with the device
newbob between them, a resume mid-chunk equals the uninterrupted run,
the in-place update equals the functional one, and ``lr`` as a Python
float equals a 0-dim fp32 tensor.  Under ``tests/test_chaos.py``'s
faults (an epoch of NaN steps with and without a checkpoint, per epoch
and in chunks of 2, and one NaN step), the watchdog's rollbacks, skips,
log lines and subsets equal the reference scan engine's.  ``bucket_steps``, the plans and
``epoch_cost`` equal the reference's; ``newbob_step`` equals the
reference's bit for bit over a grid with inf and NaN.

The four calls that raised before the engine was ported (the twin with
``--engine scan`` and with ``--epoch-chunk 2``, the launcher with
``--engine scan --epoch-chunk 2``, ``train_with_selection(engine=
"scan")``) now run against the same calls of the reference, with the
reference's initial draws handed to the port."""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import PGMConfig as JaxPGMConfig  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.core.lastlayer import make_proj_for as jax_make_proj  # noqa: E402
from repro.data.pipeline import asr_units, lm_units  # noqa: E402
from repro.data.synthetic import make_asr_corpus, make_lm_corpus  # noqa: E402
import repro.launch.train as jax_launcher  # noqa: E402
import repro.train.loop as jax_loop  # noqa: E402
from repro.train import faults as jax_faults  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.train.engine import EpochEngine as JaxEpochEngine  # noqa: E402
from repro.train.engine import newbob_step as jax_newbob_step  # noqa: E402
from repro.train.loop import train_with_selection as jax_train  # noqa: E402
from repro.train.optim import make_update_for as jax_update_for  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import PGMConfig, TrainConfig  # noqa: E402
from repro_torch.convert import from_numpy  # noqa: E402
from repro_torch.data.pipeline import subset_epoch_plan  # noqa: E402
from repro_torch.examples import train_asr_pgm as twin  # noqa: E402
from repro_torch.kernels.backend import fp32_numerics  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.train import faults  # noqa: E402
from repro_torch.train.engine import (EpochEngine, make_engine,  # noqa: E402
                                      make_step_core, newbob_step)
from repro_torch.train.loop import train_with_selection  # noqa: E402
from repro_torch.train.optim import (make_update_for,  # noqa: E402
                                     make_update_in_place)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("rnnt-crdnn-smoke", "starcoder2-3b-smoke", "rwkv6-3b-smoke")
SKETCH = dict(sketch_dim_h=16, sketch_dim_v=16)


def _setup(arch):
    """Units, validation units and the run of ``tests/test_train_engine.py``
    (RNN-T: units of 4 utterances, AdamW; LMs: units of 2 short rows,
    SGD), cut to 3 epochs."""
    cfg = jax_get_config(arch)
    if cfg.family == "rnnt":
        r = cfg.rnnt
        units = asr_units(make_asr_corpus(0, 16, n_feats=r.n_feats,
                                          vocab_size=r.vocab_size,
                                          noise_fraction=0.25), 4)
        val = asr_units(make_asr_corpus(5, 8, n_feats=r.n_feats,
                                        vocab_size=r.vocab_size), 4)
        run = dict(lr=0.05, optimizer="adamw", epochs=3)
        sel = dict(subset_fraction=0.5, n_partitions=2, select_every=2,
                   warm_start_epochs=1, val_matching=True, **SKETCH)
    else:
        seq = 12 if arch.startswith("starcoder2") else 10
        units = lm_units(make_lm_corpus(0, 16, seq, cfg.vocab_size,
                                        hard_fraction=0.4), 2)
        val = lm_units(make_lm_corpus(7, 8, seq, cfg.vocab_size), 2)
        run = dict(lr=0.5, optimizer="sgd", epochs=3)
        sel = dict(subset_fraction=0.5, n_partitions=2, select_every=2,
                   warm_start_epochs=1, **SKETCH)
    return units, val, run, sel


def _reference_draws(arch, seed=0):
    mj = jax_build(jax_get_config(arch))
    key = jax.random.PRNGKey(seed)
    params = jax.tree.map(np.asarray, mj.init_params(key))
    proj = [np.asarray(x) for x in jax_make_proj(
        mj, jax.random.fold_in(key, 17), SKETCH["sketch_dim_h"],
        SKETCH["sketch_dim_v"])]
    return mj, params, proj


def _assert_history_parity(h_ref, h_port, atol):
    """``tests/test_train_engine.py:_assert_history_parity``."""
    assert np.allclose(h_ref.train_loss, h_port.train_loss, atol=atol), \
        (h_ref.train_loss, h_port.train_loss)
    assert np.allclose(h_ref.val_loss, h_port.val_loss, atol=atol), \
        (h_ref.val_loss, h_port.val_loss)
    assert len(h_ref.selections) == len(h_port.selections)
    for sr, sp in zip(h_ref.selections, h_port.selections):
        assert sr["epoch"] == sp["epoch"]
        assert sr["indices"] == sp["indices"], (sr, sp)
        assert np.allclose(sr["weights"], sp["weights"], atol=atol)
    assert h_ref.cost_units == pytest.approx(h_port.cost_units)


def _bitwise(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _snapshot(tree):
    return tree_map(lambda x: x.detach().clone(), tree)


@pytest.mark.parametrize("arch,chunk", [
    ("rnnt-crdnn-smoke", 1), ("starcoder2-3b-smoke", 1),
    ("starcoder2-3b-smoke", 2), ("rwkv6-3b-smoke", 1),
    ("rwkv6-3b-smoke", 2)])     # RNN-T in chunks: the twin's case below
def test_scan_engine_matches_reference_scan_engine(arch, chunk):
    fp32_numerics()
    units, val, run, sel = _setup(arch)
    mj, params, proj = _reference_draws(arch)
    h_j = jax_train(mj, units, JaxTrainConfig(**run, pgm=JaxPGMConfig(**sel)),
                    method="pgm", val_units=val, batch_units=2,
                    engine="scan", epoch_chunk=chunk)
    h_t = train_with_selection(
        build_model(get_config(arch)), units,
        TrainConfig(**run, pgm=PGMConfig(**sel)), method="pgm",
        val_units=val, batch_units=2, engine="scan", epoch_chunk=chunk,
        device="cpu", params=params, proj=proj)
    assert len(h_t.selections) == 1 and len(h_t.train_loss) == run["epochs"]
    _assert_history_parity(h_j, h_t, atol=1e-3)
    np.testing.assert_allclose(h_t.lr, h_j.lr, rtol=1e-6)


def _engine(arch, guard=False, batch_units=2):
    units, _, run, sel = _setup(arch)
    tc = TrainConfig(**run, nonfinite_guard=guard, pgm=PGMConfig(**sel))
    _, params, _ = _reference_draws(arch)
    eng = EpochEngine(build_model(get_config(arch)), tc, units,
                      batch_units=batch_units)
    p = from_numpy(params)
    return eng, tc, p, make_update_for(tc)[0](p)


@pytest.mark.parametrize("arch", ARCHS)
def test_padding_rows_are_bitwise_noops(arch):
    """An all-padding plan leaves params and optimizer state (the step
    counter included) bit for bit as they were, and reports losses of 0
    (``tests/test_train_engine.py``'s recurrent padding test on every
    family)."""
    eng, tc, p, o = _engine(arch)
    p, o, _ = eng.run_epoch(p, o, tc.lr, eng.full_plan(0))
    before = _snapshot((p, o))
    pad = (np.full((2, 2), -1, np.int32), np.zeros((2, 2), np.float32))
    p2, o2, losses = eng.run_epoch(p, o, tc.lr, pad)
    assert p2 is p and o2 is o             # the engine's buffers, in place
    assert losses.tolist() == [0.0, 0.0]
    assert _bitwise(before, (p2, o2))


def test_guard_composes_with_padding_gate_bitwise():
    """``tests/test_train_engine.py::test_guard_composes_with_padding_
    gate_bitwise``: guard on equals guard off bitwise on a plan of real
    and padding rows, padding is not counted as skipped, and a poisoned
    real row gates off exactly like a padding row."""
    idx = np.asarray([[0, 1], [-1, -1]], np.int32)
    w = np.asarray([[1.0, 1.0], [0.0, 0.0]], np.float32)
    outs = {}
    for guard in (False, True):
        eng, tc, p, o = _engine("starcoder2-3b-smoke", guard)
        outs[guard] = eng.run_epoch(p, o, tc.lr, (idx, w))
        if guard:
            assert int(eng.last_n_skipped) == 0
            assert eng.last_skipped.tolist() == [0.0, 0.0]
    assert _bitwise(outs[False][:2], outs[True][:2])
    assert outs[False][2].tolist() == outs[True][2].tolist()
    eng, tc, p, o = _engine("starcoder2-3b-smoke", True)
    w_nan = np.asarray([[np.nan, np.nan], [0.0, 0.0]], np.float32)
    p2, o2, losses = eng.run_epoch(p, o, tc.lr, (idx, w_nan))
    assert int(eng.last_n_skipped) == 1 and losses.tolist() == [0.0, 0.0]
    got = _snapshot((p2, o2))
    eng, tc, p, o = _engine("starcoder2-3b-smoke", True)
    pad = (np.full((2, 2), -1, np.int32), np.zeros((2, 2), np.float32))
    assert _bitwise(got, eng.run_epoch(p, o, tc.lr, pad)[:2])


def test_skipped_step_equals_padding_row_bitwise():
    """``tests/test_chaos.py::test_skipped_step_equals_padding_row_
    bitwise``: a guarded-off NaN step leaves the state (step counter
    included) bit for bit as running that row as padding."""
    outs = []
    for poison in (True, False):
        eng, tc, p, o = _engine("starcoder2-3b-smoke", True)
        idx, w = eng.full_plan(0)
        idx, w = idx.copy(), w.copy()
        if poison:
            w[2] = np.nan
        else:
            idx[2], w[2] = -1, 0.0
        outs.append(_snapshot(eng.run_epoch(p, o, tc.lr, (idx, w))[:2]))
        assert int(eng.last_n_skipped) == (1 if poison else 0)
    assert _bitwise(outs[0], outs[1])


def test_bucket_steps_plans_and_epoch_cost_match_reference():
    units, _, run, sel = _setup("starcoder2-3b-smoke")
    tc = TrainConfig(**run, pgm=PGMConfig(**sel))
    tj = JaxTrainConfig(**run, pgm=JaxPGMConfig(**sel))
    for bu in (1, 2):
        ours = EpochEngine(build_model(get_config("starcoder2-3b-smoke")),
                           tc, units, batch_units=bu)
        ref = JaxEpochEngine(jax_build(jax_get_config("starcoder2-3b-smoke")),
                             tj, units, batch_units=bu)
        assert (ours.steps_per_epoch_max, ours.plan_granule) == \
            (ref.steps_per_epoch_max, ref.plan_granule)
        for n in range(0, ours.steps_per_epoch_max + 2):
            assert ours.bucket_steps(n) == ref.bucket_steps(n)
        idx = np.asarray([3, 1, -1, 5, 0], np.int32)
        wts = np.asarray([1.5, 0.5, 0.0, 2.0, 1.0], np.float32)
        for plans in ((ours.full_plan(3), ref.full_plan(3)),
                      (ours.subset_plan(idx, wts, 2),
                       ref.subset_plan(idx, wts, 2))):
            (oi, ow), (ri, rw) = plans
            assert np.array_equal(oi, np.asarray(ri))
            assert np.array_equal(ow, np.asarray(rw))
            assert ours.epoch_cost(plans[0], n_selected=4) == \
                ref.epoch_cost(plans[1], n_selected=4)
            assert ours.plan_live_steps(plans[0]).tolist() == \
                ref.plan_live_steps(plans[1]).tolist()


def test_run_epochs_equals_its_epochs_one_by_one():
    """A chunk of two epochs equals ``run_epoch`` twice with validation
    and ``newbob_step`` between them on the device, bit for bit; and the
    reference's ``run_epochs`` on the same params within 1e-3."""
    arch = "rnnt-crdnn-smoke"
    units, val, run, sel = _setup(arch)
    tc = TrainConfig(**run, pgm=PGMConfig(**sel))
    mj, params, _ = _reference_draws(arch)
    bundle = build_model(get_config(arch))
    # the second plan a padded subset plan of the full plans' shape
    a = EpochEngine(bundle, tc, units, val_units=val)
    plans = [a.full_plan(0), subset_epoch_plan(
        np.asarray([2, 0, -1, 3]), np.asarray([1.5, 0.5, 0., 1.]), tc.seed,
        1, 1, pad_to_steps=4)]
    p = from_numpy(params)
    o = make_update_for(tc)[0](p)
    pa, oa, losses, vls, lrs, lr_out, prev_out = a.run_epochs(
        p, o, tc.lr, float("inf"), plans)
    b = EpochEngine(bundle, tc, units, val_units=val)
    lr, prev = torch.tensor(tc.lr), torch.tensor(float("inf"))
    pb, ob = p, o
    for i, plan in enumerate(plans):
        pb, ob, l_i = b.run_epoch(pb, ob, lr, plan)
        vl = torch.tensor(b.validate(pb))
        lr, prev = newbob_step(lr, prev, vl, tc.anneal_factor,
                               tc.improvement_threshold)
        assert l_i.tolist() == losses[i].tolist()
        assert float(vl) == vls[i] and float(lr) == lrs[i]
    assert (float(lr), float(prev)) == (lr_out, prev_out)
    assert _bitwise((pa, oa), (pb, ob))

    ref = JaxEpochEngine(mj, JaxTrainConfig(**run, pgm=JaxPGMConfig(**sel)),
                         units, val_units=val)
    pj = jax.tree.map(jnp.asarray, params)
    _, _, l_j, v_j, lr_j, _, _ = ref.run_epochs(
        pj, jax_update_for(ref.cfg)[0](pj), tc.lr, float("inf"),
        [tuple(map(jnp.asarray, pl)) for pl in plans])
    np.testing.assert_allclose(losses, np.asarray(l_j), atol=1e-3)
    np.testing.assert_allclose(vls, np.asarray(v_j), atol=1e-3)
    np.testing.assert_allclose(lrs, np.asarray(lr_j), rtol=1e-6)


def test_newbob_step_matches_reference_bitwise():
    inf, nan = float("inf"), float("nan")
    prevs = [inf, nan, 4.0, 4.0, 1e-12, -2.0, 0.0, 3.3]
    vals = [3.99, 3.0, 4.0, 5.0, nan, inf, 1e-12, 3.2999]
    for lr in (0.05, 2.0):
        for prev in prevs:
            for val in vals:
                want = jax_newbob_step(jnp.float32(lr), jnp.float32(prev),
                                       jnp.float32(val), 0.8, 0.0025)
                got = newbob_step(torch.tensor(lr), torch.tensor(prev),
                                  torch.tensor(val), 0.8, 0.0025)
                for g, w in zip(got, want):
                    assert g.dtype == torch.float32
                    assert np.float32(g.item()).tobytes() == \
                        np.asarray(w, np.float32).tobytes(), \
                        (lr, prev, val, g, w)


def test_resume_mid_chunk_is_bitwise(tmp_path):
    """``tests/test_train_engine.py::test_emergency_checkpoint_resume_bit_
    exact_mid_chunk``: chunks [0], [1, 2], [3]; a SIGTERM after epoch 1
    lands mid-chunk, the checkpoint is cut at epoch 2, and the resumed run
    continues the uninterrupted one bit for bit (guard on)."""
    units, val, run, sel = _setup("starcoder2-3b-smoke")
    tc = TrainConfig(**dict(run, epochs=4), nonfinite_guard=True,
                     pgm=PGMConfig(**sel))
    _, params, proj = _reference_draws("starcoder2-3b-smoke")

    def go(**kw):
        return train_with_selection(
            build_model(get_config("starcoder2-3b-smoke")), units, tc,
            method="pgm", val_units=val, batch_units=2, engine="scan",
            epoch_chunk=2, device="cpu", params=params, proj=proj, **kw)

    d = str(tmp_path / "ck")
    h_full = go()
    h_cut = go(ckpt_dir=d, fault_plan=faults.FaultPlan(preempt_after_epoch=1))
    assert h_cut.preempted and len(h_cut.val_loss) == 3
    h_res = go(ckpt_dir=d, resume=True)
    assert h_cut.val_loss + h_res.val_loss == h_full.val_loss
    assert h_cut.train_loss + h_res.train_loss == h_full.train_loss
    assert h_cut.lr + h_res.lr == h_full.lr
    assert _bitwise(h_res.final_params, h_full.final_params)


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_lr_float_and_tensor_and_in_place_update_are_bitwise(optimizer):
    """One step at lr 0.05 as a Python float, as a 0-dim fp32 tensor, and
    committed in place leaf by leaf: the same bits."""
    arch = "rnnt-crdnn-smoke"
    units, _, _, sel = _setup(arch)
    momentum = 0.9 if optimizer == "sgd" else 0.0
    tc = TrainConfig(lr=0.05, optimizer=optimizer, momentum=momentum,
                     weight_decay=0.01, pgm=PGMConfig(**sel))
    _, params, _ = _reference_draws(arch)
    bundle = build_model(get_config(arch))
    batch = {k: torch.as_tensor(v[0]) for k, v in units.items()}
    outs = []
    for lr, in_place in ((0.05, False), (torch.tensor(0.05), False),
                         (torch.tensor(0.05), True)):
        p = from_numpy(params)
        o = make_update_for(tc)[0](p)
        update = make_update_in_place(tc) if in_place else None
        p2, o2, _ = make_step_core(bundle, tc, update=update)(
            p, o, batch, lr, step_on=torch.tensor(True))
        assert (p2 is p and o2 is o) == in_place
        outs.append((p2, o2))
    assert not _bitwise(outs[0][0], from_numpy(params))   # it moved
    assert _bitwise(outs[0], outs[1]) and _bitwise(outs[1], outs[2])
    # the in-place update gated off is a no-op on every leaf
    p = from_numpy(params)
    o = make_update_for(tc)[0](p)
    before = _snapshot((p, o))
    grads = tree_map(torch.ones_like, p)
    make_update_in_place(tc)(p, grads, o, 0.05, step_on=torch.tensor(False))
    assert _bitwise(before, (p, o))


def test_engine_factory_and_mesh_refusal():
    units, val, run, sel = _setup("starcoder2-3b-smoke")
    tc = TrainConfig(**run, pgm=PGMConfig(**sel))
    bundle = build_model(get_config("starcoder2-3b-smoke"))
    assert make_engine("scan", bundle, tc, units).kind == "scan"
    assert make_engine("host", bundle, tc, units).kind == "host"
    for name in ("scan", "host"):
        with pytest.raises(ValueError, match=r"queue 1, item 10"):
            make_engine(name, bundle, tc, units, mesh=object())
    with pytest.raises(ValueError, match="unknown engine"):
        make_engine("pod", bundle, tc, units)
    eng = EpochEngine(bundle, tc, units)
    with pytest.raises(ValueError, match="at most 8 rows"):
        eng.run_epoch(*_engine("starcoder2-3b-smoke")[2:], tc.lr,
                      (np.zeros((9, 1), np.int32),
                       np.ones((9, 1), np.float32)))
    with pytest.raises(ValueError, match="share one shape"):
        eng.run_epochs(*_engine("starcoder2-3b-smoke")[2:], tc.lr, 1.0,
                       [eng.full_plan(0), eng.subset_plan(
                           np.asarray([0, 1]), np.ones(2, np.float32), 1)])


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
