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
float equals a 0-dim fp32 tensor.  ``bucket_steps``, the plans and
``epoch_cost`` equal the reference's; ``newbob_step`` equals the
reference's bit for bit over a grid with inf and NaN.

The chaos faults on the scan engine and the entry points that run it
are in ``tests/test_torch_engine_faults.py`` (split out so that
``--dist loadfile`` can run the two halves on two workers); the shared
setup is ``tests/torch_engine_helpers.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import PGMConfig as JaxPGMConfig  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.train.engine import EpochEngine as JaxEpochEngine  # noqa: E402
from repro.train.engine import newbob_step as jax_newbob_step  # noqa: E402
from repro.train.loop import train_with_selection as jax_train  # noqa: E402
from repro.train.optim import make_update_for as jax_update_for  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import PGMConfig, TrainConfig  # noqa: E402
from repro_torch.convert import from_numpy  # noqa: E402
from repro_torch.data.pipeline import subset_epoch_plan  # noqa: E402
from repro_torch.kernels.backend import fp32_numerics  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.train import faults  # noqa: E402
from repro_torch.train.engine import (EpochEngine, make_engine,  # noqa: E402
                                      make_step_core, newbob_step)
from repro_torch.train.loop import train_with_selection  # noqa: E402
from repro_torch.train.optim import (make_update_for,  # noqa: E402
                                     make_update_in_place)
from torch_engine_helpers import (ARCHS, _assert_history_parity,  # noqa: E402
                                  _bitwise, _reference_draws, _setup,
                                  _snapshot)


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
        with pytest.raises(ValueError, match=r"must be a torch.distributed "
                           r"DeviceMesh"):
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
