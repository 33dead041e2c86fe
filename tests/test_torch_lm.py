"""PyTorch port, the decoder-LM path against the JAX reference on
``starcoder2-3b-smoke`` (2 local layers, d 64, 4 heads over 2 KV heads,
window 16, vocab 277) with the reference's params converted through
numpy, at seq 24 so that the window mask bites:

- shared numerics (RMSNorm's ``1 + gamma``, half-split RoPE, tanh GELU);
- ``final_hidden``, ``per_example_loss`` and the grads of ``loss_fn``
  for every leaf: loss within 1e-5, grads within 1e-4 in fp32; with
  ``compute_dtype = "bfloat16"`` the loss at rtol 2e-2 and each gradient
  leaf at 2e-2 relative error in norm (bf16 rounds at other places in
  the two frameworks, so single elements may differ more);
- LM stage A (``units_gradients``, sketch and exact) against the
  reference with ``kernel_impl`` ``pallas`` (interpret mode) and ``xla``,
  within 1e-4 of the largest entry;
- one ``pgm_select`` round: identical indices, weights within atol 1e-4;
- ``train_with_selection`` against the reference's ``engine="host"``
  over 4 epochs (pgm): identical selections, losses within rtol 1e-3;
- the baselines: ``random`` by its invariants (its draws come from a
  ``torch.Generator``), the deterministic ones index for index.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import PGMConfig as JaxPGMConfig  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.core import baselines as jax_bl  # noqa: E402
from repro.core import pgm as jax_pgm  # noqa: E402
from repro.core.lastlayer import make_proj_for as jax_make_proj  # noqa: E402
from repro.core.lastlayer import units_gradients as jax_units_grads  # noqa: E402
from repro.data.pipeline import lm_units, unit_durations  # noqa: E402
from repro.data.synthetic import make_lm_corpus  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.train.loop import train_with_selection as jax_train  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import PGMConfig, TrainConfig  # noqa: E402
from repro_torch.convert import from_numpy  # noqa: E402
from repro_torch.core import baselines as bl  # noqa: E402
from repro_torch.core import pgm  # noqa: E402
from repro_torch.core.lastlayer import units_gradients  # noqa: E402
from repro_torch.core.sketch import Projections  # noqa: E402
from repro_torch.kernels.backend import fp32_numerics  # noqa: E402
from repro_torch.models import attention, common  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.train.loop import train_with_selection  # noqa: E402

ARCH = "starcoder2-3b-smoke"
SEQ = 24


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jax_get_config(ARCH), compute_dtype=dtype),
            dataclasses.replace(get_config(ARCH), compute_dtype=dtype))


def _units(seed, n, noise=0.0):
    return lm_units(make_lm_corpus(seed, n, SEQ, 277, noise_fraction=noise),
                    4)


def _to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _proj(x):
    return Projections(*(torch.from_numpy(np.array(a)) for a in x))


def _at(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


@pytest.fixture(scope="module")
def setup():
    fp32_numerics()
    mj = jax_build(jax_get_config(ARCH))
    params = jax.tree.map(np.asarray, mj.init_params(jax.random.PRNGKey(3)))
    proj = jax_make_proj(mj, jax.random.PRNGKey(4), 16, 16)
    return mj, params, proj, _units(5, 16, noise=0.25), _units(6, 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_numerics_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    gamma = (rng.normal(size=(16,)) * 0.1).astype(np.float32)
    pos = np.broadcast_to(np.arange(7), (2, 7)).astype(np.int32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    tol = 1e-6 if dtype == "float32" else 1e-2
    pairs = [
        (jax_common.rms_norm(jx, jnp.asarray(gamma)),
         common.rms_norm(tx, torch.from_numpy(gamma))),
        (jax_common.apply_rope(jx, jnp.asarray(pos), 1e5),
         common.apply_rope(tx, torch.from_numpy(pos), 1e5)),
        (jax_common.ffn_act("gelu")(jx), common.ffn_act("gelu")(tx)),
    ]
    for want, got in pairs:
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_loss_and_grads_match_reference(setup, dtype):
    _, params, _, units, _ = setup
    cj, ct = _cfgs(dtype)
    mj, mt = jax_build(cj), build_model(ct)
    batch = {k: v[1] for k, v in units.items()}
    batch["weights"] = np.asarray([1.0, 0.5, 2.0, 0.0], np.float32)
    jb = jax.tree.map(jnp.asarray, batch)
    tb, pt = _to_torch(batch), from_numpy(params)

    h_j, t_j, m_j, _ = mj.final_hidden(params, jb)
    h_t, t_t, m_t = mt.final_hidden(pt, tb)
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    assert h_t.dtype == getattr(torch, dtype) and h_t.shape == h_j.shape
    loss_j = np.asarray(mj.per_example_loss(params, jb))
    with torch.no_grad():
        loss_t = mt.per_example_loss(pt, tb).numpy()
    g_j = jax.grad(lambda p: mj.loss_fn(p, jb)[0])(params)
    live = tree_map(lambda x: x.clone().requires_grad_(True), pt)
    total, _ = mt.loss_fn(live, tb)
    total.backward()

    if dtype == "float32":
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    else:
        np.testing.assert_allclose(loss_t, loss_j, rtol=2e-2)
    n_leaves = 0
    for path, want in jax.tree_util.tree_leaves_with_path(g_j):
        got = _at(live, path).grad
        assert got is not None and got.dtype == torch.float32, path
        want = np.asarray(want)
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, err_msg=str(path),
                                       rtol=1e-4, atol=1e-4)
        else:
            # bf16 rounds single elements differently in the two
            # frameworks, so a bf16 gradient is held as a whole tensor
            rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
            assert rel < 2e-2, (path, rel)
        n_leaves += 1
    # embed, final norm, and 8 leaves stacked over the 2 layers
    assert n_leaves == len(tree_leaves(live)) == 10


def test_attention_refuses_what_the_slice_does_not_port(setup):
    cfg = get_config(ARCH)
    # the hybrid family is ported with rec and local blocks (the smoke's
    # local layers alone build), not with full-attention ones
    for bad in (dict(family="vlm"),
                dict(family="encdec"), dict(family="ssm"),
                dict(family="hybrid", pattern=("rec", "attn")),
                dict(pattern=("rec", "rec", "local"))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_model(dataclasses.replace(cfg, **bad))
    # the MoE family is ported; without its experts' settings it is a
    # misconfiguration
    with pytest.raises(ValueError, match="cfg.moe"):
        build_model(dataclasses.replace(cfg, family="moe", moe=None))
    # RWKV6 stacks are served: a prefill fills each layer's recurrent
    # state (tests/test_torch_recurrent_serve.py holds its values)
    rwkv = build_model(get_config("rwkv6-3b-smoke"))
    params = rwkv.init_params(torch.Generator().manual_seed(0),
                              torch.device("cpu"))
    with torch.no_grad():
        _, cache = rwkv.prefill(params, {"tokens": torch.zeros(
            (1, 4), dtype=torch.int32)})
    assert set(cache["groups"][0]) == {"S", "x_tmix", "x_cmix"}


@pytest.mark.parametrize("arch", ["starcoder2-3b", ARCH, "rnnt-crdnn-smoke",
                                  "rwkv6-3b", "rwkv6-3b-smoke"])
def test_configs_match_reference(arch):
    cj, ct = jax_get_config(arch), get_config(arch)
    for f in dataclasses.fields(ct):
        if f.name == "rnnt" and ct.rnnt is not None:
            for g in dataclasses.fields(ct.rnnt):
                assert getattr(ct.rnnt, g.name) == getattr(cj.rnnt, g.name)
        else:
            assert getattr(ct, f.name) == getattr(cj, f.name), f.name
    assert ct.layer_kinds() == cj.layer_kinds()
    assert (ct.q_dim, ct.kv_dim) == (cj.q_dim, cj.kv_dim)
    assert ct.n_params() == cj.n_params()


@pytest.mark.parametrize("exact,impl", [(False, "pallas"), (False, "xla"),
                                        (True, "xla")],
                         ids=["sketch-pallas", "sketch-xla", "exact"])
def test_stage_a_matches_reference(setup, exact, impl):
    mj, params, proj, units, _ = setup
    want = np.asarray(jax_units_grads(
        mj, params, jax.tree.map(jnp.asarray, units), proj, exact=exact,
        kernel_impl=impl))
    got = units_gradients(build_model(get_config(ARCH)), from_numpy(params),
                          _to_torch(units), _proj(proj), exact=exact).numpy()
    assert got.shape == want.shape == (4, 16 * 16 if not exact else 64 * 277)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("val_matching", [False, True])
def test_pgm_select_round_matches_reference(setup, val_matching):
    mj, params, proj, units, val = setup
    pc = dict(subset_fraction=0.5, n_partitions=2, sketch_dim_h=16,
              sketch_dim_v=16, val_matching=val_matching)
    want = jax_pgm.pgm_select(
        mj, params, jax.tree.map(jnp.asarray, units),
        dataclasses.replace(JaxPGMConfig(**pc), kernel_impl="pallas"), proj,
        val_units=jax.tree.map(jnp.asarray, val))
    got = pgm.pgm_select(build_model(get_config(ARCH)), from_numpy(params),
                         _to_torch(units), PGMConfig(**pc), _proj(proj),
                         val_units=_to_torch(val))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               atol=1e-4)
    assert got.n_selected == int(want.n_selected)


def test_train_with_selection_matches_reference_host_engine():
    fp32_numerics()
    units, val = _units(0, 32, noise=0.25), _units(7, 8)
    run = dict(lr=0.5, optimizer="sgd", epochs=4)
    sel = dict(subset_fraction=0.5, n_partitions=2, select_every=2,
               warm_start_epochs=1, sketch_dim_h=16, sketch_dim_v=16,
               val_matching=True)
    tj = JaxTrainConfig(**run, pgm=JaxPGMConfig(**sel))
    mj = jax_build(jax_get_config(ARCH))
    h_j = jax_train(mj, units, tj, method="pgm", val_units=val,
                    engine="host")
    # the reference's initial draws, handed to the port
    key = jax.random.PRNGKey(tj.seed)
    params = jax.tree.map(np.asarray, mj.init_params(key))
    proj = [np.asarray(x) for x in jax_make_proj(
        mj, jax.random.fold_in(key, 17), 16, 16)]
    logs = []
    h_t = train_with_selection(
        build_model(get_config(ARCH)), units,
        TrainConfig(**run, pgm=PGMConfig(**sel)), method="pgm",
        val_units=val, engine="host", device="cpu", params=params,
        proj=proj, log_fn=logs.append)

    assert len(h_t.selections) == len(h_j.selections) == 2
    for st, sj in zip(h_t.selections, h_j.selections):
        assert st["epoch"] == sj["epoch"]
        assert st["indices"] == sj["indices"], (st, sj)
        np.testing.assert_allclose(st["weights"], sj["weights"], atol=1e-4)
    np.testing.assert_allclose(h_t.train_loss, h_j.train_loss, rtol=1e-3)
    np.testing.assert_allclose(h_t.val_loss, h_j.val_loss, rtol=1e-3)
    np.testing.assert_allclose(h_t.lr, h_j.lr, rtol=1e-6)
    assert h_t.cost_units == pytest.approx(h_j.cost_units)
    assert any(line.startswith("epoch 3: train ") for line in logs)


def test_deterministic_baselines_match_reference(setup):
    _, _, _, units, _ = setup
    ties = np.asarray([5.0, 3.0, 5.0, 1.0, 3.0, 5.0], np.float32)
    for dur in (unit_durations(units), ties):      # ties keep unit order
        for budget in (1, 2, 3):
            for name in ("large_only", "large_small"):
                want = getattr(jax_bl, name)(jnp.asarray(dur), budget)
                got = getattr(bl, name)(torch.from_numpy(dur), budget)
                np.testing.assert_array_equal(got.indices.numpy(),
                                              np.asarray(want.indices))
                assert got.weights.tolist() == [1.0] * budget
    g = np.random.default_rng(1).normal(size=(6, 40)).astype(np.float32)
    want = jax_bl.gradmatch_pb(jnp.asarray(g), 3)
    got = bl.gradmatch_pb(torch.from_numpy(g), 3)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               atol=1e-4)


@pytest.mark.parametrize("method", ["random", "large_small", "gradmatch_pb"])
def test_baseline_methods_train_and_keep_their_invariants(method):
    units, val = _units(0, 16), _units(7, 8)
    tc = TrainConfig(lr=0.5, epochs=3, pgm=PGMConfig(
        subset_fraction=0.5, n_partitions=2, select_every=1,
        warm_start_epochs=1, sketch_dim_h=8, sketch_dim_v=8))
    h = train_with_selection(build_model(get_config(ARCH)), units, tc,
                             method=method, val_units=val, device="cpu")
    assert len(h.selections) == 2 and np.isfinite(h.train_loss).all()
    for s in h.selections:
        idx = [i for i in s["indices"] if i >= 0]
        assert len(idx) == len(set(idx)) and all(0 <= i < 4 for i in idx)
        if method != "gradmatch_pb":
            assert len(idx) == 2 and s["weights"] == [1.0, 1.0]
    sel_cost = 2 / 3 if method == "gradmatch_pb" else 0.0
    assert h.cost_units == pytest.approx(1 + 2 * 0.5 + sel_cost)
