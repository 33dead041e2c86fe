"""PyTorch port, training: one weighted step (params within 1e-5 of the
JAX reference's under SGD; AdamW moments within 1e-5), the loss-vocab-chunk
auto-tune, and a 4-epoch ``train_with_selection(method="pgm",
engine="host")`` run on ``rnnt-crdnn-smoke`` against the JAX host engine
with the reference's initial params and projections: the same subset in
every selection round, and per-epoch train/val loss within rtol 1e-3
(the ``tests/test_train_engine.py`` bar)."""
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
from repro.train.engine import autotune_loss_vocab_chunk as jax_autotune  # noqa: E402
from repro.train.engine import make_step_core as jax_step_core  # noqa: E402
from repro.train.loop import train_with_selection as jax_train  # noqa: E402
from repro.train.optim import make_update_for as jax_update_for  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import PGMConfig, TrainConfig  # noqa: E402
from repro_torch.convert import from_numpy, to_numpy  # noqa: E402
from repro_torch.kernels.backend import fp32_numerics  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.train.engine import (autotune_loss_vocab_chunk,  # noqa: E402
                                      make_step_core)
from repro_torch.train.loop import train_with_selection  # noqa: E402
from repro_torch.train.optim import make_update_for  # noqa: E402

ARCH = "rnnt-crdnn-smoke"


def _units(seed, n, noise=0.0):
    r = jax_get_config(ARCH).rnnt
    return asr_units(make_asr_corpus(seed, n, n_feats=r.n_feats,
                                     vocab_size=r.vocab_size,
                                     noise_fraction=noise), 4)


def _leaves_close(got, want, tol):
    """Nested dict of tensors (port) vs nested dict of arrays (JAX)."""
    got = to_numpy(got)
    flat = jax.tree_util.tree_leaves_with_path(want)
    for path, w in flat:
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=tol,
                                   rtol=tol, err_msg=str(path))


@pytest.mark.parametrize("optimizer,lr", [("sgd", 0.5), ("adamw", 0.05)])
def test_one_step_matches_reference(optimizer, lr):
    fp32_numerics()
    kw = dict(lr=lr, optimizer=optimizer, grad_clip=1.0)
    mj = jax_build(jax_get_config(ARCH))
    params = jax.tree.map(np.asarray, mj.init_params(jax.random.PRNGKey(0)))
    u = _units(0, 8)
    batch = {k: v[0] for k, v in u.items()}
    batch["weights"] = np.asarray([1.0, 0.5, 2.0, 0.0], np.float32)
    tj = JaxTrainConfig(**kw)
    opt_j = jax_update_for(tj)[0](params)
    p_j, o_j, m_j = jax.jit(jax_step_core(mj, tj))(
        params, opt_j, jax.tree.map(jnp.asarray, batch), lr)

    tt = TrainConfig(**kw)
    pt = from_numpy(params)
    opt_t = make_update_for(tt)[0](pt)
    p_t, o_t, m_t = make_step_core(build_model(get_config(ARCH)), tt)(
        pt, opt_t, {k: torch.from_numpy(v) for k, v in batch.items()}, lr)

    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m_t["grad_norm"]),
                               float(m_j["grad_norm"]), rtol=1e-5)
    if optimizer == "adamw":
        _leaves_close(o_t["m"], jax.tree.map(np.asarray, o_j["m"]), 1e-5)
        _leaves_close(o_t["v"], jax.tree.map(np.asarray, o_j["v"]), 1e-5)
        # Adam's first step moves each weight by ~lr * g / (|g| + eps):
        # where |g| is near eps = 1e-8 that ratio amplifies the fp32
        # rounding of g, so the params are held at 1e-4 here and at 1e-5
        # under SGD, whose step is linear in g
        _leaves_close(p_t, jax.tree.map(np.asarray, p_j), 1e-4)
    else:
        _leaves_close(p_t, jax.tree.map(np.asarray, p_j), 1e-5)
    # the inputs are left as they were (functional update)
    _leaves_close(pt, params, 0.0)


@pytest.mark.parametrize("U,batch_units", [(12, 1), (32, 4), (64, 8)])
def test_vocab_chunk_autotune_matches_reference(U, batch_units):
    units = {"tokens": np.zeros((2, 4, U), np.int32)}
    _, want = jax_autotune(jax_build(jax_get_config("rnnt-crdnn")), units,
                           batch_units)
    bundle, got = autotune_loss_vocab_chunk(
        build_model(get_config("rnnt-crdnn")), units, batch_units)
    assert got == want
    assert bundle.cfg.rnnt.loss_vocab_chunk == (got if got < 1000 else 0)


def test_train_with_selection_matches_reference_host_engine():
    fp32_numerics()
    units, val = _units(0, 16, noise=0.25), _units(5, 8)
    run = dict(lr=0.05, optimizer="adamw", epochs=4)
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
