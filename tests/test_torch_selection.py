"""PyTorch port, PGM selection against the JAX reference on the same
inputs: stage A (per-unit joint-head gradients, exact and sketched, from
the fused backward) within 1e-4 of the largest entry; stage B
(``gram_omp`` with both solvers, ``partitioned_gm`` with train and
validation matching) with identical indices and weights within atol
1e-4 (the ``tests/test_selection_kernels.py`` bar); and one whole
``pgm_select`` round on converted ``rnnt-crdnn-smoke`` parameters.
The JAX Gram runs as its Pallas kernel in interpret mode."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import PGMConfig as JaxPGMConfig  # noqa: E402
from repro.core import gm as jax_gm  # noqa: E402
from repro.core import pgm as jax_pgm  # noqa: E402
from repro.core.lastlayer import make_proj_for as jax_make_proj  # noqa: E402
from repro.core.lastlayer import units_gradients as jax_units_grads  # noqa: E402
from repro.core.sketch import Projections as JaxProjections  # noqa: E402
from repro.core.sketch import sketch_from_factors as jax_sketch  # noqa: E402
from repro.data.pipeline import asr_units as jax_asr_units  # noqa: E402
from repro.data.synthetic import make_asr_corpus as jax_corpus  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import PGMConfig  # noqa: E402
from repro_torch.convert import from_numpy  # noqa: E402
from repro_torch.core import gm, pgm  # noqa: E402
from repro_torch.core.lastlayer import units_gradients  # noqa: E402
from repro_torch.core.sketch import (Projections,  # noqa: E402
                                     sketch_from_factors)
from repro_torch.kernels.backend import fp32_numerics  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402

ARCH = "rnnt-crdnn-smoke"


@pytest.fixture(scope="module")
def setup():
    fp32_numerics()
    cj = jax_get_config(ARCH)
    mj = jax_build(cj)
    r = cj.rnnt
    params = jax.tree.map(np.asarray,
                          mj.init_params(jax.random.PRNGKey(1)))
    proj = jax_make_proj(mj, jax.random.PRNGKey(2), 8, 8)
    units = jax_asr_units(jax_corpus(3, 12, n_feats=r.n_feats,
                                     vocab_size=r.vocab_size,
                                     noise_fraction=0.3), 4)
    val = jax_asr_units(jax_corpus(4, 8, n_feats=r.n_feats,
                                   vocab_size=r.vocab_size), 4)
    return mj, params, proj, units, val


def _to_torch(units):
    return {k: torch.from_numpy(np.array(v)) for k, v in units.items()}


@pytest.mark.parametrize("exact", [False, True], ids=["sketch", "exact"])
def test_stage_a_matches_reference(setup, exact):
    mj, params, proj, units, _ = setup
    want = np.asarray(jax_units_grads(
        mj, params, jax.tree.map(jnp.asarray, units), proj, exact=exact))
    got = units_gradients(build_model(get_config(ARCH)), from_numpy(params),
                          _to_torch(units),
                          Projections(*(torch.from_numpy(np.array(x))
                                        for x in proj)), exact=exact).numpy()
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_sketch_from_factors_matches_reference():
    rng = np.random.default_rng(5)
    h, e = (rng.normal(size=(40, d)).astype(np.float32) for d in (12, 30))
    r_h, r_v = (rng.normal(size=s).astype(np.float32)
                for s in ((12, 4), (30, 6)))
    want = np.asarray(jax_sketch(jnp.asarray(h), jnp.asarray(e),
                                 JaxProjections(jnp.asarray(r_h),
                                                jnp.asarray(r_v))))
    got = sketch_from_factors(torch.from_numpy(h), torch.from_numpy(e),
                              Projections(torch.from_numpy(r_h),
                                          torch.from_numpy(r_v))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _omp_case(seed, n=6, D=20):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(n, D)).astype(np.float32)
    t = (G[0] * 3 + 0.1 * G[1]).astype(np.float32)
    return G @ G.T, G @ t, np.float32(t @ t)


@pytest.mark.parametrize("solver", ["chol", "dense"])
@pytest.mark.parametrize("eps", [1e-10, 4.5])
def test_gram_omp_matches_reference(solver, eps):
    """Unit 0 is picked first: while slots remain its weight reads 0 in
    the reference (inactive slots alias unit 0), which steers the later
    picks and, with an early stop (eps 4.5), the final weights."""
    K, c, tsq = _omp_case(0)
    want = jax_gm.gram_omp(jnp.asarray(K), jnp.asarray(c), jnp.asarray(tsq),
                           4, 0.5, eps, True, solver)
    got = gm.gram_omp(torch.from_numpy(K), torch.from_numpy(c),
                      torch.tensor(tsq), 4, 0.5, eps, True, solver)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               atol=1e-4)
    assert got.n_selected == int(want.n_selected)
    np.testing.assert_allclose(float(got.error), float(want.error),
                               rtol=1e-4)


@pytest.mark.parametrize("val_matching", [False, True])
@pytest.mark.parametrize("solver", ["chol", "dense"])
def test_partitioned_gm_matches_reference(val_matching, solver):
    rng = np.random.default_rng(7)
    g = rng.normal(size=(24, 64)).astype(np.float32)
    gv = rng.normal(size=(64,)).astype(np.float32) if val_matching else None
    want = jax_pgm.partitioned_gm(
        jnp.asarray(g), 3, 3, 0.5, 1e-10, True, val_matching,
        None if gv is None else jnp.asarray(gv), kernel_impl="pallas",
        solver=solver)
    got = pgm.partitioned_gm(
        torch.from_numpy(g), 3, 3, 0.5, 1e-10, True, val_matching,
        None if gv is None else torch.from_numpy(gv), solver=solver)
    # the Gram oracle the stage-B kernel is held to
    np.testing.assert_allclose(gm.gram(torch.from_numpy(g[:8])).numpy(),
                               np.asarray(jax_gm.gram(jnp.asarray(g[:8]))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               atol=1e-4)
    assert got.n_selected == int(want.n_selected)


def test_pgm_select_round_matches_reference(setup):
    mj, params, proj, units, val = setup
    pc = dict(subset_fraction=0.5, n_partitions=3, sketch_dim_h=8,
              sketch_dim_v=8, val_matching=True)
    want = jax_pgm.pgm_select(
        mj, params, jax.tree.map(jnp.asarray, units),
        dataclasses.replace(JaxPGMConfig(**pc), kernel_impl="pallas"), proj,
        val_units=jax.tree.map(jnp.asarray, val))
    got = pgm.pgm_select(build_model(get_config(ARCH)), from_numpy(params),
                         _to_torch(units), PGMConfig(**pc),
                         Projections(*(torch.from_numpy(np.array(x))
                                       for x in proj)),
                         val_units=_to_torch(val))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               atol=1e-4)
