"""PyTorch port, resident selection rounds (``repro_torch/core/lastlayer.py:
units_gradients_batched`` / ``units_gradients_scanned``,
``repro_torch/core/pgm.py:ResidentSelector``, ``train/faults.py:
failing_selection_kernels``, ``train_with_selection(resident_selection=
True)`` and the launcher's ``--resident-selection``) against the JAX
reference on the CPU, where the port runs its plain versions without a
graph and the reference its ``xla`` path, as its own tests run it
(``tests/test_resident_selection.py``):

- the batched stage A of ``starcoder2-3b-smoke``, ``rnnt-crdnn-smoke``
  and ``rwkv6-3b-smoke`` (seq 128: the chunked WKV branch, R7) at
  ``chunk_units`` 1, 2 and U, within atol 1e-5 x max(scale, 1) of the
  reference's (its own bar);
- each unit's vector in a chunk of 2 equal to that unit alone (the LM
  scale divides by the unit's example count, not the chunk's: P1); a
  given (V, d) copy of the untied RWKV head read as the call's own
  (P4);
- ``ResidentSelector`` against the reference's, sketched and exact: the
  same indices, weights within 1e-4; and against the port's own
  ``pgm_select``;
- ``train_with_selection(resident_selection=True, engine="scan")``
  against the reference's on the LM and RNN-T smoke configs: the same
  subsets, losses within rtol 1e-3, equal ``cost_units``;
- the CPU failure ladder: an injected failure of the plain route
  degrades the round to a soft-random subset (the budget, distinct
  units, unit weights; H4: held by invariants), ``on_failure="raise"``
  re-raises, and a failure of the ``"cuda"`` route does not fire on the
  CPU; the launcher's flag.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import PGMConfig as JaxPGMConfig  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.core import lastlayer as jax_lastlayer  # noqa: E402
from repro.core import pgm as jax_pgm  # noqa: E402
from repro.core.lastlayer import make_proj_for as jax_make_proj  # noqa: E402
from repro.data.pipeline import asr_units, lm_units  # noqa: E402
from repro.data.synthetic import make_asr_corpus, make_lm_corpus  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.train.loop import train_with_selection as jax_train  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import PGMConfig, TrainConfig  # noqa: E402
from repro_torch.convert import from_numpy  # noqa: E402
from repro_torch.core import lastlayer, pgm  # noqa: E402
from repro_torch.core.sketch import Projections  # noqa: E402
from repro_torch.kernels.backend import fp32_numerics  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.train import faults  # noqa: E402
from repro_torch.train.loop import train_with_selection  # noqa: E402

LM, RNNT, RWKV = "starcoder2-3b-smoke", "rnnt-crdnn-smoke", "rwkv6-3b-smoke"
N_UNITS = 4
K = 16                       # sketch dims k1 = k2


def _units(arch, seed, n_units, noise=0.0):
    """``n_units`` units from the family's corpus (numpy, from ``seed``):
    RNN-T units of 4 utterances, LM units of 2 rows of 12 tokens (RWKV:
    128, two WKV chunks)."""
    cfg = jax_get_config(arch)
    if cfg.family == "rnnt":
        r = cfg.rnnt
        return asr_units(make_asr_corpus(seed, 4 * n_units, n_feats=r.n_feats,
                                         vocab_size=r.vocab_size,
                                         noise_fraction=noise), 4)
    seq = 128 if arch == RWKV else 12
    return lm_units(make_lm_corpus(seed, 2 * n_units, seq, cfg.vocab_size,
                                   noise_fraction=noise), 2)


def _draws(arch, seed=0):
    """The reference's params and projections as numpy, and its bundle."""
    mj = jax_build(jax_get_config(arch))
    params = jax.tree.map(np.asarray, mj.init_params(jax.random.PRNGKey(seed)))
    proj = [np.asarray(x) for x in jax_make_proj(
        mj, jax.random.PRNGKey(seed + 1), K, K)]
    return mj, params, proj


def _port(arch, params, proj, units):
    return (build_model(get_config(arch)), from_numpy(params),
            Projections(*(torch.from_numpy(np.array(x)) for x in proj)),
            {k: torch.from_numpy(np.array(v)) for k, v in units.items()})


@pytest.fixture(scope="module", params=[LM, RNNT, RWKV])
def family(request):
    fp32_numerics()
    arch = request.param
    mj, params, proj = _draws(arch)
    return arch, mj, params, proj, _units(arch, 3, N_UNITS)


@pytest.mark.parametrize("cu", [1, 2, N_UNITS])
def test_units_gradients_batched_matches_reference(family, cu):
    arch, mj, params, proj, units = family
    want = np.asarray(jax_lastlayer.units_gradients_batched(
        mj, params, jax.tree.map(jnp.asarray, units),
        jax_pgm.Projections(*map(jnp.asarray, proj)), chunk_units=cu,
        kernel_impl="xla"))
    bundle, p, pr, u = _port(arch, params, proj, units)
    got = lastlayer.units_gradients_batched(bundle, p, u, pr,
                                            chunk_units=cu).numpy()
    assert got.shape == want.shape == (N_UNITS, K * K)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(scale, 1.0))


def test_chunked_unit_equals_the_unit_alone(family):
    """P1: a unit's vector inside a chunk of 2 is the vector it has
    alone (``units_gradients_batched`` on a corpus of that one unit)."""
    arch, _, params, proj, units = family
    bundle, p, pr, u = _port(arch, params, proj, units)
    both = lastlayer.units_gradients_batched(bundle, p, u, pr, chunk_units=2)
    for i in range(2):
        alone = lastlayer.units_gradients_batched(
            bundle, p, {k: v[i:i + 1] for k, v in u.items()}, pr)
        np.testing.assert_allclose(both[i].numpy(), alone[0].numpy(),
                                   rtol=0,
                                   atol=1e-6 * float(alone.abs().max()))


def test_batched_reads_a_given_head_copy():
    """P4: ``head_rows``, the selector's once-a-pass (V, d) copy of an
    untied head, gives the vectors the call's own copy gives
    (``rwkv6-3b-smoke``, untied head, seq 128)."""
    fp32_numerics()
    _, params, proj = _draws(RWKV)
    bundle, p, pr, u = _port(RWKV, params, proj, _units(RWKV, 3, N_UNITS))
    head = bundle.head_weight(p)
    assert not head.t().is_contiguous()
    want = lastlayer.units_gradients_batched(bundle, p, u, pr, chunk_units=2)
    got = lastlayer.units_gradients_batched(
        bundle, p, u, pr, chunk_units=2, head_rows=head.t().contiguous())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("arch,exact,val_matching", [
    (LM, False, False), (LM, True, True), (RNNT, False, True)])
def test_resident_selector_matches_reference(arch, exact, val_matching):
    """The same indices and weights within 1e-4 as the reference's
    ``ResidentSelector`` and as the port's own ``pgm_select``."""
    fp32_numerics()
    mj, params, proj = _draws(arch)
    units, val = _units(arch, 5, 8, noise=0.25), _units(arch, 6, 4)
    pc = dict(subset_fraction=0.5, n_partitions=2, sketch_dim_h=K,
              sketch_dim_v=K, use_sketch=not exact,
              val_matching=val_matching)
    jproj = None if exact else jax_pgm.Projections(*map(jnp.asarray, proj))
    want = jax_pgm.ResidentSelector(
        mj, JaxPGMConfig(**pc, kernel_impl="xla"), jproj)(
        params, jax.tree.map(jnp.asarray, units),
        val_units=jax.tree.map(jnp.asarray, val))
    bundle, p, pr, u = _port(arch, params, proj, units)
    v = {k: torch.from_numpy(np.array(x)) for k, x in val.items()}
    pr = None if exact else pr
    selector = pgm.ResidentSelector(bundle, PGMConfig(**pc), pr)
    got = selector(p, u, val_units=v)
    host = pgm.pgm_select(bundle, p, u, PGMConfig(**pc), pr, val_units=v)
    for sel in (got, host):
        np.testing.assert_array_equal(sel.indices.numpy(),
                                      np.asarray(want.indices))
        np.testing.assert_allclose(sel.weights.numpy(),
                                   np.asarray(want.weights), atol=1e-4)
        assert sel.n_selected == int(want.n_selected)
    assert selector.degraded_rounds == 0
    assert pgm.ResidentSelector.captures == 0      # no graph on the CPU


@pytest.mark.parametrize("arch", [LM, RNNT])
def test_train_with_resident_selection_matches_reference(arch):
    """``tests/test_resident_selection.py::test_train_with_resident_
    selection_matches_host_selection`` across the packages: the same
    subsets, losses within rtol 1e-3, equal ``cost_units``."""
    fp32_numerics()
    units, val = _units(arch, 0, 8, noise=0.25), _units(arch, 7, 4)
    if arch == RNNT:
        run = dict(lr=0.05, optimizer="adamw", epochs=3)
    else:
        run = dict(lr=0.5, optimizer="sgd", epochs=3)
    sel = dict(subset_fraction=0.5, n_partitions=2, select_every=1,
               warm_start_epochs=1, sketch_dim_h=K, sketch_dim_v=K,
               val_matching=True)
    mj = jax_build(jax_get_config(arch))
    h_j = jax_train(mj, units, JaxTrainConfig(**run, pgm=JaxPGMConfig(**sel)),
                    method="pgm", val_units=val, engine="scan",
                    resident_selection=True)
    key = jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, mj.init_params(key))
    proj = [np.asarray(x) for x in jax_make_proj(
        mj, jax.random.fold_in(key, 17), K, K)]
    h_t = train_with_selection(
        build_model(get_config(arch)), units,
        TrainConfig(**run, pgm=PGMConfig(**sel)), method="pgm",
        val_units=val, engine="scan", resident_selection=True,
        device="cpu", params=params, proj=proj)
    assert len(h_t.selections) == len(h_j.selections) == 2
    for st, sj in zip(h_t.selections, h_j.selections):
        assert st["epoch"] == sj["epoch"]
        assert st["indices"] == sj["indices"], (st, sj)
        np.testing.assert_allclose(st["weights"], sj["weights"], atol=1e-3)
    np.testing.assert_allclose(h_t.train_loss, h_j.train_loss, rtol=1e-3)
    np.testing.assert_allclose(h_t.val_loss, h_j.val_loss, rtol=1e-3)
    assert h_t.cost_units == pytest.approx(h_j.cost_units)


def _ladder_setup():
    _, params, proj = _draws(LM)
    bundle, p, pr, u = _port(LM, params, proj, _units(LM, 5, 8))
    return bundle, p, pr, u, PGMConfig(subset_fraction=0.5, n_partitions=2,
                                       sketch_dim_h=K, sketch_dim_v=K)


@pytest.mark.parametrize("routes", [("all",), ("plain",)])
def test_failed_plain_round_degrades_to_soft_random(routes):
    """The plain route's ladder: a failed round becomes a uniform subset
    of the budget with unit weights, once a failed round."""
    bundle, p, pr, u, pc = _ladder_setup()
    logs = []
    selector = pgm.ResidentSelector(bundle, pc, pr, log_fn=logs.append)
    with faults.failing_selection_kernels(routes):
        sel = selector(p, u)
    idx = sel.indices.tolist()
    assert selector.degraded_rounds == 1
    assert len(idx) == sel.n_selected == 4 and len(set(idx)) == 4
    assert all(0 <= i < 8 for i in idx)
    assert sel.weights.tolist() == [1.0] * 4
    assert any("soft-random" in line for line in logs)
    # the patch is gone: the next round scores
    assert selector(p, u).indices.tolist() == \
        pgm.pgm_select(bundle, p, u, pc, pr).indices.tolist()
    assert selector.degraded_rounds == 1


def test_failed_round_raises_when_asked_and_cuda_route_spares_cpu():
    bundle, p, pr, u, pc = _ladder_setup()
    selector = pgm.ResidentSelector(bundle, pc, pr, on_failure="raise")
    with faults.failing_selection_kernels(("all",)):
        with pytest.raises(RuntimeError, match="injected kernel failure"):
            selector(p, u)
    assert selector.degraded_rounds == 0
    with faults.failing_selection_kernels(("cuda",)):
        sel = selector(p, u)
    assert sel.indices.tolist() == \
        pgm.pgm_select(bundle, p, u, pc, pr).indices.tolist()
    with pytest.raises(ValueError, match="mesh"):
        pgm.ResidentSelector(bundle, pc, pr, mesh=object())


def test_launcher_resident_selection_flag():
    """``--resident-selection`` reaches the loop and picks the subsets the
    host rounds pick, with the same epoch losses (1e-3)."""
    argv = ["--arch", LM, "--epochs", "3", "--n", "16", "--warm-start",
            "1", "--select-every", "1", "--partitions", "2", "--device",
            "cpu"]
    fp32_numerics()
    h_res = launcher.main(argv + ["--resident-selection"])
    h_host = launcher.main(argv)
    assert [s["indices"] for s in h_res.selections] == \
        [s["indices"] for s in h_host.selections]
    assert len(h_res.selections) == 2
    np.testing.assert_allclose(h_res.train_loss, h_host.train_loss,
                               rtol=1e-3)
    np.testing.assert_allclose(h_res.val_loss, h_host.val_loss, rtol=1e-3)
