"""PyTorch port, a short PGM history through the band on the CPU:
``starcoder2-3b-smoke`` (window 16) trained on units of one example of
2,048 tokens,
past the band's start, by ``train_with_selection`` on the host engine and
on the scan engine with resident rounds (on the CPU the scan engine runs
its step without a graph), from the reference's initial params and
projections, against the reference's ``train_with_selection`` on its host
engine (``jax.grad`` of its XLA band, remat on): the same subsets, the
weights within 1e-3, the losses within rtol 1e-3.  The port remats each
layer group and differentiates the band through its plain backward.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import PGMConfig as JaxPGMConfig  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.core import lastlayer as jax_ll  # noqa: E402
from repro.data.pipeline import lm_units  # noqa: E402
from repro.data.synthetic import make_lm_corpus  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.train.loop import train_with_selection as jax_train  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import PGMConfig, TrainConfig  # noqa: E402
from repro_torch.kernels.backend import fp32_numerics  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.train.loop import train_with_selection  # noqa: E402

ARCH = "starcoder2-3b-smoke"
SEQ = 2048
K = 16                       # sketch dims k1 = k2
RUN = dict(lr=0.3, optimizer="sgd", epochs=3)
SEL = dict(subset_fraction=0.5, n_partitions=2, select_every=1,
           warm_start_epochs=1, sketch_dim_h=K, sketch_dim_v=K,
           val_matching=True)


@pytest.fixture(scope="module")
def reference_history():
    """The reference's PGM run (host engine) on 4 training and 2
    validation units of one 2,048-token example, its initial params and
    projections."""
    fp32_numerics()
    cfg = jax_get_config(ARCH)
    assert SEQ > cfg.window + 1024
    mj = jax_build(cfg)
    units = lm_units(make_lm_corpus(0, 4, SEQ, cfg.vocab_size,
                                    noise_fraction=0.25), 1)
    val = lm_units(make_lm_corpus(7, 2, SEQ, cfg.vocab_size), 1)
    h = jax_train(mj, units, JaxTrainConfig(**RUN, pgm=JaxPGMConfig(**SEL)),
                  method="pgm", val_units=val, engine="host")
    key = jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, mj.init_params(key))
    proj = [np.asarray(x) for x in jax_ll.make_proj_for(
        mj, jax.random.fold_in(key, 17), K, K)]
    return h, units, val, params, proj


@pytest.mark.parametrize("engine,resident", [("host", False),
                                             ("scan", True)])
def test_history_through_the_band_matches_reference(reference_history,
                                                     engine, resident):
    h_j, units, val, params, proj = reference_history
    h_t = train_with_selection(
        build_model(get_config(ARCH)), units,
        TrainConfig(**RUN, pgm=PGMConfig(**SEL)), method="pgm",
        val_units=val, engine=engine, resident_selection=resident,
        device="cpu", params=params, proj=proj)
    assert len(h_t.selections) == len(h_j.selections) == 2
    for st, sj in zip(h_t.selections, h_j.selections):
        assert st["epoch"] == sj["epoch"]
        assert st["indices"] == sj["indices"], (st, sj)
        np.testing.assert_allclose(st["weights"], sj["weights"], atol=1e-3)
    np.testing.assert_allclose(h_t.train_loss, h_j.train_loss, rtol=1e-3)
    np.testing.assert_allclose(h_t.val_loss, h_j.val_loss, rtol=1e-3)
    assert h_t.cost_units == pytest.approx(h_j.cost_units)
