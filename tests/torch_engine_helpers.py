"""Shared setup of the scan-engine parity tests
(``tests/test_torch_engine.py`` and ``tests/test_torch_engine_faults.py``):
the reference's runs of ``tests/test_train_engine.py``, its initial
draws, the history bar, and bitwise comparisons of the port's trees."""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.lastlayer import make_proj_for as jax_make_proj
from repro.data.pipeline import asr_units, lm_units
from repro.data.synthetic import make_asr_corpus, make_lm_corpus
from repro.models.api import build_model as jax_build
from repro_torch.models.common import tree_leaves, tree_map

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
