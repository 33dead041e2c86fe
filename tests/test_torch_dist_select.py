"""PyTorch port, sharded stage B (``repro_torch/core/pgm.py:
pgm_select_sharded``, the ``_stage_b`` dispatch, ``ResidentSelector(
mesh=...)``) on 2 and 4 gloo ranks against the JAX reference's
``pgm_select_sharded`` on 4 host devices and against the port's
one-device stage B, on the CPU.

The reference runs once for the file, in one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``: its ``_stage_b``
on a (4,) data mesh and on a (2, 2) data x model mesh (data size 2), on
the same stage-A vectors.  The port's ranks each hold their block of
units (ROADMAP hazard D4).  Bars, the reference test's: indices equal
(in order), weights within 1e-4, the same ``n_selected``.  Cases: 8 and
4 partitions of 32 units (the second with validation matching), and
partition counts the data axis does not divide (3 of 30 units at both
sizes; 6 of 30 at 4 ranks), where the reference and the port fall back
to one-device stage B on every rank.  A resident round at 2 ranks on
``rnnt-crdnn-smoke`` (validation matching) and ``starcoder2-3b-smoke``
picks the one-device round's units and weights.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

from repro.data.pipeline import asr_units, lm_units  # noqa: E402
from repro.data.synthetic import make_asr_corpus, make_lm_corpus  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import PGMConfig  # noqa: E402
from repro_torch.core.lastlayer import make_proj_for  # noqa: E402
from repro_torch.core.pgm import ResidentSelector, _stage_b  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from torch_dist_helpers import spawn  # noqa: E402
from torch_dist_ranks import resident_rounds, stage_b_cases  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _cases():
    rng = np.random.default_rng(0)
    g32 = rng.normal(size=(32, 16)).astype(np.float32)
    g30 = rng.normal(size=(30, 16)).astype(np.float32)
    g_val = rng.normal(size=(16,)).astype(np.float32)
    return [
        (g32, None, dict(subset_fraction=0.25, n_partitions=8)),
        (g32, g_val, dict(subset_fraction=0.5, n_partitions=4,
                          val_matching=True)),
        (g30, None, dict(subset_fraction=0.4, n_partitions=3)),
        (g30, None, dict(subset_fraction=0.4, n_partitions=6)),
    ]


_REF = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs.base import PGMConfig
from repro.core.pgm import _stage_b
assert jax.device_count() == 4
inp = np.load(sys.argv[1], allow_pickle=True)
cases = inp["cases"]
meshes = {4: jax.make_mesh((4,), ("data",)),
          2: jax.make_mesh((2, 2), ("data", "model"))}
out = {}
for i, (g, g_val, kw) in enumerate(cases):
    for size, mesh in meshes.items():
        sel = _stage_b(jnp.asarray(g), PGMConfig(**kw),
                       g_val=None if g_val is None else jnp.asarray(g_val),
                       mesh=mesh)
        for name in ("indices", "weights", "n_selected", "errors"):
            out[f"{i}_{size}_{name}"] = np.asarray(getattr(sel, name))
np.savez(sys.argv[2], **out)
print("REF-OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's stage B of every case on 4 host devices, at data
    sizes 4 and 2 (one subprocess for the file)."""
    d = tmp_path_factory.mktemp("ref_stage_b")
    cases = np.empty(len(_cases()), dtype=object)
    cases[:] = _cases()
    np.savez(d / "in.npz", cases=cases)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF),
                        str(d / "in.npz"), str(d / "out.npz")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode == 0 and "REF-OK" in p.stdout, p.stderr[-3000:]
    with np.load(d / "out.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_stage_b_matches_reference(reference, tmp_path, world):
    cases = _cases()
    got = spawn(stage_b_cases, world, tmp_path, cases)
    for i, (g, g_val, kw) in enumerate(cases):
        one = _stage_b(torch.from_numpy(g), PGMConfig(**kw),
                       g_val=None if g_val is None
                       else torch.from_numpy(g_val))
        n_parts = kw["n_partitions"]
        # D4: sharded exactly when the partitions and units divide
        assert got[0][i][4] == (n_parts % world == 0
                                and g.shape[0] % world == 0), (i, world)
        for rank in range(world):
            idx, w, n_sel, errs, _ = got[rank][i]
            want = {k: reference[f"{i}_{world}_{k}"]
                    for k in ("indices", "weights", "n_selected", "errors")}
            np.testing.assert_array_equal(idx, want["indices"])
            np.testing.assert_allclose(w, want["weights"], rtol=0, atol=1e-4)
            assert n_sel == int(want["n_selected"])
            assert errs.shape == want["errors"].shape == (n_parts,)
            np.testing.assert_array_equal(idx, one.indices.numpy())
            np.testing.assert_allclose(w, one.weights.numpy(), rtol=0,
                                       atol=1e-4)
            assert n_sel == one.n_selected


def _resident_case(arch, val_matching):
    cfg = get_config(arch)
    if cfg.family == "rnnt":
        r = cfg.rnnt
        units = asr_units(make_asr_corpus(3, 16, n_feats=r.n_feats,
                                          vocab_size=r.vocab_size,
                                          noise_fraction=0.25), 4)
        val = asr_units(make_asr_corpus(6, 8, n_feats=r.n_feats,
                                        vocab_size=r.vocab_size), 4)
    else:
        units = lm_units(make_lm_corpus(3, 8, 12, cfg.vocab_size), 2)
        val = lm_units(make_lm_corpus(6, 4, 12, cfg.vocab_size), 2)
    bundle = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = bundle.init_params(gen, torch.device("cpu"))
    proj = make_proj_for(bundle, gen, 16, 16, torch.device("cpu"))
    pc = dict(subset_fraction=0.5, n_partitions=2, sketch_dim_h=16,
              sketch_dim_v=16, val_matching=val_matching)
    return (arch, units, val if val_matching else None,
            tree_map(lambda t: t.numpy(), params),
            [x.numpy() for x in proj], pc)


def test_resident_round_at_two_ranks_matches_one_device(tmp_path):
    cases = [_resident_case("rnnt-crdnn-smoke", True),
             _resident_case("starcoder2-3b-smoke", False)]
    got = spawn(resident_rounds, 2, tmp_path, cases)
    for i, (arch, units, val, params, proj, pc) in enumerate(cases):
        from repro_torch.core.sketch import Projections
        t = lambda tree: tree_map(lambda a: torch.from_numpy(
            np.array(a, copy=True)), tree)
        want = ResidentSelector(
            build_model(get_config(arch)), PGMConfig(**pc),
            Projections(*(torch.from_numpy(x) for x in proj)),
            on_failure="raise")(t(params), t(units),
                                val_units=None if val is None else t(val))
        for rank in range(2):
            idx, w, n_sel = got[rank][i]
            np.testing.assert_array_equal(idx, want.indices.numpy())
            np.testing.assert_allclose(w, want.weights.numpy(), rtol=0,
                                       atol=1e-4)
            assert n_sel == want.n_selected
