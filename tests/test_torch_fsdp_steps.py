"""PyTorch port, sharded storage on gloo ranks (``repro_torch/sharding/
fsdp.py``, ``train/engine.py:MeshContext``, ``train/compress.py``,
``train/checkpoint.py`` through the engine), on the CPU.

On a (2,) data mesh (one spawn for the file's 2-rank cases):

- steps: three rows of epoch 0 on the host and the scan engines for
  ``rnnt-crdnn-smoke`` (AdamW), ``starcoder2-3b-smoke`` (remat, the
  tied embedding gathered by two units) and ``rwkv6-3b-smoke``, the clip
  at 1e6 so it does not bind: every row's loss and every params and
  optimizer leaf after them bitwise one device that takes each row in
  two halves and sums their gradients (``torch_fsdp_ranks.
  halves_steps``); each rank's stored blocks are its blocks of the whole
  state under the specs, a leaf whose dims the axis does not divide
  whole (hazard S5);
- stage A on the engine's shards (gathered unit by unit) bitwise one
  device's, RNN-T and LM;
- a checkpoint written on the mesh: its files bitwise a one-device save
  of the same state;
- top-k of the whole leaf from its blocks, ties across a block boundary.

On 4 ranks (one spawn): on a (4,) data mesh the checkpoint restored
bitwise (and on one device), top-k again, and two full-data epochs of
``starcoder2-3b-smoke`` through ``train_with_selection`` within 1e-3 of
the reference's sharded epochs on 4 JAX host devices (its own bar for a
sharded run; the reference's mesh built with ``Auto`` axes); on a 2 x 2
data x model mesh, whose model ranks compute the same examples, the
steps bitwise the data = 2 halves control.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import lm_units  # noqa: E402
from repro.data.synthetic import make_lm_corpus  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.lastlayer import units_gradients_batched  # noqa: E402
from repro_torch.core.sketch import Projections  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.common import flatten_with_path, tree_leaves  # noqa: E402
from repro_torch.sharding.specs import SpecBuilder, shard  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.compress import topk_compress  # noqa: E402
from torch_dist_helpers import spawn  # noqa: E402
from torch_dist_ranks import t_tree  # noqa: E402
from torch_engine_helpers import _reference_draws, _setup  # noqa: E402
from torch_fsdp_ranks import (four_rank_body, halves_steps,  # noqa: E402
                              two_rank_body)

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ("rnnt-crdnn-smoke", "starcoder2-3b-smoke", "rwkv6-3b-smoke")
ROWS = 3
CKPT_ARCH = "starcoder2-3b-smoke"


def _run(arch):
    units, _, run, _ = _setup(arch)
    return units, dict(run, grad_clip=1e6)


def _topk_inputs():
    """Leaves with ties straddling the blocks' boundaries: rows split
    over ``data`` (spec ``("data", None)``) and columns (``(None,
    "data")``, blocks interleaved in the flat order)."""
    rng = np.random.default_rng(3)
    out = []
    for spec, n_tied in ((("data", None), 1), ((None, "data"), 6)):
        g = rng.standard_normal((8, 12)).astype(np.float32)
        g[2:6, 4:8] = 0.75            # 16 ties across the boundaries
        e = (0.5 * rng.standard_normal((8, 12))).astype(np.float32)
        e[2:6, 4:8] = 0.0
        if n_tied == 1:               # the first tie in C order: (0, 0)
            g[0, 0], e[0, 0] = -0.75, 0.0
        # k: every entry above 0.75 and the first n_tied tied ones
        n_above = int((np.abs(g + e) > 0.75).sum())
        out.append((g, e, spec, (n_above + n_tied) / g.size + 1e-6))
    tie_free = rng.permutation(96).astype(np.float32).reshape(8, 12) - 48
    out.append((tie_free, np.zeros_like(tie_free), ("data", None), 0.25))
    return out


def _whole_topk(cases):
    out = []
    for g, e, spec, k_frac in cases:
        s, n = topk_compress({"g": torch.from_numpy(g)},
                             {"g": torch.from_numpy(e)}, k_frac)
        out.append((s["g"].numpy(), n["g"].numpy()))
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("fsdp2")
    steps, ctrl, a_cases = [], {}, []
    for arch in ARCHS:
        units, run = _run(arch)
        _, params, proj = _reference_draws(arch)
        steps += [(arch, eng, run, units, params, ROWS)
                  for eng in ("host", "scan")]
        ctrl[arch] = halves_steps(arch, run, units, params, ROWS)
        if arch != "rwkv6-3b-smoke":
            a_cases.append((arch, units, params, proj))
    units, run = _run(CKPT_ARCH)
    _, params, _ = _reference_draws(CKPT_ARCH)
    ck = str(root / "ckpt")
    got = spawn(two_rank_body, 2, root, steps, a_cases,
                (CKPT_ARCH, run, units, params, 2, ck), _topk_inputs())
    return steps, ctrl, a_cases, got, ck


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(la, lb))


def _blocks_are_the_specs(stored, whole_p, whole_o, coord, sizes):
    """Each stored block is the coordinate's block of the whole leaf under
    the leaf's spec -> (leaves cut, leaves of 2+ dims kept whole)."""
    spec = SpecBuilder(sizes, mode="tp")
    whole = {("params" + k): v for k, v in flatten_with_path(whole_p)}
    whole.update({("opt" + k): v for k, v in flatten_with_path(whole_o)})
    cut = kept = 0
    for key, blk in stored.items():
        leaf = whole[key]
        path = key[key.index("["):]
        s = spec.param_spec(path, leaf.shape)
        assert np.array_equal(blk, shard(leaf, s, sizes, coord)), key
        cut += blk.size < leaf.size
        kept += blk.size == leaf.size and leaf.ndim >= 2
    return cut, kept


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("engine", ["host", "scan"])
def test_two_rank_steps_are_one_device_summing_halves(two_ranks, arch,
                                                      engine):
    steps, ctrl, _, got, _ = two_ranks
    i = next(i for i, s in enumerate(steps) if s[:2] == (arch, engine))
    losses, params, opt = ctrl[arch]
    for r in range(2):
        l, p, o, stored, coord = got[r][0][i]
        assert l == losses, (r, l, losses)
        assert _same(p, params) and _same(o, opt), r
        cut, kept = _blocks_are_the_specs(stored, p, o, coord,
                                          {"data": 2})
        assert cut > 0
        if arch == "rnnt-crdnn-smoke":      # conv0's (3, 3, 1, 8): S5
            assert kept > 0


@pytest.mark.parametrize("case", [0, 1])
def test_stage_a_on_shards_is_one_device(two_ranks, case):
    _, _, a_cases, got, _ = two_ranks
    arch, units, params, proj = a_cases[case]
    bundle = build_model(get_config(arch))
    with torch.no_grad():
        want = units_gradients_batched(
            bundle, t_tree(params),
            {k: torch.from_numpy(np.asarray(v)) for k, v in units.items()},
            Projections(*(torch.from_numpy(np.array(x, copy=True))
                          for x in proj))).numpy()
    for r in range(2):
        assert np.array_equal(got[r][1][case], want), (arch, r)


def test_checkpoint_files_are_a_one_device_save(two_ranks, tmp_path):
    _, _, _, got, ck = two_ranks
    state = got[0][2]
    assert _same(state, got[1][2])
    ckpt.save(str(tmp_path), 1, state)
    mine = ckpt.read_manifest(ck)
    one = ckpt.read_manifest(str(tmp_path))
    assert mine["arrays"] == one["arrays"]
    assert mine["mesh_shape"] == {"data": 2}


def test_topk_of_blocks_is_the_whole_leafs(two_ranks):
    cases = _topk_inputs()
    want = _whole_topk(cases)
    for (g, e, spec, k_frac), (ws, wn) in zip(cases, want):
        k = max(int(g.size * k_frac), 1)
        assert int((ws != 0).sum()) == k
        assert np.array_equal(ws + wn, g + e)
    # ties to the lower index, as JAX's top_k: (0, 0) first; without it
    # (2, 4..7) and (3, 4..5), which straddle the column blocks
    assert want[0][0][0, 0] != 0 and (want[0][0][2:6, 4:8] != 0).sum() == 0
    picked = np.argwhere(want[1][0][2:6, 4:8] != 0).tolist()
    assert picked == [[0, 0], [0, 1], [0, 2], [0, 3], [1, 0], [1, 1]]

    for r in range(2):
        for (gs, gn), (ws, wn) in zip(two_ranks[3][r][3], want):
            assert np.array_equal(gs, ws) and np.array_equal(gn, wn)


def test_topk_matches_jax_on_tie_free_data():
    g, e, _, k_frac = _topk_inputs()[2]
    flat = (g + e).reshape(-1)
    k = max(int(flat.size * k_frac), 1)
    _, idx = jax.lax.top_k(np.abs(flat), k)
    want = np.zeros_like(flat)
    want[np.asarray(idx)] = flat[np.asarray(idx)]
    sent = _whole_topk([(g, e, None, k_frac)])[0][0]
    assert np.array_equal(sent.reshape(-1), want)


_SHARDED_REF = """
import sys
import numpy as np, jax
from jax.sharding import AxisType
from repro.configs import get_config
from repro.configs.base import PGMConfig, TrainConfig
from repro.models.api import build_model
from repro.train.loop import train_with_selection
assert jax.device_count() == 4
inp = np.load(sys.argv[1], allow_pickle=True)
units, val = inp["units"].item(), inp["val"].item()
mesh = jax.make_mesh((4,), ("data",), axis_types=(AxisType.Auto,))
tc = TrainConfig(lr=0.5, optimizer="sgd", epochs=2, pgm=PGMConfig())
h = train_with_selection(build_model(get_config("starcoder2-3b-smoke")),
                         units, tc, method="full", val_units=val,
                         engine="scan", mesh=mesh)
np.savez(sys.argv[2], train=np.asarray(h.train_loss),
         val=np.asarray(h.val_loss))
print("SHARDED-REF-OK")
"""


def _four_units():
    cfg = jax_get_config("starcoder2-3b-smoke")
    units = lm_units(make_lm_corpus(0, 16, 12, cfg.vocab_size,
                                    hard_fraction=0.4), 4)
    val = lm_units(make_lm_corpus(7, 8, 12, cfg.vocab_size), 4)
    return units, val


def test_four_ranks_restore_topk_and_reference_epochs(two_ranks, tmp_path):
    _, _, _, got2, ck = two_ranks
    units, val = _four_units()
    np.savez(tmp_path / "in.npz", units=np.array(units, dtype=object),
             val=np.array(val, dtype=object))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_SHARDED_REF),
         str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    _, params, proj = _reference_draws("starcoder2-3b-smoke")
    runs = [("starcoder2-3b-smoke", "scan", units, val,
             dict(lr=0.5, optimizer="sgd", epochs=2), {}, params, proj,
             {"method": "full"})]
    c_units, c_run = _run(CKPT_ARCH)
    got = spawn(four_rank_body, 4, tmp_path, runs,
                (CKPT_ARCH, c_run, c_units, params, ck), _topk_inputs(),
                [(CKPT_ARCH, "host", c_run, c_units, params, ROWS)])
    out, err = ref.communicate(timeout=400)
    assert ref.returncode == 0 and "SHARDED-REF-OK" in out, err[-3000:]
    with np.load(tmp_path / "out.npz") as z:
        want_train, want_val = z["train"], z["val"]
    saved = got2[0][2]
    one, _ = ckpt.restore(ck)
    for r in range(4):
        hist = got[r][0][0]
        assert hist == got[0][0][0]
        np.testing.assert_allclose(hist["train_loss"], want_train,
                                   rtol=1e-3, atol=0)
        np.testing.assert_allclose(hist["val_loss"], want_val, rtol=1e-3,
                                   atol=0)
        whole, stored, coord = got[r][1]
        assert _same(whole, saved)
        spec = SpecBuilder({"data": 4}, mode="tp")
        cut = 0
        for key, blk in stored.items():
            leaf = one[key]
            s = spec.param_spec(key, leaf.shape)
            assert np.array_equal(blk, shard(leaf, s, {"data": 4}, coord))
            cut += blk.size < leaf.size
        assert cut > 0
        for (gs, gn), (ws, wn) in zip(got[r][2],
                                      _whole_topk(_topk_inputs())):
            assert np.array_equal(gs, ws) and np.array_equal(gn, wn)
    # a 2 x 2 data x model mesh: the model ranks compute the same examples,
    # each sends only its own block's share; bitwise the data = 2 halves
    losses, p_want, o_want = two_ranks[1][CKPT_ARCH]
    for r in range(4):
        l, p, o, stored, coord = got[r][3][0]
        assert l == losses and _same(p, p_want) and _same(o, o_want), r
        cut, _ = _blocks_are_the_specs(stored, p, o, coord,
                                       {"data": 2, "model": 2})
        assert cut > 0
    # and on one device: the files' arrays are the whole state

    assert _same({k: one[k] for k, _ in flatten_with_path(saved)},
                 {k: v for k, v in flatten_with_path(saved)})
