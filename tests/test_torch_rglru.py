"""PyTorch port, the RG-LRU hybrid (``recurrentgemma-9b``: pattern (rec,
rec, local), MQA over one KV head, GeGLU, tied and scaled embedding)
against the JAX reference on the CPU, on its ``-smoke`` reduction (6
layers, d 64, head dim 16, window 16, lru_width 64, vocab 277).  The
reference's params go through numpy (``convert.from_numpy``); inputs are
drawn with numpy from a seed.  The hazards RG1-RG4 are ROADMAP.md's.

- configs: every field, the layer kinds and ``n_params`` (the
  reference's formula, below the leaves' count);
- ``_causal_conv`` (RG1: the taps in reverse order, the state of the last
  cw - 1 inputs, and with ``lengths`` the inputs that end at each row's
  length, what an unpadded conv of the live prefix leaves);
- ``rglru_forward`` with and without a carried state, at S 1 (a decode
  step), 24 and 37, and its gradients against ``jax.grad``: fp32 (TF32
  off), out and state 1e-5, each gradient 1e-4 of its largest entry;
  the log-depth scan against the reference's ``_rg_lru`` at S 2,048;
- RG2-RG4 at bf16: ``cast_block_params`` rounds every ``rec`` leaf
  (``lam``, ``ba``, ``bx``, ``conv_b`` included) bitwise as the reference
  does, and a bf16 block within ``tests/test_torch_dense_archs.py``'s
  bar;
- the whole ``recurrentgemma-9b-smoke`` loss and every gradient leaf
  against ``jax.grad`` of the reference's ``loss_fn``: fp32 loss 1e-5,
  gradients 1e-4 of each leaf's largest entry; bf16 loss rtol 2e-2, each
  leaf 2e-2 relative in norm, the reference compiled with
  ``xla_allow_excess_precision`` off (ROADMAP X2);
- per-unit stage-A vectors on both engines' paths (host
  ``units_gradients`` and the resident ``units_gradients_batched`` at
  ``chunk_units`` 1, 2 and U) against the reference's, a ``pgm_select``
  round and a ``ResidentSelector`` round (the same indices, weights
  1e-4), and a PGM history on the host engine and on the scan engine
  with resident rounds against the reference's (the same subsets,
  losses rtol 1e-3);
- the init: the reference's tree, shapes and scales; the serving weights
  bitwise ``serving_params`` of the masters.
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
from repro.core import lastlayer as jax_ll  # noqa: E402
from repro.core import pgm as jax_pgm  # noqa: E402
from repro.data.pipeline import lm_units  # noqa: E402
from repro.data.synthetic import make_lm_corpus  # noqa: E402
from repro.models import rglru as jax_rglru  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.models.transformer import cast_block_params as jax_cast  # noqa: E402
from repro.train.loop import train_with_selection as jax_train  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import PGMConfig, TrainConfig  # noqa: E402
from repro_torch.convert import from_numpy  # noqa: E402
from repro_torch.core import lastlayer as ll  # noqa: E402
from repro_torch.core import pgm  # noqa: E402
from repro_torch.core.sketch import Projections  # noqa: E402
from repro_torch.kernels.backend import fp32_numerics  # noqa: E402
from repro_torch.models import rglru  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.transformer import cast_block_params  # noqa: E402
from repro_torch.train.loop import train_with_selection  # noqa: E402

ARCH = "recurrentgemma-9b-smoke"
K = 16                       # sketch dims k1 = k2


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jax_get_config(ARCH), compute_dtype=dtype),
            dataclasses.replace(get_config(ARCH), compute_dtype=dtype))


def _units(seed, n, noise=0.0, seq=24, size=4):
    return lm_units(make_lm_corpus(seed, n, seq, 277, noise_fraction=noise),
                    size)


def _to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _at(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.fixture(scope="module")
def setup():
    """The reference's bundle, its init at key 3 as numpy, and one rec
    layer's params."""
    fp32_numerics()
    mj = jax_build(jax_get_config(ARCH))
    params = jax.tree.map(np.asarray, mj.init_params(jax.random.PRNGKey(3)))
    rec = jax.tree.map(lambda l: l[0], params["stack"]["groups"][0]["rec"])
    return mj, params, rec


# -- configs ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ["recurrentgemma-9b", ARCH])
def test_configs_match_reference(arch):
    cj, ct = jax_get_config(arch), get_config(arch)
    for f in dataclasses.fields(ct):
        assert getattr(ct, f.name) == getattr(cj, f.name), f.name
    assert ct.layer_kinds() == cj.layer_kinds()
    assert ct.n_params() == cj.n_params()
    if arch == "recurrentgemma-9b":
        assert ct.layer_kinds().count("rec") == 26
        assert ct.n_params() == 8_087_363_584


# -- the block --------------------------------------------------------------

@pytest.mark.parametrize("case", ["zeros", "state", "lengths"])
def test_causal_conv_taps_and_state(setup, case):
    """RG1: ``xp[:, i:i+S] * w[cw-1-i]`` summed (the taps reversed), the
    new state the last cw - 1 inputs; with lengths, those that end at
    each row's length (zeros before position 0), as an unpadded conv of
    each row's live prefix leaves them."""
    _, _, rec = setup
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 9, 64)).astype(np.float32)
    w, b = np.array(rec["conv_w"]), rng.normal(size=(64,)).astype(np.float32)
    state = (rng.normal(size=(3, 3, 64)).astype(np.float32)
             if case == "state" else None)
    out_j, st_j = jax_rglru._causal_conv(x, w, b, state)
    lens = torch.tensor([9, 2, 5]) if case == "lengths" else None
    out_t, st_t = rglru._causal_conv(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        None if state is None else torch.from_numpy(state), lens)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-6,
                               atol=1e-6)
    if case != "lengths":
        np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))
        return
    for r, n in enumerate(lens.tolist()):
        _, want = jax_rglru._causal_conv(x[r:r + 1, :n], w, b)
        np.testing.assert_array_equal(st_t[r:r + 1].numpy(),
                                      np.asarray(want))
    # the taps run in reverse order: w[j] takes the input j steps back,
    # so a unit impulse at t comes out as w[j] at t + j
    imp = np.zeros((1, 6, 64), np.float32)
    imp[0, 1] = 1.0
    got, _ = rglru._causal_conv(torch.from_numpy(imp), torch.from_numpy(w),
                                torch.zeros(64))
    for j in range(4):
        np.testing.assert_array_equal(got[0, 1 + j].numpy(), w[j])


@pytest.mark.parametrize("S,carried", [(24, False), (24, True), (1, True),
                                       (37, False)])
def test_rglru_forward_and_grads_match_reference(setup, S, carried):
    """Out and state within 1e-5, and the gradients of every leaf and of
    the input (and of a carried state) through one cotangent on out and
    on the new state within 1e-4 of each one's largest entry."""
    _, _, rec = setup
    cj, ct = _cfgs()
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, 64)).astype(np.float32)
    st = ({"h": rng.normal(size=(2, 64)).astype(np.float32),
           "conv": rng.normal(size=(2, 3, 64)).astype(np.float32)}
          if carried else None)
    cot = rng.normal(size=(2, S, 64)).astype(np.float32)
    cot_h = rng.normal(size=(2, 64)).astype(np.float32)

    def loss_j(p, x, st):
        out, new = jax_rglru.rglru_forward(p, cj, x, state=st)
        return jnp.sum(out * cot) + jnp.sum(new["h"] * cot_h)

    # jitted: the reference's eager autodiff of its associative_scan
    # dispatches op by op, several times slower on the CPU
    out_j, new_j = jax.jit(lambda p, x, st: jax_rglru.rglru_forward(
        p, cj, x, state=st))(rec, x, st)
    g_j = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2) if carried
                           else (0, 1)))(rec, x, st)
    p = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
         for k, v in rec.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    stt = (None if st is None else
           {k: torch.from_numpy(v).requires_grad_(True)
            for k, v in st.items()})
    out_t, new_t = rglru.rglru_forward(p, ct, xt, state=stt)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-5)
    for k in ("h", "conv"):
        assert new_t[k].dtype == torch.float32
        np.testing.assert_allclose(new_t[k].detach().numpy(),
                                   np.asarray(new_j[k]), rtol=1e-5,
                                   atol=1e-5)
    (torch.sum(out_t * torch.from_numpy(cot))
     + torch.sum(new_t["h"] * torch.from_numpy(cot_h))).backward()
    pairs = [(p[k].grad, g_j[0][k]) for k in rec] + [(xt.grad, g_j[1])]
    if carried:
        pairs += [(stt[k].grad, g_j[2][k]) for k in ("h", "conv")]
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_log_depth_scan_matches_reference_at_2048(setup):
    """The Hillis-Steele scan against ``jax.lax.associative_scan`` (the
    reference's ``_rg_lru``) at S 2,048 with a carried h0, RG4's
    ``sqrt(max(-expm1(2 log a), 0))`` included: 1e-5 of the largest
    entry."""
    rng = np.random.default_rng(7)
    x, r, i = (rng.normal(size=(2, 2048, 64)).astype(np.float32)
               for _ in range(3))
    r, i = 1 / (1 + np.exp(-r)), 1 / (1 + np.exp(-i))
    lam = np.linspace(0.3, 1.7, 64).astype(np.float32)
    h0 = rng.normal(size=(2, 64)).astype(np.float32)
    hj, lj = jax.jit(jax_rglru._rg_lru)(x, r, i, lam, h0)
    ht, lt = rglru._rg_lru(*(torch.from_numpy(a) for a in (x, r, i, lam)),
                           torch.from_numpy(h0))
    scale = float(np.abs(np.asarray(hj)).max())
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_array_equal(lt.numpy(), ht[:, -1].numpy())


def test_bf16_rec_block_matches_reference(setup):
    """RG2: ``cast_block_params`` rounds every rec leaf to bf16 (``lam``,
    ``ba``, ``bx``, ``conv_b`` included) bitwise as the reference does; a
    bf16 block (softplus in bf16 then promoted, gates from fp32 u, h in
    fp32 cast before the gate, the op-by-op GeLU, RG3) within 2e-2 of
    the reference's in relative norm, its state within 2e-2."""
    _, params, _ = setup
    cj, ct = _cfgs("bfloat16")
    bp = jax.tree.map(lambda l: l[0], params["stack"]["groups"][0])
    want = jax_cast(jax.tree.map(jnp.asarray, bp), cj)
    got = cast_block_params(from_numpy(bp), ct)
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = _at(got, path)
        assert g.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w.astype(jnp.float32)))
    x = np.random.default_rng(2).normal(size=(2, 24, 64)).astype(np.float32)
    out_j, st_j = jax.jit(lambda p, x: jax_rglru.rglru_forward(
        p, cj, x))(want["rec"], jnp.asarray(x, jnp.bfloat16))
    out_t, st_t = rglru.rglru_forward(got["rec"], ct,
                                      torch.from_numpy(x).to(torch.bfloat16))
    assert out_t.dtype == torch.bfloat16
    assert _rel(out_t.float().numpy(),
                np.asarray(out_j.astype(jnp.float32))) < 2e-2
    for k in ("h", "conv"):
        assert st_t[k].dtype == torch.float32
        assert _rel(st_t[k].numpy(), np.asarray(st_j[k])) < 2e-2


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_reference(setup, dtype):
    _, params, _ = setup
    cj, ct = _cfgs(dtype)
    mj, mt = jax_build(cj), build_model(ct)
    units = _units(5, 16, noise=0.25)
    batch = {k: v[1] for k, v in units.items()}
    batch["weights"] = np.asarray([1.0, 0.5, 2.0, 0.0], np.float32)
    jb = jax.tree.map(jnp.asarray, batch)
    opts = ({"xla_allow_excess_precision": False} if dtype == "bfloat16"
            else {})
    g_j = jax.jit(jax.grad(lambda p: mj.loss_fn(p, jb)[0])).lower(
        params).compile(compiler_options=opts)(params)
    loss_j = float(jax.jit(lambda p: mj.loss_fn(p, jb)[0]).lower(
        params).compile(compiler_options=opts)(params))
    live = tree_map(lambda x: x.clone().requires_grad_(True),
                    from_numpy(params))
    total, _ = mt.loss_fn(live, _to_torch(batch))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), loss_j,
                               rtol=1e-5 if dtype == "float32" else 2e-2)
    n_leaves = 0
    for path, want in jax.tree_util.tree_leaves_with_path(g_j):
        got = _at(live, path).grad
        assert got is not None and got.dtype == torch.float32, path
        want = np.asarray(want)
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, err_msg=str(path),
                                       rtol=0,
                                       atol=1e-4 * np.abs(want).max())
        else:
            assert _rel(got.numpy(), want) < 2e-2, (path,
                                                    _rel(got.numpy(), want))
        n_leaves += 1
    assert n_leaves == len(tree_leaves(live))


def test_init_has_the_reference_tree_and_scales(setup):
    """The port's own draws: the reference's tree, shapes and dtypes, the
    constant leaves equal (``lam`` a linspace, zero biases and norms),
    the drawn ones at the reference's scales; ``n_params`` below the
    leaves' count by the reference's formula."""
    _, params, _ = setup
    cfg = get_config(ARCH)
    mine = build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                        torch.device("cpu"))
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(tree_leaves(mine)) == len(flat)
    for path, want in flat:
        got = _at(mine, path)
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        if path[-1].key in ("lam", "ln1", "ln2", "conv_b", "ba", "bx",
                            "final_norm"):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-7, err_msg=str(path))
        else:
            assert float(got.std()) == pytest.approx(float(want.std()),
                                                     rel=0.25), path
    n_leaves = sum(l.numel() for l in tree_leaves(mine))
    assert cfg.n_params() < n_leaves


def test_serving_weights_are_bitwise_the_masters():
    bundle = build_model(_cfgs("bfloat16")[1])
    cpu = torch.device("cpu")
    masters = bundle.init_params(torch.Generator().manual_seed(0), cpu)
    streamed = bundle.init_params(torch.Generator().manual_seed(0), cpu,
                                  dtype=torch.bfloat16)
    for a, b in zip(tree_leaves(streamed),
                    tree_leaves(bundle.serving_params(masters))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, 277, (2, 12)).astype(np.int32))
    with torch.no_grad():
        outs = []
        for p in (masters, streamed):
            logits, cache = bundle.prefill(p, {"tokens": prompts},
                                           cache_len=20)
            out = [logits]
            for _ in range(6):
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
                logits, cache = bundle.decode(p, cache, tok)
                out.append(logits)
            outs.append(out)
    assert all(a.dtype == torch.bfloat16 and torch.equal(a, b)
               for a, b in zip(*outs))


# -- stage A and selection ------------------------------------------------------

@pytest.fixture(scope="module")
def selection(setup):
    mj, params, _ = setup
    proj = jax_ll.make_proj_for(mj, jax.random.PRNGKey(4), K, K)
    units, val = _units(5, 16, noise=0.25, seq=12, size=2), \
        _units(6, 8, seq=12, size=2)
    tproj = Projections(*(torch.from_numpy(np.array(a)) for a in proj))
    return (mj, params, proj, units, val, build_model(get_config(ARCH)),
            from_numpy(params), tproj)


def test_host_stage_a_and_round_match_reference(selection):
    """Host stage A (the grad sketch's plain version) within 1e-4 of the
    reference's largest entry, and one ``pgm_select`` round: the same
    indices, weights within 1e-4 (the reference on its ``xla`` path, the
    plain versions of its kernels)."""
    mj, params, proj, units, val, mt, pt, tproj = selection
    want = np.asarray(jax_ll.units_gradients(
        mj, params, jax.tree.map(jnp.asarray, units), proj,
        kernel_impl="xla"))
    got = ll.units_gradients(mt, pt, _to_torch(units), tproj).numpy()
    assert got.shape == want.shape == (8, K * K)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    pc = dict(subset_fraction=0.5, n_partitions=2, sketch_dim_h=K,
              sketch_dim_v=K, val_matching=True)
    sel_j = jax_pgm.pgm_select(
        mj, params, jax.tree.map(jnp.asarray, units),
        dataclasses.replace(JaxPGMConfig(**pc), kernel_impl="xla"), proj,
        val_units=jax.tree.map(jnp.asarray, val))
    sel_t = pgm.pgm_select(mt, pt, _to_torch(units), PGMConfig(**pc), tproj,
                           val_units=_to_torch(val))
    np.testing.assert_array_equal(sel_t.indices.numpy(),
                                  np.asarray(sel_j.indices))
    np.testing.assert_allclose(sel_t.weights.numpy(),
                               np.asarray(sel_j.weights), atol=1e-4)


@pytest.mark.parametrize("cu", [1, 2, 8])
def test_resident_stage_a_matches_reference(selection, cu):
    """The resident path's batched stage A at ``chunk_units`` 1, 2 and U
    against the reference's ``xla`` path: atol 1e-5 x max(scale, 1)."""
    mj, params, proj, units, _, mt, pt, tproj = selection
    want = np.asarray(jax_ll.units_gradients_batched(
        mj, params, jax.tree.map(jnp.asarray, units),
        proj, chunk_units=cu,
        kernel_impl="xla"))
    got = ll.units_gradients_batched(mt, pt, _to_torch(units), tproj,
                                     chunk_units=cu).numpy()
    assert got.shape == want.shape == (8, K * K)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(float(np.abs(want).max()),
                                               1.0))


def test_resident_round_matches_reference(selection):
    """A ``ResidentSelector`` round against the reference's: the same
    indices, weights within 1e-4, and the port's own host round."""
    mj, params, proj, units, val, mt, pt, tproj = selection
    pc = dict(subset_fraction=0.5, n_partitions=2, sketch_dim_h=K,
              sketch_dim_v=K, val_matching=True)
    want = jax_pgm.ResidentSelector(
        mj, JaxPGMConfig(**pc, kernel_impl="xla"), proj)(
        params, jax.tree.map(jnp.asarray, units),
        val_units=jax.tree.map(jnp.asarray, val))
    selector = pgm.ResidentSelector(mt, PGMConfig(**pc), tproj)
    got = selector(pt, _to_torch(units), val_units=_to_torch(val))
    host = pgm.pgm_select(mt, pt, _to_torch(units), PGMConfig(**pc), tproj,
                          val_units=_to_torch(val))
    for sel in (got, host):
        np.testing.assert_array_equal(sel.indices.numpy(),
                                      np.asarray(want.indices))
        np.testing.assert_allclose(sel.weights.numpy(),
                                   np.asarray(want.weights), atol=1e-4)
    assert selector.degraded_rounds == 0


RUN = dict(lr=0.3, optimizer="sgd", epochs=3)
SEL = dict(subset_fraction=0.5, n_partitions=2, select_every=1,
           warm_start_epochs=1, sketch_dim_h=K, sketch_dim_v=K,
           val_matching=True)


@pytest.fixture(scope="module")
def reference_history():
    """The reference's PGM run (host engine) on the smoke corpus, its
    initial params and projections."""
    fp32_numerics()
    mj = jax_build(jax_get_config(ARCH))
    units, val = _units(0, 16, noise=0.25, seq=10, size=2), \
        _units(7, 8, seq=10, size=2)
    h = jax_train(mj, units, JaxTrainConfig(**RUN, pgm=JaxPGMConfig(**SEL)),
                  method="pgm", val_units=val, engine="host")
    key = jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, mj.init_params(key))
    proj = [np.asarray(x) for x in jax_ll.make_proj_for(
        mj, jax.random.fold_in(key, 17), K, K)]
    return h, units, val, params, proj


@pytest.mark.parametrize("engine,resident", [("host", False),
                                             ("scan", True)])
def test_history_matches_reference(reference_history, engine, resident):
    """``train_with_selection`` on the host engine and on the scan engine
    with resident rounds, against the reference's host run: the same
    subsets, weights within 1e-3, losses within rtol 1e-3, equal
    ``cost_units``."""
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
