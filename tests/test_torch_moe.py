"""PyTorch port, the MoE family against the JAX reference on the CPU:
``mixtral-8x7b`` (8 experts top-2, every layer local with a window) and
``olmoe-1b-7b`` (64 experts top-8, full attention, QK-norm), each on its
``-smoke`` reduction (4 experts of 32, top 2), and a variant that keeps
what the reduction hides: 16 experts top-8 at capacity factor 0.5, so
experts drop tokens.  The reference's params go through numpy
(``convert.from_numpy``); inputs are drawn with numpy from a seed.  The
hazards M1-M6 are ROADMAP.md's (the MoE hazards).

- configs: every field, ``n_params`` and ``n_active_params``;
- ``_topk_dispatch``: dispatch and combine equal to the reference's, on
  its own two regressions (capacity 1 with top-1 and a top-2 partial
  drop; bf16 gates past 256 tokens, M2), top-8 of 16 with drops, and two
  groups of 2,048 tokens; M1's raise in both packages;
- ``moe_forward`` and ``decode=True`` at fp32 (out and aux 1e-5), and at
  bf16 with M3's near-tie count stated: routing equal on every token
  whose k-th and (k+1)-th bf16 gates are more than one bf16 ulp apart;
- the loss and every gradient leaf against ``jax.grad`` of the
  reference's ``loss_fn``: fp32 loss 1e-5, gradients 1e-4 of each leaf's
  largest entry; bf16 on the smokes as ``test_torch_dense_archs.py``
  holds it (ROADMAP X2: the reference compiled with
  ``xla_allow_excess_precision`` off, loss rtol 2e-2, each leaf 2e-2
  relative in norm);
- prefill and greedy decode token for token: an ``olmoe`` bucket with
  pad rows (M4) and a ``mixtral`` exact length; ``SlotEngine`` on both;
- the router term (``moe_router_grads``, ``moe_unit_sketch``,
  ``moe_unit_exact``) against the reference's, and the routerless
  ``ValueError``;
- the host engine's history with the router term against the
  reference's ``train_with_selection`` (losses rtol 1e-3, the same
  subsets), and the port's scan engine against its host engine;
- ``ResidentSelector`` with the router term against ``units_gradients``
  (1e-5), its head block at ``chunk_units`` 1 bitwise the head-only
  vector;
- the serving weights: streamed bf16 init bitwise ``serving_params`` of
  the masters, prefill and decode logits bitwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import MoEConfig as JaxMoEConfig  # noqa: E402
from repro.configs.base import PGMConfig as JaxPGMConfig  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.core import lastlayer as jax_ll  # noqa: E402
from repro.data.pipeline import lm_units  # noqa: E402
from repro.data.synthetic import make_lm_corpus  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.train.loop import train_with_selection as jax_train  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import MoEConfig, PGMConfig, TrainConfig  # noqa: E402
from repro_torch.convert import from_numpy  # noqa: E402
from repro_torch.core import lastlayer as ll  # noqa: E402
from repro_torch.core.pgm import ResidentSelector  # noqa: E402
from repro_torch.core.sketch import Projections  # noqa: E402
from repro_torch.kernels.backend import fp32_numerics  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve.engine import Request, SlotEngine, generate  # noqa: E402
from repro_torch.train.loop import train_with_selection  # noqa: E402

ARCHS = ("mixtral-8x7b-smoke", "olmoe-1b-7b-smoke")
# name -> (arch, MoE settings replaced on both packages' configs)
VARIANTS = {"mixtral-8x7b-smoke": ("mixtral-8x7b-smoke", None),
            "olmoe-1b-7b-smoke": ("olmoe-1b-7b-smoke", None),
            "olmoe-e16-top8-drops": ("olmoe-1b-7b-smoke",
                                     dict(n_experts=16, top_k=8,
                                          d_ff_expert=32,
                                          capacity_factor=0.5))}
SEQ = 24


def _cfgs(variant, dtype="float32"):
    arch, m = VARIANTS[variant]
    cj, ct = jax_get_config(arch), get_config(arch)
    kj, kt = {}, {}
    if m is not None:
        kj["moe"], kt["moe"] = JaxMoEConfig(**m), MoEConfig(**m)
    return (dataclasses.replace(cj, compute_dtype=dtype, **kj),
            dataclasses.replace(ct, compute_dtype=dtype, **kt))


def _units(seed, n, noise=0.0, seq=SEQ):
    return lm_units(make_lm_corpus(seed, n, seq, 277, noise_fraction=noise),
                    4)


def _to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _at(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _proj(proj):
    return Projections(*(torch.from_numpy(np.array(a)) for a in proj))


@pytest.fixture(scope="module")
def ref_params():
    """variant -> the reference's init at key 3, as numpy."""
    fp32_numerics()
    cache = {}

    def get(variant):
        if variant not in cache:
            cj, _ = _cfgs(variant)
            cache[variant] = jax.tree.map(
                np.asarray, jax_build(cj).init_params(jax.random.PRNGKey(3)))
        return cache[variant]
    return get


@pytest.mark.parametrize("arch", [a[: -len("-smoke")] for a in ARCHS]
                         + list(ARCHS))
def test_configs_match_reference(arch):
    cj, ct = jax_get_config(arch), get_config(arch)
    for f in dataclasses.fields(ct):
        if f.name == "moe":
            assert dataclasses.asdict(ct.moe) == dataclasses.asdict(cj.moe)
        else:
            assert getattr(ct, f.name) == getattr(cj, f.name), f.name
    assert ct.layer_kinds() == cj.layer_kinds()
    assert ct.n_params() == cj.n_params()
    assert ct.n_active_params() == cj.n_active_params()
    assert PGMConfig().moe_router_term is JaxPGMConfig().moe_router_term \
        is False
    full = {"mixtral-8x7b": 46_702_526_464, "olmoe-1b-7b": 6_919_028_736}
    if arch in full:
        assert ct.n_params() == full[arch]
    build_model(ct)


# -- _topk_dispatch ---------------------------------------------------------

def _gates(seed, G, S, E, dtype=np.float32):
    """Softmax gates of normal logits, computed by the reference (fp32,
    then cast), as numpy in ``dtype``'s JAX counterpart."""
    logits = np.random.default_rng(seed).normal(size=(G, S, E))
    g = jax.nn.softmax(jnp.asarray(logits, jnp.float32), axis=-1)
    return np.asarray(g.astype(jnp.bfloat16 if dtype == "bf16"
                               else jnp.float32))


@pytest.mark.parametrize("G,S,E,k,cap,dtype", [
    (2, 24, 4, 1, 1, "f32"),        # the reference's capacity-1 regression
    (2, 24, 4, 2, 1, "f32"),        # ... and its top-2 partial drop
    (1, 600, 2, 1, 512, "bf16"),    # bf16 positions past 256 tokens (M2)
    (2, 64, 16, 8, 20, "f32"),      # top-8 of 16 with drops
    (2, 2048, 4, 2, 1280, "f32"),   # two groups of 2,048 (d 64: 4096 tokens)
], ids=["cap1-top1", "cap1-top2", "bf16-600", "top8-of-16", "two-groups"])
def test_topk_dispatch_matches_reference(G, S, E, k, cap, dtype):
    g = _gates(S + k, G, S, E, "bf16" if dtype == "bf16" else np.float32)
    dj, cj = jax_moe._topk_dispatch(jnp.asarray(g), k, cap)
    gt = torch.from_numpy(np.asarray(g, np.float32))
    if dtype == "bf16":
        gt = gt.to(torch.bfloat16)
    dt, ct = moe._topk_dispatch(gt, k, cap)
    assert dt.dtype == ct.dtype == gt.dtype
    np.testing.assert_array_equal(dt.float().numpy(),
                                  np.asarray(dj, np.float32))
    np.testing.assert_array_equal(ct.float().numpy(),
                                  np.asarray(cj, np.float32))
    kept = dt.float().sum(dim=(2, 3))
    if cap < S * k // E:
        assert bool((kept < k).any())          # some tokens were dropped


def test_groups_that_do_not_divide_raise_in_both_packages():
    """M1: 3,000 tokens do not split into groups of 2,048; the reference
    asserts, the port raises a ValueError naming the hazard."""
    cj, ct = _cfgs("mixtral-8x7b-smoke")
    p = jax_moe.init_moe_params(jax.random.PRNGKey(0), 64, cj.moe,
                                cj.ffn_type)
    x = np.zeros((1, 3000, 64), np.float32)
    with pytest.raises(AssertionError):
        jax_moe.moe_forward(p, cj, jnp.asarray(x))
    with pytest.raises(ValueError, match="M1"):
        moe.moe_forward(from_numpy(jax.tree.map(np.asarray, p)), ct,
                        torch.from_numpy(x))


# -- moe_forward --------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("decode", [False, True])
def test_moe_forward_matches_reference(variant, decode):
    cj, ct = _cfgs(variant)
    p = jax.tree.map(np.asarray, jax_moe.init_moe_params(
        jax.random.PRNGKey(1), 64, cj.moe, cj.ffn_type))
    x = np.random.default_rng(2).normal(size=(2, SEQ, 64)).astype(np.float32)
    oj, aj = jax_moe.moe_forward(p, cj, jnp.asarray(x), decode=decode)
    with torch.no_grad():
        ot, at = moe.moe_forward(from_numpy(p), ct, torch.from_numpy(x),
                                 decode=decode)
    assert at.dtype == torch.float32 and at.shape == ()
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)


def _choices(dispatch):
    """(G, S, E, C) dispatch -> (G, S, E) bool: the experts that kept each
    token."""
    return np.asarray(dispatch, np.float32).sum(-1) > 0


def test_moe_forward_bf16_routes_as_the_reference_but_near_ties():
    """M3 at bf16 on the same bf16 input: the gates are rounded to bf16
    before the top-k, so an fp32 softmax an ulp apart can flip a choice
    where the k-th and (k+1)-th bf16 gates lie within one bf16 ulp.  The
    count of such tokens is stated; every other token is routed to the
    same experts, and the no-drop capacity leaves positions aside."""
    cj, ct = _cfgs("olmoe-e16-top8-drops", "bfloat16")
    cj = dataclasses.replace(cj, moe=dataclasses.replace(
        cj.moe, capacity_factor=2.0))
    ct = dataclasses.replace(ct, moe=dataclasses.replace(
        ct.moe, capacity_factor=2.0))
    p = jax.tree.map(np.asarray, jax_moe.init_moe_params(
        jax.random.PRNGKey(1), 64, cj.moe, cj.ffn_type))
    x = jnp.asarray(np.random.default_rng(3).normal(size=(2, 512, 64)),
                    jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    k, E = cj.moe.top_k, cj.moe.n_experts
    # the gates each package routes on, and the capacity the forward uses
    lj = (x.reshape(1, -1, 64) @ jnp.asarray(p["router"]).astype(
        jnp.bfloat16)).astype(jnp.float32)
    gj = jax.nn.softmax(lj, -1).astype(jnp.bfloat16)
    lt = (xt.reshape(1, -1, 64) @ torch.from_numpy(p["router"]).to(
        torch.bfloat16)).float()
    gt = torch.softmax(lt, -1).to(torch.bfloat16)
    cap = max(1, int(2.0 * 1024 * k / E))
    dj, _ = jax_moe._topk_dispatch(gj, k, cap)
    dt, _ = moe._topk_dispatch(gt, k, cap)
    sj, st = _choices(dj)[0], _choices(dt.float().numpy())[0]
    g32 = np.sort(np.asarray(gj, np.float32)[0], axis=-1)[:, ::-1]
    ulp = np.spacing(g32[:, k - 1].astype(np.float32)) * 2.0 ** 16
    near = (g32[:, k - 1] - g32[:, k]) <= ulp
    differ = (sj != st).any(-1)
    n_near, n_differ = int(near.sum()), int(differ.sum())
    assert not (differ & ~near).any(), (n_near, n_differ)
    # the count on these inputs (1,024 tokens, top-8 of 16)
    assert (n_near, n_differ) == (N_NEAR_TIES, N_FLIPPED), (n_near, n_differ)
    with torch.no_grad():
        ot, at = moe.moe_forward(from_numpy(p), ct, xt)
    oj, aj = jax_moe.moe_forward(p, cj, x)
    assert ot.dtype == torch.bfloat16
    assert _rel(ot.float().numpy(), np.asarray(oj, np.float32)) < 2e-2
    np.testing.assert_allclose(float(at), float(aj), rtol=2e-2)


N_NEAR_TIES, N_FLIPPED = 45, 0


# -- the loss and its gradients ---------------------------------------------

@pytest.mark.parametrize("variant,dtype", [
    *[(v, "float32") for v in VARIANTS], *[(a, "bfloat16") for a in ARCHS]])
def test_loss_and_grads_match_reference(ref_params, monkeypatch, variant,
                                       dtype):
    params = ref_params(variant)
    kept = []
    dispatch_of = moe._topk_dispatch

    def counted(gates, top_k, capacity):
        d, c = dispatch_of(gates, top_k, capacity)
        kept.append((float(d.float().sum()), gates.shape[0] * gates.shape[1]
                     * top_k))
        return d, c
    monkeypatch.setattr(moe, "_topk_dispatch", counted)
    cj, ct = _cfgs(variant, dtype)
    mj, mt = jax_build(cj), build_model(ct)
    units = _units(5, 16, noise=0.25)
    batch = {k: v[1] for k, v in units.items()}
    batch["weights"] = np.asarray([1.0, 0.5, 2.0, 0.0], np.float32)
    jb = jax.tree.map(jnp.asarray, batch)
    opts = ({"xla_allow_excess_precision": False} if dtype == "bfloat16"
            else {})
    g_j = jax.jit(jax.grad(lambda p: mj.loss_fn(p, jb)[0])).lower(
        params).compile(compiler_options=opts)(params)
    total_j, m_j = mj.loss_fn(params, jb)
    pt = from_numpy(params)
    live = tree_map(lambda x: x.clone().requires_grad_(True), pt)
    total, m_t = mt.loss_fn(live, _to_torch(batch))
    n_forward = len(kept)
    total.backward()
    assert float(m_t["aux_loss"]) > 0
    assert float(total) == pytest.approx(float(m_t["loss"])
                                         + float(m_t["aux_loss"]), rel=1e-6)
    rtol = 1e-5 if dtype == "float32" else 2e-2
    for key in ("loss", "aux_loss", "total_loss"):
        np.testing.assert_allclose(float(m_t[key]), float(m_j[key]),
                                   rtol=rtol, err_msg=key)
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
    # a routing a layer in the forward; the backward routes each group
    # (one layer here) again, last group first, the same way (remat's
    # recompute, B4); the variant's experts drop tokens (M2)
    assert n_forward == ct.n_layers
    assert len(kept) == 2 * ct.n_layers
    assert kept[n_forward:][::-1] == kept[:n_forward]
    if variant == "olmoe-e16-top8-drops":
        assert all(k < n for k, n in kept), kept


# -- serving --------------------------------------------------------------

def _prompts(B, S, seed):
    return np.random.default_rng(seed).integers(0, 277, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("arch,B,S,lens", [
    # a slot's prefill: one prompt of 10 in a bucket of 16, its 6 pad
    # rows routed with it (M4: they take capacity after the prompt's
    # first choices, ahead of its second)
    ("olmoe-1b-7b-smoke", 1, 16, (10,)),
    ("mixtral-8x7b-smoke", 2, 10, None)],     # exact lengths (local layers)
    ids=["olmoe-bucket", "mixtral-exact"])
def test_prefill_and_greedy_decode_match_reference(ref_params, arch, B, S,
                                                   lens):
    params = ref_params(arch)
    cj, ct = _cfgs(arch)
    mj, mt = jax_build(cj), build_model(ct)
    pt = from_numpy(params)
    prompts = _prompts(B, S, seed=S)
    new = 6
    kw_j, kw_t = {}, {}
    if lens is not None:
        kw_j["prompt_lens"] = jnp.asarray(lens, jnp.int32)
        kw_t["prompt_lens"] = torch.tensor(lens, dtype=torch.int32)
    lj, cache_j = mj.prefill(params, {"tokens": jnp.asarray(prompts)},
                             cache_len=S + new, **kw_j)
    with torch.no_grad():
        lt, cache_t = mt.prefill(pt, {"tokens": torch.from_numpy(prompts)},
                                 cache_len=S + new, **kw_t)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5,
                               rtol=1e-5)
    # greedy decode from the prefill, step by step on both sides
    for step in range(new):
        tj = jnp.argmax(lj, -1).astype(jnp.int32)
        tt = torch.argmax(lt, -1).to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj),
                                      err_msg=str(step))
        lj, cache_j = mj.decode(params, cache_j, tj)
        with torch.no_grad():
            lt, cache_t = mt.decode(pt, cache_t, tt)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5,
                                   rtol=1e-5)
    if lens is None:
        tj, _ = jeng.generate(mj, params, jnp.asarray(prompts), new)
        tt, _ = generate(mt, pt, torch.from_numpy(prompts), new)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_engine_matches_reference(ref_params, arch):
    """The slot engines on requests of 4-16 tokens: ``olmoe`` right-pads
    to power-of-two buckets (pad rows routed with the prompt, M4),
    ``mixtral`` prefills exact lengths; completions token for token."""
    params = ref_params(arch)
    cj, ct = _cfgs(arch)
    rng = np.random.default_rng(4)
    toks = [rng.integers(0, 277, (int(rng.integers(4, 17)),)).astype(
        np.int32) for _ in range(5)]
    kw = dict(n_slots=2, max_new_tokens=5, max_prompt_len=16)
    ej = jeng.SlotEngine(jax_build(cj), params, **kw)
    want = {c.uid: list(c.tokens) for c in ej.run(
        [jeng.Request(uid=i, inputs={"tokens": t}, max_new_tokens=5)
         for i, t in enumerate(toks)])}
    et = SlotEngine(build_model(ct), from_numpy(params), **kw)
    got = {c.uid: list(c.tokens) for c in et.run(
        [Request(uid=i, inputs={"tokens": t}, max_new_tokens=5)
         for i, t in enumerate(toks)])}
    assert et.exact_lengths == (arch == "mixtral-8x7b-smoke")
    assert got == want


# -- the router term -------------------------------------------------------

@pytest.fixture(scope="module")
def router_setup(ref_params):
    def get(arch):
        params = ref_params(arch)
        cj, ct = _cfgs(arch)
        mj, mt = jax_build(cj), build_model(ct)
        proj = jax_ll.make_proj_for(mj, jax.random.PRNGKey(4), 16, 16)
        return mj, mt, params, proj
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_router_term_matches_reference(router_setup, arch):
    mj, mt, params, proj = router_setup(arch)
    units = _units(5, 16, noise=0.25)
    batch = {k: v[2] for k, v in units.items()}
    jb = jax.tree.map(jnp.asarray, batch)
    pt = from_numpy(params)
    # the reference's functions jitted (its eager autodiff dispatches op
    # by op, several times slower on the CPU)
    want = jax.jit(lambda p, b: jax_ll.moe_router_grads(mj, p, b))(
        params, jb)
    got = ll.moe_router_grads(mt, pt, _to_torch(batch))
    assert len(got) == len(want) == 1      # one stacked group of routers
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == (2, 64, mt.cfg.moe.n_experts)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    sk_j = np.asarray(jax.jit(lambda p, b: jax_ll.moe_unit_sketch(
        mj, p, b, proj, kernel_impl="pallas"))(params, jb))
    sk_t = ll.moe_unit_sketch(mt, pt, _to_torch(batch), _proj(proj)).numpy()
    assert sk_t.shape == sk_j.shape == (16 * 16 + 2 * 16
                                        * mt.cfg.moe.n_experts,)
    np.testing.assert_allclose(sk_t, sk_j, rtol=0,
                               atol=1e-5 * np.abs(sk_j).max())
    ex_j = np.asarray(jax.jit(lambda p, b: jax_ll.moe_unit_exact(
        mj, p, b))(params, jb))
    ex_t = ll.moe_unit_exact(mt, pt, _to_torch(batch)).numpy()
    assert ex_t.shape == ex_j.shape == (64 * 277 + 2 * 64
                                        * mt.cfg.moe.n_experts,)
    np.testing.assert_allclose(ex_t, ex_j, rtol=0,
                               atol=1e-5 * np.abs(ex_j).max())
    # units_gradients with the router term: each unit's sketch as above
    ug = ll.units_gradients(mt, pt, _to_torch(units), _proj(proj),
                            router_term=True)
    assert torch.equal(ug[2], torch.from_numpy(sk_t))


def test_routerless_params_raise_in_both_packages(ref_params):
    arch = "starcoder2-3b-smoke"
    mj = jax_build(jax_get_config(arch))
    params = jax.tree.map(np.asarray, mj.init_params(jax.random.PRNGKey(0)))
    batch = {k: v[0] for k, v in _units(5, 16).items()}
    with pytest.raises(ValueError, match="router"):
        jax_ll.moe_router_grads(mj, params, jax.tree.map(jnp.asarray, batch))
    with pytest.raises(ValueError, match="router"):
        ll.moe_router_grads(build_model(get_config(arch)),
                            from_numpy(params), _to_torch(batch))


# -- training with the router term --------------------------------------------

RUN = dict(lr=0.2, optimizer="sgd", epochs=3)
SEL = dict(subset_fraction=0.5, n_partitions=2, select_every=2,
           warm_start_epochs=1, sketch_dim_h=16, sketch_dim_v=16,
           moe_router_term=True)


def _history_inputs(mj):
    units, val = _units(0, 16, noise=0.25, seq=10), _units(7, 8, seq=10)
    key = jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, mj.init_params(key))
    proj = [np.asarray(x) for x in jax_ll.make_proj_for(
        mj, jax.random.fold_in(key, 17), 16, 16)]
    return units, val, params, proj


def _same_history(h_a, h_b):
    assert len(h_a.selections) == len(h_b.selections) >= 1
    for sa, sb in zip(h_a.selections, h_b.selections):
        assert sa["epoch"] == sb["epoch"]
        assert sa["indices"] == sb["indices"], (sa, sb)
        np.testing.assert_allclose(sa["weights"], sb["weights"], atol=1e-3)
    np.testing.assert_allclose(h_a.train_loss, h_b.train_loss, rtol=1e-3)
    np.testing.assert_allclose(h_a.val_loss, h_b.val_loss, rtol=1e-3)
    assert h_a.cost_units == pytest.approx(h_b.cost_units)


def test_router_term_history_matches_reference_and_scan_engine():
    fp32_numerics()
    arch = "mixtral-8x7b-smoke"
    mj = jax_build(jax_get_config(arch))
    units, val, params, proj = _history_inputs(mj)
    tj = JaxTrainConfig(**RUN, pgm=JaxPGMConfig(**SEL))
    h_j = jax_train(mj, units, tj, method="pgm", val_units=val,
                    engine="host")
    tc = TrainConfig(**RUN, pgm=PGMConfig(**SEL))
    runs = {eng: train_with_selection(
        build_model(get_config(arch)), units, tc, method="pgm",
        val_units=val, engine=eng, device="cpu", params=params, proj=proj)
        for eng in ("host", "scan")}
    # the router term is in the vectors: D = head + 2 layers x 16 x 4
    _same_history(runs["host"], h_j)
    _same_history(runs["scan"], runs["host"])


@pytest.mark.parametrize("arch", ARCHS)
def test_resident_selector_with_router_term(router_setup, arch):
    _, mt, params, proj = router_setup(arch)
    pt, pr = from_numpy(params), _proj(proj)
    units = _to_torch(_units(5, 16, noise=0.25))
    pc = PGMConfig(subset_fraction=0.5, n_partitions=2, sketch_dim_h=16,
                   sketch_dim_v=16, moe_router_term=True)
    host = ll.units_gradients(mt, pt, units, pr, router_term=True)
    for cu in (1, 2):
        sel = ResidentSelector(mt, pc, pr, chunk_units=cu)
        got = sel.stage_a(pt, units)
        assert got.shape == host.shape == (4, 16 * 16 + 2 * 16
                                           * mt.cfg.moe.n_experts)
        torch.testing.assert_close(got, host, rtol=0,
                                   atol=1e-5 * float(host.abs().max()))
    # chunk_units 1: each unit's head block is bitwise the head-only
    # vector (the router term is appended, nothing else moves)
    head = ResidentSelector(mt, dataclasses.replace(
        pc, moe_router_term=False), pr, chunk_units=1).stage_a(pt, units)
    rt1 = ResidentSelector(mt, pc, pr, chunk_units=1).stage_a(pt, units)
    assert torch.equal(rt1[:, :16 * 16], head)
    s = sel(pt, units)
    assert s.n_selected == 2 and sel.degraded_rounds == 0


# -- the serving weights -------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serving_weights_are_bitwise_the_masters(arch):
    bundle = build_model(_cfgs(arch, "bfloat16")[1])
    cpu = torch.device("cpu")
    masters = bundle.init_params(torch.Generator().manual_seed(0), cpu)
    served = bundle.serving_params(masters)
    streamed = bundle.init_params(torch.Generator().manual_seed(0), cpu,
                                  dtype=torch.bfloat16)
    assert all(l.dtype == torch.float32 for l in tree_leaves(masters))
    assert "moe" in masters["stack"]["groups"][0]
    for a, b in zip(tree_leaves(streamed), tree_leaves(served)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    rest = {k: v for k, v in streamed.items() if k != "final_norm"}
    assert all(l.dtype == torch.bfloat16 for l in tree_leaves(rest))
    prompts = torch.from_numpy(_prompts(2, 16, seed=1))
    steps = {}
    with torch.no_grad():
        for name, p in (("masters", masters), ("streamed", streamed)):
            logits, cache = bundle.prefill(p, {"tokens": prompts},
                                           cache_len=24)
            out = [logits]
            for _ in range(8):
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
                logits, cache = bundle.decode(p, cache, tok)
                out.append(logits)
            steps[name] = out
    assert all(a.dtype == torch.bfloat16 and torch.equal(a, b)
               for a, b in zip(steps["masters"], steps["streamed"]))
