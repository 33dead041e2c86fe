"""PyTorch port, the reference's other dense archs against the JAX
reference on the CPU: ``gemma-7b`` (GeGLU, head dim 256 so q_dim !=
d_model, full attention, tied head, embedding scale), ``gemma3-27b``
(5 local : 1 global, QK-norm, GQA, embedding scale) and ``minitron-8b``
(squared ReLU, GQA, untied head), each on its ``-smoke`` reduction and
on a variant that keeps what the reduction hides (4 heads of 16 give
q_dim = d_model and, with at most 4 KV heads, G = 1): ``gemma-7b`` with
4 heads of 32 on d 64 (q_dim 128), ``gemma3-27b`` with 2 KV heads (G =
2), ``minitron-8b`` with 1 (G = 4).  The reference's params go through
numpy.

- configs: every field, the layer kinds and ``n_params``;
- loss and every gradient leaf against ``jax.grad`` (jitted) at
  ``tests/test_torch_lm.py``'s bars: fp32 (TF32 off, every variant) loss
  1e-5, grads 1e-4; bf16 (the three smokes) loss rtol 2e-2, each leaf
  2e-2 relative in norm.  The
  reference's bf16 gradient is compiled with XLA's
  ``xla_allow_excess_precision`` off: with it on (the default) XLA drops
  the bf16 rounding of a residual sum that feeds the next RMSNorm inside
  the compiled layer scan (not in the eager tail layers), and the port,
  which rounds where the reference's code says, sits 2.35e-2 from it on
  gemma3-27b-smoke's QK-norm gammas; off, the reference computes what
  its code writes, and the port sits within 1.2e-2 of it;
- prefill last-token logits (fp32 1e-5) and greedy ``generate`` token for
  token, and a 2,048-token ``gemma3-27b-smoke`` prompt through the band
  (S % 1024 == 0, ROADMAP S1);
- LM stage A (sketch) within 1e-4 of its largest entry and one
  ``pgm_select`` round: the same indices, weights within 1e-4;
- the serving weights (``init_params(dtype=...)``, ``serving_params``):
  the streamed init bitwise ``serving_params`` of the fp32 masters, the
  bundle's prefill and greedy decode logits from them bitwise those of
  the masters at bf16, and ``generate``/``SlotEngine`` tokens equal; a
  CPU generator gives the draws of a
  plain sequence of ``torch.randn`` calls in the reference's order (the
  port's init before weights could be streamed); training refuses them.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import PGMConfig as JaxPGMConfig  # noqa: E402
from repro.core import pgm as jax_pgm  # noqa: E402
from repro.core.lastlayer import make_proj_for as jax_make_proj  # noqa: E402
from repro.core.lastlayer import units_gradients as jax_units_grads  # noqa: E402
from repro.data.pipeline import lm_units  # noqa: E402
from repro.data.synthetic import make_lm_corpus  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import PGMConfig, TrainConfig  # noqa: E402
from repro_torch.convert import from_numpy  # noqa: E402
from repro_torch.core import pgm  # noqa: E402
from repro_torch.core.lastlayer import units_gradients  # noqa: E402
from repro_torch.core.sketch import Projections  # noqa: E402
from repro_torch.kernels.backend import fp32_numerics  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve.engine import Request, SlotEngine, generate  # noqa: E402
from repro_torch.train.engine import make_step_core  # noqa: E402
from repro_torch.train.loop import train_with_selection  # noqa: E402
from repro_torch.train.optim import make_update_for  # noqa: E402

ARCHS = ("gemma-7b-smoke", "gemma3-27b-smoke", "minitron-8b-smoke")
# name -> (arch, fields replaced on both packages' configs)
VARIANTS = {
    "gemma-7b-smoke": ("gemma-7b-smoke", {}),
    "gemma3-27b-smoke": ("gemma3-27b-smoke", {}),
    "minitron-8b-smoke": ("minitron-8b-smoke", {}),
    "gemma-7b-qdim128": ("gemma-7b-smoke", {"head_dim": 32}),
    "gemma3-27b-g2": ("gemma3-27b-smoke", {"n_kv_heads": 2}),
    "minitron-8b-g4": ("minitron-8b-smoke", {"n_kv_heads": 1}),
}
SEQ = 24


def _cfgs(variant, dtype="float32"):
    arch, kw = VARIANTS[variant]
    return (dataclasses.replace(jax_get_config(arch), compute_dtype=dtype,
                                **kw),
            dataclasses.replace(get_config(arch), compute_dtype=dtype, **kw))


def _units(seed, n, noise=0.0):
    return lm_units(make_lm_corpus(seed, n, SEQ, 277, noise_fraction=noise),
                    4)


def _to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _at(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


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
        assert getattr(ct, f.name) == getattr(cj, f.name), f.name
    assert ct.layer_kinds() == cj.layer_kinds()
    assert (ct.q_dim, ct.kv_dim) == (cj.q_dim, cj.kv_dim)
    assert ct.n_params() == cj.n_params()
    assert PGMConfig().kernel_impl == JaxPGMConfig().kernel_impl == "auto"


def test_variants_keep_what_smoke_hides():
    shapes = {v: (c.q_dim, c.d_model, c.n_heads // c.n_kv_heads)
              for v, (_, c) in ((v, _cfgs(v)) for v in VARIANTS)}
    assert shapes["gemma-7b-smoke"] == (64, 64, 1)       # hidden by smoke
    assert shapes["gemma-7b-qdim128"] == (128, 64, 1)
    assert shapes["gemma3-27b-g2"][2] == 2
    assert shapes["minitron-8b-g4"][2] == 4
    full = {a: get_config(a) for a in ("gemma-7b", "gemma3-27b",
                                       "minitron-8b")}
    assert full["gemma-7b"].q_dim == 4096 != full["gemma-7b"].d_model
    assert [c.n_heads // c.n_kv_heads for c in full.values()] == [1, 2, 4]


@pytest.mark.parametrize("variant,dtype", [
    *[(v, "float32") for v in VARIANTS], *[(a, "bfloat16") for a in ARCHS]])
def test_loss_and_grads_match_reference(ref_params, variant, dtype):
    params = ref_params(variant)
    cj, ct = _cfgs(variant, dtype)
    mj, mt = jax_build(cj), build_model(ct)
    units = _units(5, 16, noise=0.25)
    batch = {k: v[1] for k, v in units.items()}
    batch["weights"] = np.asarray([1.0, 0.5, 2.0, 0.0], np.float32)
    jb = jax.tree.map(jnp.asarray, batch)
    # bf16: the reference's numerics as its code writes them (see above)
    opts = ({"xla_allow_excess_precision": False} if dtype == "bfloat16"
            else {})
    g_j = jax.jit(jax.grad(lambda p: mj.loss_fn(p, jb)[0])).lower(
        params).compile(compiler_options=opts)(params)
    loss_j = np.asarray(mj.per_example_loss(params, jb))
    pt = from_numpy(params)
    with torch.no_grad():
        loss_t = mt.per_example_loss(pt, _to_torch(batch)).numpy()
    live = tree_map(lambda x: x.clone().requires_grad_(True), pt)
    total, _ = mt.loss_fn(live, _to_torch(batch))
    total.backward()
    if dtype == "float32":
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
            assert _rel(got.numpy(), want) < 2e-2, (path,
                                                    _rel(got.numpy(), want))
        n_leaves += 1
    assert n_leaves == len(tree_leaves(live))


def _prompts(B, S, seed):
    return np.random.default_rng(seed).integers(0, 277, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("variant,B,S,new", [
    *[(v, 2, 10, 6) for v in VARIANTS], ("gemma3-27b-smoke", 1, 2048, 3)],
    ids=[*VARIANTS, "gemma3-27b-band"])
def test_prefill_and_greedy_decode_match_reference(ref_params, variant, B,
                                                   S, new):
    params = ref_params(variant)
    cj, ct = _cfgs(variant)
    mj, mt = jax_build(cj), build_model(ct)
    pt = from_numpy(params)
    prompts = _prompts(B, S, seed=S)
    lj, _ = mj.prefill(params, {"tokens": jnp.asarray(prompts)},
                       cache_len=S + new)
    with torch.no_grad():
        lt, _ = mt.prefill(pt, {"tokens": torch.from_numpy(prompts)},
                           cache_len=S + new)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5,
                               rtol=1e-5)
    tj, _ = jeng.generate(mj, params, jnp.asarray(prompts), new)
    tt, _ = generate(mt, pt, torch.from_numpy(prompts), new)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))


@pytest.mark.parametrize("arch", ARCHS)
def test_stage_a_and_selection_match_reference(ref_params, arch):
    params = ref_params(arch)
    mj = jax_build(jax_get_config(arch))
    mt = build_model(get_config(arch))
    proj = jax_make_proj(mj, jax.random.PRNGKey(4), 16, 16)
    tproj = Projections(*(torch.from_numpy(np.array(a)) for a in proj))
    units, val = _units(5, 16, noise=0.25), _units(6, 8)
    want = np.asarray(jax_units_grads(
        mj, params, jax.tree.map(jnp.asarray, units), proj,
        kernel_impl="pallas"))
    got = units_gradients(mt, from_numpy(params), _to_torch(units),
                          tproj).numpy()
    assert got.shape == want.shape == (4, 16 * 16)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    pc = dict(subset_fraction=0.5, n_partitions=2, sketch_dim_h=16,
              sketch_dim_v=16, val_matching=True)
    sel_j = jax_pgm.pgm_select(
        mj, params, jax.tree.map(jnp.asarray, units),
        dataclasses.replace(JaxPGMConfig(**pc), kernel_impl="pallas"), proj,
        val_units=jax.tree.map(jnp.asarray, val))
    sel_t = pgm.pgm_select(mt, from_numpy(params), _to_torch(units),
                           PGMConfig(**pc), tproj, val_units=_to_torch(val))
    np.testing.assert_array_equal(sel_t.indices.numpy(),
                                  np.asarray(sel_j.indices))
    np.testing.assert_allclose(sel_t.weights.numpy(),
                               np.asarray(sel_j.weights), atol=1e-4)


# -- the serving weights -----------------------------------------------------

def _bf16(variant):
    return build_model(_cfgs(variant, "bfloat16")[1])


@pytest.mark.parametrize("variant", ["gemma3-27b-smoke", "minitron-8b-g4",
                                     "gemma-7b-qdim128"])
def test_serving_weights_are_bitwise_the_masters(variant):
    bundle = _bf16(variant)
    cpu = torch.device("cpu")
    masters = bundle.init_params(torch.Generator().manual_seed(0), cpu)
    served = bundle.serving_params(masters)
    streamed = bundle.init_params(torch.Generator().manual_seed(0), cpu,
                                  dtype=torch.bfloat16)
    assert all(l.dtype == torch.float32 for l in tree_leaves(masters))
    for name, tree in (("served", served), ("streamed", streamed)):
        assert tree["final_norm"].dtype == torch.float32, name
        rest = {k: v for k, v in tree.items() if k != "final_norm"}
        assert all(l.dtype == torch.bfloat16 for l in tree_leaves(rest)), name
    for a, b in zip(tree_leaves(streamed), tree_leaves(served)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # weights already in the compute dtype are kept, not copied
    assert all(a is b for a, b in zip(
        tree_leaves(bundle.serving_params(streamed)), tree_leaves(streamed)))

    # the bundle's own prefill and decode on each tree (the engines would
    # cast the masters first): logits bitwise at every step
    prompts = torch.from_numpy(_prompts(2, 20, seed=1))
    steps = {}
    with torch.no_grad():
        for name, p in (("masters", masters), ("streamed", streamed)):
            logits, cache = bundle.prefill(p, {"tokens": prompts},
                                           cache_len=28)
            out = [logits]
            for _ in range(8):
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
                logits, cache = bundle.decode(p, cache, tok)
                out.append(logits)
            steps[name] = out
    assert all(a.dtype == torch.bfloat16 and torch.equal(a, b)
               for a, b in zip(steps["masters"], steps["streamed"]))
    tm, _ = generate(bundle, masters, prompts, 8)
    ts, _ = generate(bundle, streamed, prompts, 8)
    assert torch.equal(tm, ts)
    rng = np.random.default_rng(2)
    reqs = [Request(uid=i, inputs={"tokens": rng.integers(
        0, 277, (int(rng.integers(4, 17)),)).astype(np.int32)},
        max_new_tokens=6) for i in range(5)]
    outs = []
    for p in (masters, streamed):
        eng = SlotEngine(bundle, p, n_slots=2, max_new_tokens=6,
                         max_prompt_len=16)
        outs.append({c.uid: list(c.tokens) for c in eng.run(reqs)})
        assert all(l.dtype != torch.float32 for l in
                   tree_leaves({k: v for k, v in eng.params.items()
                                if k != "final_norm"}))
    assert outs[0] == outs[1]


def _plain_draws(cfg, seed):
    """The port's init as a plain sequence of CPU ``torch.randn`` calls in
    the reference's order (each layer's attention wq, wk, wv, wo, then
    its FFN w_in, w_out[, w_gate]; then embed.w and lm_head.w), each
    group's layers stacked: the draws before layers were streamed."""
    g = torch.Generator().manual_seed(seed)

    def dense(i, o):
        return torch.randn((i, o), generator=g) * (1.0 / math.sqrt(i))

    d, z = cfg.d_model, lambda n: torch.zeros((n,))
    layers = []
    for _ in cfg.layer_kinds():
        attn = {"wq": dense(d, cfg.q_dim), "wk": dense(d, cfg.kv_dim),
                "wv": dense(d, cfg.kv_dim), "wo": dense(cfg.q_dim, d)}
        if cfg.qk_norm:
            attn.update(q_norm=z(cfg.head_dim), k_norm=z(cfg.head_dim))
        mlp = {"w_in": dense(d, cfg.d_ff), "w_out": dense(cfg.d_ff, d)}
        if cfg.ffn_type in ("swiglu", "geglu"):
            mlp["w_gate"] = dense(d, cfg.d_ff)
        layers.append({"ln1": z(d), "ln2": z(d), "attn": attn, "mlp": mlp})
    P, n = len(cfg.pattern), cfg.n_layers // len(cfg.pattern)
    groups = tuple(tree_map(lambda *xs: torch.stack(xs),
                            *[layers[k * P + pos] for k in range(n)])
                   for pos in range(P))
    params = {"embed": {"w": torch.randn((cfg.vocab_size, d), generator=g)},
              "stack": {"groups": groups, "tail": tuple(layers[n * P:])},
              "final_norm": z(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": dense(d, cfg.vocab_size)}
    return params


@pytest.mark.parametrize("arch", ["starcoder2-3b-smoke", *ARCHS])
def test_cpu_generator_gives_the_plain_draws(arch):
    cfg = get_config(arch)
    got = build_model(cfg).init_params(torch.Generator().manual_seed(7),
                                       torch.device("cpu"))
    want = _plain_draws(cfg, 7)
    assert len(tree_leaves(got)) == len(tree_leaves(want))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.shape == b.shape and torch.equal(a, b)


def test_training_refuses_serving_weights():
    bundle = _bf16("gemma3-27b-smoke")
    served = bundle.init_params(torch.Generator().manual_seed(0),
                                torch.device("cpu"), dtype=torch.bfloat16)
    tc = TrainConfig(lr=0.5, epochs=2, pgm=PGMConfig(
        subset_fraction=0.5, n_partitions=2, select_every=1,
        warm_start_epochs=1, sketch_dim_h=8, sketch_dim_v=8))
    batch = _to_torch({k: v[0] for k, v in _units(0, 4).items()})
    with pytest.raises(ValueError, match="fp32 master weights"):
        make_step_core(bundle, tc)(served, make_update_for(tc)[0](served),
                                   batch, 0.5)
    with pytest.raises(ValueError, match="fp32 master weights"):
        train_with_selection(bundle, _units(0, 16), tc, method="pgm",
                             val_units=_units(7, 8), device="cpu",
                             params=served)
