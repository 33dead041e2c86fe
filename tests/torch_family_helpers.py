"""Shared parity checks of the encoder-decoder and VLM families
(``tests/test_torch_encdec.py``, ``tests/test_torch_vlm.py``): the port
against the JAX reference on the CPU, on each family's ``-smoke`` config,
with the reference's params carried across by ``convert.py`` and every
norm gamma drawn not zero (ROADMAP ED1: a bf16 decode step reads the
gammas uncast, which only shows with gammas off zero).

Bars: fp32 (TF32 off) loss 1e-5, gradients 1e-4, hidden states, logits
and cache leaves 1e-5 of the largest entry; bf16 loss rtol 2e-2, each
gradient leaf and each logits step 2e-2 relative in norm, the reference's
bf16 gradient compiled with ``xla_allow_excess_precision`` off (ROADMAP
X2).  Training histories: losses rtol 1e-3, the same subsets, weights
1e-3; the port's resident stage A against its host stage A at 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import PGMConfig as JaxPGMConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import lastlayer as jax_ll
from repro.core.sketch import Projections as JaxProjections
from repro.models.api import build_model as jax_build
from repro.serve import engine as jeng
from repro.train.loop import train_with_selection as jax_train
from repro_torch.configs import get_config
from repro_torch.configs.base import PGMConfig, TrainConfig
from repro_torch.convert import cache_from_numpy, cache_to_numpy, \
    from_numpy, to_numpy
from repro_torch.core import lastlayer as ll
from repro_torch.core.sketch import Projections
from repro_torch.kernels.backend import fp32_numerics
from repro_torch.models.api import build_model
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.serve.engine import generate
from repro_torch.train.loop import train_with_selection

NORMS = ("ln1", "ln2", "lnx", "enc_norm", "final_norm", "q_norm", "k_norm")
K = 16                        # sketch dims k1 = k2
SEQ = 24                      # make_batch's S
# lr 0.1: at 0.3 the seamless smoke run amplifies rounding about 30x an
# epoch (train loss 2.6e-7, 7.5e-6, 2.4e-4 relative from the reference's
# over 3 epochs on the host engine), and epoch 2's stage-B weights sit
# 1.03e-3 apart; at 0.1 every epoch agrees to ~2e-7
RUN = dict(lr=0.1, optimizer="sgd", epochs=3)
SEL = dict(subset_fraction=0.5, n_partitions=2, select_every=1,
           warm_start_epochs=1, sketch_dim_h=K, sketch_dim_v=K,
           val_matching=True)


def cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jax_get_config(arch), compute_dtype=dtype),
            dataclasses.replace(get_config(arch), compute_dtype=dtype))


def at(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def close(got, want, tol=1e-5, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def ref_params(arch, seed=3):
    """The reference's init at ``seed`` as numpy, every norm gamma drawn
    N(0, 0.3) (fp32, off bf16's grid)."""
    params = jax_build(jax_get_config(arch)).init_params(
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def gamma(path, leaf):
        leaf = np.asarray(leaf)
        if any(getattr(k, "key", None) in NORMS for k in path):
            return (rng.normal(size=leaf.shape) * 0.3).astype(np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(gamma, params)


def ref_batch(arch, seed, B, S=SEQ):
    """One batch of the reference's ``make_batch`` as numpy."""
    mj = jax_build(jax_get_config(arch))
    return jax.tree.map(np.asarray, mj.make_batch(jax.random.PRNGKey(seed),
                                                  B, S))


def ref_units(arch, seed, n_units, size, S=SEQ):
    """``n_units`` of the reference's ``make_batch`` draws of ``size``
    examples, stacked into units (the leaves' leading axis)."""
    draws = [ref_batch(arch, seed + i, size, S) for i in range(n_units)]
    return {k: np.stack([d[k] for d in draws]) for k in draws[0]}


def to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def serving_inputs(batch):
    return {k: v for k, v in batch.items()
            if k in ("tokens", "frames", "patches")}


# -- configs, init, make_batch, conversion ------------------------------------

def check_config(arch):
    cj, ct = jax_get_config(arch), get_config(arch)
    for f in dataclasses.fields(ct):
        assert getattr(ct, f.name) == getattr(cj, f.name), f.name
    assert ct.layer_kinds() == cj.layer_kinds()
    assert ct.n_params() == cj.n_params()


def check_init(arch):
    """The port's own draws: the reference's tree, shapes and dtypes,
    zero norms, the drawn leaves at the reference's scales; the
    reference's ``n_params`` formula below the leaves' count (it leaves
    out the norms)."""
    want = jax.tree.map(np.asarray, jax_build(jax_get_config(arch))
                        .init_params(jax.random.PRNGKey(0)))
    cfg = get_config(arch)
    mine = build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                        torch.device("cpu"))
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(tree_leaves(mine)) == len(flat)
    for path, w in flat:
        got = at(mine, path)
        assert tuple(got.shape) == w.shape and got.dtype == torch.float32
        if path[-1].key in NORMS:
            assert not got.any() and not w.any(), path
        else:
            assert float(got.std()) == pytest.approx(float(w.std()),
                                                     rel=0.25), path
    n_leaves = sum(l.numel() for l in tree_leaves(mine))
    n_norms = sum(w.size for p, w in flat if p[-1].key in NORMS)
    assert n_leaves - n_norms == cfg.n_params()


def check_make_batch(arch, B=3, S=SEQ):
    want = ref_batch(arch, 0, B, S)
    got = build_model(get_config(arch)).make_batch(
        torch.Generator().manual_seed(0), B, S)
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert got[k].dtype == from_numpy(w).dtype, k
    assert int(got["tokens"].max()) < get_config(arch).vocab_size


def check_roundtrip(arch):
    """Params and a prefill cache across the packages and back, bit for
    bit."""
    params = ref_params(arch)
    back = to_numpy(from_numpy(params))
    for (p, a), b in zip(jax.tree_util.tree_leaves_with_path(params),
                         jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b), p
    cj, _ = cfgs(arch)
    mj = jax_build(cj)
    batch = serving_inputs(ref_batch(arch, 1, 2))
    _, cache = mj.prefill(params, jax.tree.map(jnp.asarray, batch),
                          cache_len=64)
    cache = jax.tree.map(np.asarray, cache)
    back = cache_to_numpy(cache_from_numpy(cache))
    assert jax.tree.structure(back) == jax.tree.structure(cache)
    for a, b in zip(jax.tree.leaves(cache), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# -- the model -------------------------------------------------------------------

def check_loss_and_grads(arch, dtype):
    params = ref_params(arch)
    cj, ct = cfgs(arch, dtype)
    mj, mt = jax_build(cj), build_model(ct)
    batch = ref_batch(arch, 5, 4)
    batch["weights"] = np.asarray([1.0, 0.5, 2.0, 0.0], np.float32)
    jb = jax.tree.map(jnp.asarray, batch)
    opts = ({"xla_allow_excess_precision": False} if dtype == "bfloat16"
            else {})
    g_j = jax.jit(jax.grad(lambda p: mj.loss_fn(p, jb)[0])).lower(
        params).compile(compiler_options=opts)(params)
    loss_j = np.asarray(jax.jit(lambda p: mj.per_example_loss(p, jb)).lower(
        params).compile(compiler_options=opts)(params))
    pt = from_numpy(params)
    with torch.no_grad():
        loss_t = mt.per_example_loss(pt, to_torch(batch)).numpy()
    live = tree_map(lambda x: x.clone().requires_grad_(True), pt)
    total, metrics = mt.loss_fn(live, to_torch(batch))
    total.backward()
    assert float(metrics["aux_loss"]) == 0.0
    np.testing.assert_allclose(loss_t, loss_j,
                               rtol=1e-5 if dtype == "float32" else 2e-2)
    n_leaves = 0
    for path, want in jax.tree_util.tree_leaves_with_path(g_j):
        got = at(live, path).grad
        assert got is not None and got.dtype == torch.float32, path
        want = np.asarray(want)
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, err_msg=str(path),
                                       rtol=1e-4, atol=1e-4)
        else:
            assert rel(got.numpy(), want) < 2e-2, (path,
                                                   rel(got.numpy(), want))
        n_leaves += 1
    assert n_leaves == len(tree_leaves(live))


def check_final_hidden(arch):
    params = ref_params(arch)
    cj, ct = cfgs(arch)
    mj, mt = jax_build(cj), build_model(ct)
    batch = ref_batch(arch, 6, 2)
    h_j, t_j, m_j, _ = mj.final_hidden(params,
                                       jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        h_t, t_t, m_t = mt.final_hidden(from_numpy(params), to_torch(batch))
    assert tuple(h_t.shape) == h_j.shape
    close(h_t.numpy(), h_j, what="final_hidden")
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))


def _cache_len(cfg, Sp, new):
    """The decode cache's length with a VLM's prefix held (S11 avoided)."""
    return (cfg.n_prefix if cfg.family == "vlm" else 0) + Sp + new


def check_prefill_and_decode(arch, dtype, steps=8, B=2, S=SEQ, seed=7):
    """Prefill logits and the converted cache, then ``steps`` decode
    steps fed the reference's greedy tokens, against the reference's
    ``prefill``/``decode``; the cache sized to hold a VLM's prefix."""
    params = ref_params(arch)
    cj, ct = cfgs(arch, dtype)
    mj, mt = jax_build(cj), build_model(ct)
    batch = serving_inputs(ref_batch(arch, seed, B, S))
    Sp = batch["tokens"].shape[1]
    L = _cache_len(cj, Sp, steps)
    lg_j, c_j = jax.jit(mj.prefill, static_argnames=("cache_len",))(
        params, jax.tree.map(jnp.asarray, batch), cache_len=L)
    pt = from_numpy(params)
    with torch.no_grad():
        lg_t, c_t = mt.prefill(pt, to_torch(batch), cache_len=L)
    bf16 = dtype == "bfloat16"

    def same(got, want, what):
        got = got.to(torch.float32).numpy()
        want = np.asarray(want, np.float32)
        if bf16:
            assert rel(got, want) < 2e-2, (what, rel(got, want))
        else:
            close(got, want, what=what)

    same(lg_t, lg_j, "prefill logits")
    want_cache = cache_from_numpy(jax.tree.map(np.asarray, c_j))
    flat_t = tree_leaves(c_t)
    assert len(flat_t) == len(tree_leaves(want_cache))
    for got, want in zip(flat_t, tree_leaves(want_cache)):
        assert got.dtype == want.dtype and got.shape == want.shape
        if got.is_floating_point():
            same(got, want.to(torch.float32).numpy(), "cache")
        else:
            assert torch.equal(got, want)
    dec = jax.jit(mj.decode)
    for i in range(steps):
        tok = jnp.argmax(lg_j, axis=-1).astype(jnp.int32)
        lg_j, c_j = dec(params, c_j, tok)
        with torch.no_grad():
            lg_t, c_t = mt.decode(pt, c_t, torch.from_numpy(np.array(tok)))
        same(lg_t, lg_j, f"decode step {i}")


class _Recording:
    """A bundle whose ``decode`` logits are kept (``generate`` returns
    tokens only)."""

    def __init__(self, bundle):
        self.bundle, self.cfg, self.logits = bundle, bundle.cfg, []

    def serving_params(self, params):
        return self.bundle.serving_params(params)

    def prefill(self, params, batch, cache_len=None):
        logits, cache = self.bundle.prefill(params, batch,
                                            cache_len=cache_len)
        self.logits.append(logits)
        return logits, cache

    def decode(self, params, cache, tokens, live=None):
        logits, cache = self.bundle.decode(params, cache, tokens, live)
        self.logits.append(logits)
        return logits, cache


def reference_loop(mj, params, batch, new, cache_len):
    """The reference's greedy loop over its ``prefill``/``decode`` with a
    cache of ``cache_len`` -> (tokens (B, new), each step's logits)."""
    logits, cache = jax.jit(mj.prefill, static_argnames=("cache_len",))(
        params, jax.tree.map(jnp.asarray, batch), cache_len=cache_len)
    dec = jax.jit(mj.decode)
    toks, out = [], [np.asarray(logits)]
    for i in range(new):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        if i == new - 1:
            break
        logits, cache = dec(params, cache, tok)
        out.append(np.asarray(logits))
    return np.stack(toks, axis=1), out


def check_generate(arch, new=8, B=2, seed=9):
    """The port's ``generate`` token for token against the reference's
    loop with the cache holding a VLM's prefix, each step's logits within
    1e-5 of the largest entry.  -> (reference params, batch, the
    reference's tokens, its logits) for the S11 check."""
    params = ref_params(arch)
    cj, ct = cfgs(arch)
    mj = jax_build(cj)
    batch = serving_inputs(ref_batch(arch, seed, B))
    Sp = batch["tokens"].shape[1]
    want_toks, want_logits = reference_loop(mj, params, batch, new,
                                            _cache_len(cj, Sp, new))
    rec = _Recording(build_model(ct))
    extra = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()
             if k != "tokens"}
    toks, stats = generate(rec, from_numpy(params),
                           torch.from_numpy(np.array(batch["tokens"])), new,
                           extra_inputs=extra)
    np.testing.assert_array_equal(toks.numpy(), want_toks)
    assert len(rec.logits) == len(want_logits) == new
    assert stats.decode_steps == new - 1
    for got, want in zip(rec.logits, want_logits):
        close(got.numpy(), want, what="generate logits")
    return params, batch, want_toks, want_logits


def reference_generate_logits(mj, params, batch, new):
    """The reference's own ``generate`` (its cache sizing) -> (tokens,
    each step's logits, the ``cache_len`` it asked for)."""
    seen, logs = {}, []

    def prefill(p, b, shard=None, cache_len=None):
        seen["cache_len"] = cache_len
        lg, c = mj.prefill(p, b, cache_len=cache_len)
        jax.debug.callback(lambda x: logs.append(np.asarray(x)), lg)
        return lg, c

    def decode(p, c, t, shard=None):
        lg, c = mj.decode(p, c, t)
        jax.debug.callback(lambda x: logs.append(np.asarray(x)), lg)
        return lg, c

    rb = dataclasses.replace(mj, prefill=prefill, decode=decode)
    extra = {k: jnp.asarray(v) for k, v in batch.items() if k != "tokens"}
    toks, _ = jeng.generate(rb, params, jnp.asarray(batch["tokens"]), new,
                            extra_inputs=extra)
    jax.effects_barrier()
    return np.asarray(toks), logs, seen["cache_len"]


# -- training under PGM --------------------------------------------------------

def history_setup(arch, unit_size=2):
    """The reference's PGM run on its host engine over 8 units stacked
    from its ``make_batch`` draws (validation: 4 units), its initial
    params and projections."""
    fp32_numerics()
    mj = jax_build(jax_get_config(arch))
    units = ref_units(arch, 100, 8, unit_size)
    val = ref_units(arch, 200, 4, unit_size)
    h = jax_train(mj, units, JaxTrainConfig(**RUN, pgm=JaxPGMConfig(**SEL)),
                  method="pgm", val_units=val, engine="host")
    key = jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, mj.init_params(key))
    proj = [np.asarray(x) for x in jax_ll.make_proj_for(
        mj, jax.random.fold_in(key, 17), K, K)]
    return h, units, val, params, proj


def check_history(setup, arch, engine, resident):
    h_j, units, val, params, proj = setup
    h_t = train_with_selection(
        build_model(get_config(arch)), units,
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
    return h_t


def check_stage_a(setup, arch):
    """Host stage A (``units_gradients``) against the reference's ``xla``
    path within 1e-4 of its largest entry, and the resident path's
    batched stage A (chunks of 1, 2 and all units: ``frames``/``patches``
    ride in each chunk) against the port's host stage A at 1e-5."""
    _, units, _, params, proj = setup
    mj, mt = jax_build(jax_get_config(arch)), build_model(get_config(arch))
    pt = from_numpy(params)
    tproj = Projections(*(torch.from_numpy(np.array(a)) for a in proj))
    want = np.asarray(jax_ll.units_gradients(
        mj, params, jax.tree.map(jnp.asarray, units),
        JaxProjections(*(jnp.asarray(a) for a in proj)), kernel_impl="xla"))
    host = ll.units_gradients(mt, pt, to_torch(units), tproj).numpy()
    assert host.shape == want.shape == (8, K * K)
    close(host, want, 1e-4, "host stage A")
    for cu in (1, 2, 8):
        got = ll.units_gradients_batched(mt, pt, to_torch(units), tproj,
                                         chunk_units=cu).numpy()
        close(got, host, 1e-5, f"resident stage A, chunk_units {cu}")


def walk(tree, path=()):
    """(path of keys, leaf) over a tree of dicts and sequences."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from walk(t, path + (i,))
    else:
        yield path, tree


def check_serving_weights(arch, fp32_norms):
    """bf16: the streamed serving init equal to ``serving_params`` of the
    fp32 masters (the norms, zero at init, by dtype), the norm gammas
    under ``fp32_norms`` (path prefixes) kept fp32 and the others cast,
    and the prefill and greedy decode logits from the serving weights
    bitwise those from the masters, with the masters' gammas drawn off
    zero (so a gamma read in fp32 differs from its bf16 cast, ED1)."""
    bundle = build_model(cfgs(arch, "bfloat16")[1])
    cpu = torch.device("cpu")
    masters = bundle.init_params(torch.Generator().manual_seed(0), cpu)
    g = torch.Generator().manual_seed(1)
    for path, leaf in walk(masters):
        if path[-1] in NORMS:
            leaf.copy_(torch.randn(leaf.shape, generator=g) * 0.3)
    streamed = bundle.init_params(torch.Generator().manual_seed(0), cpu,
                                  dtype=torch.bfloat16)
    serving = bundle.serving_params(masters)
    for (path, a), (_, b) in zip(walk(streamed), walk(serving)):
        assert a.dtype == b.dtype, path
        if path[-1] in NORMS:
            keep = any(path[:len(f)] == f for f in fp32_norms)
            assert b.dtype == (torch.float32 if keep else torch.bfloat16), \
                path
        else:
            assert torch.equal(a, b), path
    batch = serving_inputs(bundle.make_batch(
        torch.Generator().manual_seed(2), 2, SEQ))
    L = _cache_len(bundle.cfg, batch["tokens"].shape[1], 6)
    outs = []
    with torch.no_grad():
        for p in (masters, serving):
            logits, cache = bundle.prefill(p, batch, cache_len=L)
            out = [logits]
            for _ in range(6):
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
                logits, cache = bundle.decode(p, cache, tok)
                out.append(logits)
            outs.append(out)
    assert all(a.dtype == torch.bfloat16 and torch.equal(a, b)
               for a, b in zip(*outs))
