"""PyTorch port, serving the recurrent families against the JAX reference
on the CPU: ``recurrentgemma-9b-smoke`` (RG-LRU state and local KV
rings) and ``rwkv6-3b-smoke`` (WKV state and token-shift rows), with the
reference's params converted through numpy and prompts drawn with numpy
from a seed.  Caches are compared leafwise after
``convert.cache_from_numpy`` puts the reference's in the port's layout;
logits and state at fp32 within 1e-5 (1e-4 relative past a WKV chunked
prefill, whose sums run in another order than the reference's scan).

- prefill, then greedy decode token for token, every step's logits and
  the caches, at B 2 and at S 128 (the RWKV6 chunked branch, R7) and a
  2,048-token ``recurrentgemma`` prompt through the band (S % 1024 == 0,
  where ROADMAP S1 lets the reference run);
- S10: a right-padded prefill (``prompt_lens``) against the reference's
  *unpadded* prefill of the live prefix, its cache and the decode steps
  after it; and the reference's own padded prefill, which differs (its
  recurrence runs over the pads);
- ``generate`` against the reference's;
- ``SlotEngine`` against the reference's per-request ``generate`` (never
  its ``SlotEngine``, which serves these families wrongly under S10):
  ``rwkv6`` right-pads to power-of-two buckets, ``recurrentgemma``
  (local layers) prefills exact lengths;
- a decode with rows not live leaves those rows' recurrent state
  bit-exact, and RG5's dtypes: fp32 state from ``init_cache``, bf16
  shift rows from a bf16 prefill, decode updates cast to the entry's
  dtype, the fp32 pool taking bf16 rows exactly;
- the serving launcher's summary lines for both archs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import cache_from_numpy, from_numpy  # noqa: E402
from repro_torch.kernels.backend import fp32_numerics  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve.engine import Request, SlotEngine, generate  # noqa: E402

RG, RWKV = "recurrentgemma-9b-smoke", "rwkv6-3b-smoke"
STATE = {"h", "conv", "S", "x_tmix", "x_cmix"}


@pytest.fixture(scope="module")
def models():
    """arch -> (the reference's bundle, its jitted prefill and decode, its
    params at key 0 as numpy, the port's bundle and params)."""
    fp32_numerics()
    cache = {}

    def get(arch):
        if arch not in cache:
            mj = jax_build(jax_get_config(arch))
            params = jax.tree.map(np.asarray,
                                  mj.init_params(jax.random.PRNGKey(0)))
            cache[arch] = (mj, jax.jit(mj.prefill,
                                       static_argnames=("cache_len",)),
                           jax.jit(mj.decode), params,
                           build_model(get_config(arch)), from_numpy(params))
        return cache[arch]
    return get


def _prompts(B, S, seed):
    return np.random.default_rng(seed).integers(0, 277, (B, S)).astype(
        np.int32)


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               want.astype(np.float32), rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _check_cache(got, want, tol):
    """The port's cache against the reference's (``cache_from_numpy``):
    recurrent leaves within ``tol``, KV leaves at the valid positions,
    ``pos`` and ``t`` exactly."""
    want = cache_from_numpy(jax.tree.map(np.asarray, want))
    for part in ("groups", "tail"):
        assert len(got[part]) == len(want[part])
        for eg, ew in zip(got[part], want[part]):
            assert set(eg) == set(ew)
            for name, w in ew.items():
                g = eg[name]
                if name in STATE:
                    _close(g.float().numpy(), w.float().numpy(), tol)
                elif name in ("pos", "t"):
                    np.testing.assert_array_equal(g.numpy(), w.numpy())
                else:
                    pos = eg["pos"]
                    keep = (pos >= 0)[..., None, None].expand_as(g)
                    _close(g[keep].numpy(), w[keep].numpy(), tol)


def _steps(models, arch, prompts, lens, new, tol, ref_prompts=None):
    """The port's prefill (``prompt_lens`` when ``lens``) and ``new``
    greedy decode steps against the reference's prefill of
    ``ref_prompts`` (default the same) and its decode: logits and caches
    at every step, tokens equal."""
    mj, pre_j, dec_j, params, mt, pt = models(arch)
    ref_prompts = prompts if ref_prompts is None else ref_prompts
    cache_len = prompts.shape[1] + new
    lj, cj = pre_j(params, {"tokens": jnp.asarray(ref_prompts)},
                   cache_len=ref_prompts.shape[1] + new)
    kw = {} if lens is None else {
        "prompt_lens": torch.tensor(lens, dtype=torch.int32)}
    with torch.no_grad():
        lt, ct = mt.prefill(pt, {"tokens": torch.from_numpy(prompts)},
                            cache_len=cache_len, **kw)
    _close(lt.numpy(), lj, tol)
    _check_recurrent(ct, cj, tol)
    for step in range(new):
        tj = jnp.argmax(lj, -1).astype(jnp.int32)
        tt = torch.argmax(lt, -1).to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj),
                                      err_msg=str(step))
        lj, cj = dec_j(params, cj, tj)
        with torch.no_grad():
            lt, ct = mt.decode(pt, ct, tt)
        _close(lt.numpy(), lj, tol)
    _check_recurrent(ct, cj, tol)
    return ct, cj


def _check_recurrent(got, want, tol):
    """Only the recurrent leaves (a padded prefill's KV ring holds its
    pads where the unpadded reference's holds nothing)."""
    want = cache_from_numpy(jax.tree.map(np.asarray, want))
    for part in ("groups", "tail"):
        for eg, ew in zip(got[part], want[part]):
            for name in set(eg) & STATE:
                _close(eg[name].float().numpy(), ew[name].float().numpy(),
                       tol)


@pytest.mark.parametrize("arch,B,S", [(RG, 2, 10), (RG, 1, 24),
                                      (RWKV, 2, 10), (RWKV, 1, 128)],
                         ids=["rg-b2", "rg-s24", "rwkv-b2", "rwkv-s128"])
def test_prefill_and_decode_match_reference(models, arch, B, S):
    prompts = _prompts(B, S, seed=S + B)
    tol = 1e-4 if S >= 128 else 1e-5
    ct, cj = _steps(models, arch, prompts, None, 6, tol)
    _check_cache(ct, cj, tol)


def test_band_prompt_of_2048_matches_reference(models):
    """A 2,048-token ``recurrentgemma`` prompt: the local layers take the
    band (S > window + 1024), the rec layers the log-depth scan; logits
    and cache, then 3 decode steps."""
    ct, cj = _steps(models, RG, _prompts(1, 2048, seed=5), None, 3, 1e-4)
    _check_cache(ct, cj, 1e-4)


@pytest.mark.parametrize("arch,S,L", [(RG, 16, 11), (RG, 16, 4),
                                      (RWKV, 16, 11), (RWKV, 128, 100)],
                         ids=["rg-16-11", "rg-16-4", "rwkv-16", "rwkv-128"])
def test_padded_prefill_matches_unpadded_reference(models, arch, S, L):
    """S10: the port's prefill of an L-token prompt right-padded to S
    (``prompt_lens``) gives the reference's unpadded prefill of the L
    tokens: the last-token logits, every recurrent leaf (state at the
    prompt's length: the RG-LRU's h through a = 1 and the conv's inputs
    ending at L; RWKV6's WKV state through k = 0 and a decay of 1, in
    the chunked algebra at S 128, and its shift rows at L - 1), and 5
    decode steps after it.  ``recurrentgemma`` stays within its window of
    16: a longer bucket would push live keys out of the local layers'
    ring (S7), which is why the slot engine gives windowed models exact
    lengths."""
    prompts = _prompts(1, S, seed=S + L)
    _steps(models, arch, prompts, [L], 5, 1e-4 if S >= 128 else 1e-5,
           ref_prompts=prompts[:, :L])


@pytest.mark.parametrize("arch", [RG, RWKV])
def test_reference_padded_prefill_differs(models, arch):
    """The reference's own bucketed prefill runs its recurrences over the
    pads (S10): its next decode step's logits sit far from its unpadded
    prefill's (0.36 on recurrentgemma, 3.0 on rwkv6 at PRNGKey(0)), where
    the port's sit within 1e-5 of them."""
    mj, pre_j, dec_j, params, mt, pt = models(arch)
    prompts = _prompts(1, 16, seed=1)
    lj, cj = pre_j(params, {"tokens": jnp.asarray(prompts[:, :11])},
                   cache_len=24)
    lp, cp = pre_j(params, {"tokens": jnp.asarray(prompts)}, cache_len=24,
                   prompt_lens=jnp.asarray([11], jnp.int32))
    np.testing.assert_allclose(np.asarray(lp), np.asarray(lj), atol=1e-5)
    tok = jnp.argmax(lj, -1).astype(jnp.int32)
    want = np.asarray(dec_j(params, cj, tok)[0])
    ref_padded = np.asarray(dec_j(params, cp, tok)[0])
    with torch.no_grad():
        _, ct = mt.prefill(pt, {"tokens": torch.from_numpy(prompts)},
                           cache_len=24,
                           prompt_lens=torch.tensor([11], dtype=torch.int32))
        got = mt.decode(pt, ct, torch.from_numpy(np.array(tok)))[0]
    assert np.abs(ref_padded - want).max() > 0.1
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("arch", [RG, RWKV])
def test_generate_matches_reference(models, arch):
    mj, _, _, params, mt, pt = models(arch)
    prompts = _prompts(3, 12, seed=9)
    free, _ = jeng.generate(mj, params, jnp.asarray(prompts), 8)
    eos = int(np.asarray(free)[1, 3])
    tj, sj = jeng.generate(mj, params, jnp.asarray(prompts), 8, eos_id=eos,
                           sync_every=4)
    tt, st = generate(mt, pt, torch.from_numpy(prompts), 8, eos_id=eos,
                      sync_every=4)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    for f in ("prompt_tokens", "prefill_tokens", "decode_tokens",
              "decode_steps"):
        assert getattr(st, f) == getattr(sj, f), f


@pytest.mark.parametrize("arch", [RG, RWKV])
def test_slot_engine_matches_reference_generate(models, arch):
    """Requests of 3-21 tokens (not powers of two) over 2 slots, the
    third admitted when a slot frees: each completion equal to the
    reference's ``generate`` on its prompt alone."""
    mj, _, _, params, mt, pt = models(arch)
    rng = np.random.default_rng(4)
    toks = [rng.integers(0, 277, (int(n),)).astype(np.int32)
            for n in (3, 13, 21)]
    eng = SlotEngine(mt, pt, n_slots=2, max_new_tokens=6, max_prompt_len=24)
    got = {c.uid: list(c.tokens) for c in eng.run(
        [Request(uid=i, inputs={"tokens": t}, max_new_tokens=6)
         for i, t in enumerate(toks)])}
    assert eng.exact_lengths == (arch == RG)
    for i, t in enumerate(toks):
        want, _ = jeng.generate(mj, params, jnp.asarray(t[None]), 6)
        assert got[i] == np.asarray(want)[0].tolist(), i


@pytest.mark.parametrize("arch", [RG, RWKV])
def test_decode_keeps_dead_rows_and_dtypes(models, arch):
    """RG5 and the in-place decode: ``init_cache`` gives fp32 state; a
    bf16 prefill's shift rows are bf16 and its state fp32; the fp32 pool
    takes a bf16 row exactly; a decode with one row not live leaves that
    row's every leaf bit-exact and writes the live row's update in the
    entry's dtype."""
    cfg = dataclasses.replace(get_config(arch), compute_dtype="bfloat16")
    mt = build_model(cfg)
    pt = mt.init_params(torch.Generator().manual_seed(0),
                        torch.device("cpu"), dtype=torch.bfloat16)
    pool = mt.init_cache(2, 24)
    for leaf in (l for e in pool["groups"] + pool["tail"]
                 for k, l in e.items() if k in STATE):
        assert leaf.dtype == torch.float32
    with torch.no_grad():
        logits, c1 = mt.prefill(pt, {"tokens": torch.from_numpy(
            _prompts(1, 12, seed=2))}, cache_len=24)
    for e in c1["groups"] + c1["tail"]:
        for k in set(e) & STATE:
            want = (torch.bfloat16 if k.startswith("x_")
                    else torch.float32)
            assert e[k].dtype == want, k
    tree_map(lambda p, l: p.__setitem__(1, l[0]), pool, c1)
    for e1, ep in zip(c1["groups"] + c1["tail"],
                      pool["groups"] + pool["tail"]):
        for k in set(e1) & STATE:
            assert torch.equal(ep[k][1], e1[k][0].float()), k
    before = tree_map(lambda l: l.clone(), pool)
    live = torch.tensor([False, True])
    tok = torch.argmax(logits, -1).to(torch.int32).expand(2).contiguous()
    with torch.no_grad():
        mt.decode(pt, pool, tok, live=live)
    moved = False
    for a, b in zip(tree_leaves(before), tree_leaves(pool)):
        assert a.dtype == b.dtype and torch.equal(a[0], b[0])
        moved |= not torch.equal(a[1], b[1])
    assert moved


@pytest.mark.parametrize("arch", [RG, RWKV])
def test_launcher_serves_both_engines(capsys, arch):
    launch.main(["--arch", arch, "--batch", "2", "--prompt-len", "10",
                 "--new", "4", "--device", "cpu"])
    launch.main(["--arch", arch, "--engine", "slots", "--requests", "4",
                 "--n-slots", "2", "--prompt-len", "12", "--new", "4",
                 "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"{arch}: (2, 4) tokens — prefill ")
    assert out[1].startswith(f"{arch}: 4 requests / 2 slots — ")
