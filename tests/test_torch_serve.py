"""PyTorch port, the serving path against the JAX reference on the CPU,
with the reference's params converted through numpy:

- ``starcoder2-3b-smoke`` (window 16): prefill last-token logits and
  every cache leaf against the reference's ``prefill`` (fp32 1e-5) at
  prompts of 10 (ring not full), 17 (the ring wraps: ROADMAP S5) and
  2048 (the band branch), and with a right-padded bucket;
- greedy ``generate`` token for token (and its stats) against the
  reference's, with eos and ``sync_every``, including a 2048-token
  prompt through the band;
- ``SlotEngine.run`` completions equal to the reference ``SlotEngine``
  on the requests of ``tests/test_serve_engine.py`` and on a 2048-token
  request;
- the port's counterparts of that file's contracts: first-token eos,
  live-token accounting, k-step sync, determinism, sampling, budgets,
  the bounded queue and the deadlines;
- ``rnnt-crdnn-smoke``: the streaming slot engine token for token
  against the reference's ``rnnt_greedy_reference``, and the port's own
  ``rnnt_greedy_reference`` against it;
- the launcher's summary lines for the one-shot and slot engines and an
  RNN-T arch.
"""
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
from repro_torch.convert import from_numpy  # noqa: E402
from repro_torch.kernels.backend import fp32_numerics  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import rnnt as rnnt_mod  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.serve.engine import (Request, SlotEngine,  # noqa: E402
                                      generate, rnnt_greedy_reference)

ARCH = "starcoder2-3b-smoke"


@pytest.fixture(scope="module")
def lm():
    fp32_numerics()
    mj = jax_build(jax_get_config(ARCH))
    params = jax.tree.map(np.asarray, mj.init_params(jax.random.PRNGKey(0)))
    return mj, params, build_model(get_config(ARCH)), from_numpy(params)


@pytest.fixture(scope="module")
def rnnt():
    mj = jax_build(jax_get_config("rnnt-crdnn-smoke"))
    params = jax.tree.map(np.asarray, mj.init_params(jax.random.PRNGKey(0)))
    return (mj, params, build_model(get_config("rnnt-crdnn-smoke")),
            from_numpy(params))


def _prompts(B, S, seed, vocab=277):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _trim(row, eos):
    row = [int(t) for t in row]
    return row[: row.index(eos) + 1] if eos in row else row


def _check_cache(got, want, B):
    """Port cache leaves (batch first, per-row t) against the
    reference's (layer axis first in a group, t one scalar a layer)."""
    for pos, gw in enumerate(want["groups"]):
        for name, w in gw.items():
            g = got["groups"][pos][name].numpy()
            w = np.asarray(w)
            if name == "t":
                assert (g == w[None, :]).all(), (pos, g, w)
                continue
            g = np.moveaxis(g, 1, 0)
            assert g.shape == w.shape, (name, g.shape, w.shape)
            if name == "pos":
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
    assert len(got["tail"]) == len(want["tail"]) == 0


@pytest.mark.parametrize("S", [10, 17, 2048])
def test_prefill_logits_and_cache_match_reference(lm, S):
    mj, params, mt, pt = lm
    prompts = _prompts(2 if S < 100 else 1, S, seed=S)
    lj, cj = mj.prefill(params, {"tokens": jnp.asarray(prompts)},
                        cache_len=S + 4)
    with torch.no_grad():
        lt, ct = mt.prefill(pt, {"tokens": torch.from_numpy(prompts)},
                            cache_len=S + 4)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5,
                               rtol=1e-5)
    _check_cache(ct, cj, prompts.shape[0])


def test_bucketed_prefill_matches_reference(lm):
    """A 13-token prompt right-padded to a bucket of 16 (pads at position
    -1), at batch 1 as the slot engine prefills it."""
    mj, params, mt, pt = lm
    prompts = _prompts(1, 16, seed=3)
    lens = np.asarray([13], np.int32)
    lj, cj = mj.prefill(params, {"tokens": jnp.asarray(prompts)},
                        cache_len=24, prompt_lens=jnp.asarray(lens))
    with torch.no_grad():
        lt, ct = mt.prefill(pt, {"tokens": torch.from_numpy(prompts)},
                            cache_len=24,
                            prompt_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5,
                               rtol=1e-5)
    _check_cache(ct, cj, 1)


@pytest.mark.parametrize("B,S,new,eos,sync", [
    (3, 10, 8, None, 8), (3, 10, 8, "mid", 1), (3, 10, 8, "mid", 4),
    (1, 2048, 6, None, 8)], ids=["free", "eos-sync1", "eos-sync4", "band"])
def test_generate_matches_reference(lm, B, S, new, eos, sync):
    mj, params, mt, pt = lm
    prompts = _prompts(B, S, seed=11)
    if eos == "mid":
        free, _ = jeng.generate(mj, params, jnp.asarray(prompts), new)
        eos = int(np.asarray(free)[1, 3])
    tj, sj = jeng.generate(mj, params, jnp.asarray(prompts), new, eos_id=eos,
                           sync_every=sync)
    tt, st = generate(mt, pt, torch.from_numpy(prompts), new, eos_id=eos,
                      sync_every=sync)
    assert tt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    for f in ("prompt_tokens", "prefill_tokens", "decode_tokens",
              "decode_steps"):
        assert getattr(st, f) == getattr(sj, f), f


def _lm_requests(lens, seed, max_new, vocab=277):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, inputs={"tokens": rng.integers(
                0, vocab, (L,)).astype(np.int32)}, max_new_tokens=max_new)
            for i, L in enumerate(lens)]


@pytest.mark.parametrize("lens,n_slots,max_prompt,eos", [
    ([5, 9, 12, 17, 7, 3], 2, 24, 7),
    ([2048, 6, 11], 2, 2048, None)], ids=["serve-engine-requests", "band"])
def test_slot_engine_matches_reference(lm, lens, n_slots, max_prompt, eos):
    """More requests than slots, mixed prompt lengths, eos terminations
    (the reference's parity workload), and a 2048-token request through
    the band: every completion equals the reference engine's."""
    mj, params, mt, pt = lm
    reqs = _lm_requests(lens, seed=0, max_new=10)
    kw = dict(n_slots=n_slots, max_new_tokens=10, max_prompt_len=max_prompt,
              eos_id=eos, sync_every=4)
    want = {c.uid: c.tokens for c in
            jeng.SlotEngine(mj, params, **kw).run(
                [jeng.Request(r.uid, r.inputs, r.max_new_tokens)
                 for r in reqs])}
    eng = SlotEngine(mt, pt, **kw)
    comps = eng.run(reqs)
    assert eng.n_admits == len(reqs)
    assert all(c.status == "ok" for c in comps)
    assert {c.uid: c.tokens for c in comps} == want


def test_slot_engine_matches_oneshot_generate(lm):
    """The reference file's own oracle, on the port: each completion is
    the one-shot greedy decode of its prompt, trimmed at eos."""
    _, _, mt, pt = lm
    reqs = _lm_requests([5, 9, 12, 17, 7, 3], seed=0, max_new=10)
    eng = SlotEngine(mt, pt, n_slots=2, max_new_tokens=10, max_prompt_len=24,
                     eos_id=7, sync_every=4)
    got = {c.uid: c.tokens for c in eng.run(reqs)}
    for r in reqs:
        toks, _ = generate(mt, pt, torch.from_numpy(r.inputs["tokens"])[None],
                           10, eos_id=7, sync_every=1)
        assert got[r.uid] == _trim(toks.numpy()[0], 7), r.uid


# ---------------------------------------------------------------------------
# the port's counterparts of tests/test_serve_engine.py's contracts
# ---------------------------------------------------------------------------

def test_first_token_eos_stops_decode(lm):
    _, _, mt, pt = lm
    prompts = torch.from_numpy(_prompts(2, 10, seed=1))
    free, _ = generate(mt, pt, prompts, 6)
    eos = int(free[0, 0])
    toks, stats = generate(mt, pt, prompts[:1], 6, eos_id=eos)
    assert stats.decode_steps == 0 and stats.decode_tokens == 0
    assert toks.shape == (1, 1) and int(toks[0, 0]) == eos


def test_stats_count_live_decode_tokens_only(lm):
    _, _, mt, pt = lm
    B, new = 3, 7
    prompts = torch.from_numpy(_prompts(B, 10, seed=1))
    toks, stats = generate(mt, pt, prompts, new)
    assert toks.shape == (B, new)
    assert stats.prefill_tokens == B and stats.prompt_tokens == B * 10
    assert stats.decode_tokens == B * (new - 1)
    assert stats.decode_steps == new - 1 and stats.tokens_per_s > 0
    eos = int(toks[0, 2])
    toks_e, stats_e = generate(mt, pt, prompts, new, eos_id=eos,
                               sync_every=1)
    live = sum(len(_trim(row, eos)) - 1 for row in toks_e.numpy())
    assert stats_e.decode_tokens <= live
    assert stats_e.decode_tokens < B * (new - 1)


def test_greedy_determinism_and_temperature_sampling(lm):
    _, _, mt, pt = lm
    prompts = torch.from_numpy(_prompts(3, 10, seed=2))
    a, _ = generate(mt, pt, prompts, 6)
    b, _ = generate(mt, pt, prompts, 6)
    assert torch.equal(a, b)
    toks, _ = generate(mt, pt, prompts[:2], 5, temperature=0.8,
                       generator=torch.Generator().manual_seed(7))
    again, _ = generate(mt, pt, prompts[:2], 5, temperature=0.8,
                        generator=torch.Generator().manual_seed(7))
    assert toks.shape == (2, 5) and toks.dtype == torch.int32
    assert bool((toks >= 0).all()) and bool((toks < 277).all())
    assert torch.equal(toks, again)         # the generator fixes the draws


def test_generate_rejects_rnnt(rnnt):
    _, _, mt, pt = rnnt
    with pytest.raises(ValueError, match="RNN-T"):
        generate(mt, pt, torch.zeros((1, 4), dtype=torch.int32), 4)


def test_slot_engine_respects_budget_and_bounds(lm):
    _, _, mt, pt = lm
    reqs = _lm_requests([6, 6, 6], seed=2, max_new=0)
    for r, b in zip(reqs, [1, 3, 5]):
        r.max_new_tokens = b
    eng = SlotEngine(mt, pt, n_slots=3, max_new_tokens=8, max_prompt_len=16)
    got = {c.uid: c.tokens for c in eng.run(reqs)}
    assert [len(got[i]) for i in range(3)] == [1, 3, 5]
    too_long = Request(uid=9, inputs={"tokens": np.zeros(99, np.int32)},
                       max_new_tokens=4)
    with pytest.raises(ValueError, match="exceeds"):
        eng.run([too_long])


class _StepClock:
    """Every read advances time by ``dt``: deadlines without sleeps."""

    def __init__(self, dt=1.0):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t


def _req(uid, *, rng, max_new=6, deadline=None, L=6):
    return Request(uid=uid, inputs={"tokens": rng.integers(
        0, 277, (L,)).astype(np.int32)}, max_new_tokens=max_new,
        deadline_s=deadline)


def test_bounded_queue_rejects_overflow(lm):
    _, _, mt, pt = lm
    rng = np.random.default_rng(3)
    reqs = [_req(i, rng=rng, max_new=4) for i in range(6)]
    eng = SlotEngine(mt, pt, n_slots=1, max_new_tokens=4, max_prompt_len=16,
                     max_queue=2)
    comps = {c.uid: c for c in eng.run(reqs)}
    rejected = [c for c in comps.values() if c.status == "rejected"]
    served = [c for c in comps.values() if c.status == "ok"]
    assert len(comps) == 6 and eng.n_rejected == len(rejected) == 4
    assert sorted(c.uid for c in served) == [0, 1]
    assert all(c.tokens == [] and np.isnan(c.admit_s) for c in rejected)
    assert all(len(c.tokens) == 4 and np.isfinite(c.admit_s)
               for c in served)
    eng = SlotEngine(mt, pt, n_slots=1, max_new_tokens=2, max_prompt_len=16)
    comps = eng.run([_req(i, rng=rng, max_new=2) for i in range(5)])
    assert eng.n_rejected == 0 and all(c.status == "ok" for c in comps)


def test_queued_deadline_expires_without_taking_a_slot(lm):
    _, _, mt, pt = lm
    rng = np.random.default_rng(5)
    reqs = [_req(0, rng=rng, max_new=32), _req(1, rng=rng, max_new=4,
                                               deadline=3.0),
            _req(2, rng=rng, max_new=4)]
    eng = SlotEngine(mt, pt, n_slots=1, max_new_tokens=32, max_prompt_len=16,
                     clock=_StepClock())
    comps = {c.uid: c for c in eng.run(reqs)}
    assert comps[1].status == "expired" and comps[1].tokens == []
    assert np.isnan(comps[1].admit_s)
    assert comps[0].status == "ok" and len(comps[0].tokens) == 32
    assert comps[2].status == "ok" and len(comps[2].tokens) == 4
    assert eng.n_expired == 1


def test_mid_decode_deadline_evicts_and_frees_the_slot(lm):
    _, _, mt, pt = lm
    rng = np.random.default_rng(6)
    reqs = [_req(0, rng=rng, max_new=64, deadline=40.0),
            _req(1, rng=rng, max_new=3)]
    eng = SlotEngine(mt, pt, n_slots=1, max_new_tokens=64, max_prompt_len=16,
                     sync_every=1, clock=_StepClock())
    comps = {c.uid: c for c in eng.run(reqs)}
    assert comps[0].status == "expired"
    assert 0 < len(comps[0].tokens) < 64 and np.isfinite(comps[0].admit_s)
    assert eng.n_expired == 1 and eng.n_admits == 2
    assert comps[1].status == "ok" and len(comps[1].tokens) == 3


def test_deadline_output_is_a_prefix_of_the_unexpired_run(lm):
    _, _, mt, pt = lm
    prompt = np.random.default_rng(7).integers(0, 277, (6,)).astype(np.int32)

    def run_one(deadline, clock):
        eng = SlotEngine(mt, pt, n_slots=1, max_new_tokens=32,
                         max_prompt_len=16, sync_every=1, clock=clock)
        (c,) = eng.run([Request(uid=0, inputs={"tokens": prompt},
                                max_new_tokens=32, deadline_s=deadline)])
        return c

    full = run_one(None, _StepClock(dt=0.0))
    cut = run_one(30.0, _StepClock())
    assert cut.status == "expired" and full.status == "ok"
    assert 0 < len(cut.tokens) < len(full.tokens)
    assert full.tokens[: len(cut.tokens)] == cut.tokens


def test_dead_slots_are_bit_exact_no_ops(lm):
    """A decode scan leaves every leaf of a slot that is not live as it
    was, while the live slot moves on."""
    _, _, mt, pt = lm
    eng = SlotEngine(mt, pt, n_slots=2, max_new_tokens=8, max_prompt_len=16)
    eng._admit(0, _lm_requests([7], seed=9, max_new=8)[0])
    before = [t.clone() for t in _leaves(eng._state)]
    eng._decode_scan()
    after = _leaves(eng._state)
    assert int(eng._state["n_out"][0]) > int(before[3][0])
    for b, a in zip(before, after):
        assert torch.equal(b[1], a[1])


def test_decode_writes_the_cache_pool_in_place(lm):
    """A decode scan writes the live slots' rows into the one cache pool:
    no leaf of the pool is replaced by a copy (``contracts.assert_in_place``)."""
    from repro_torch.analysis import contracts
    _, _, mt, pt = lm
    eng = SlotEngine(mt, pt, n_slots=2, max_new_tokens=8, max_prompt_len=16)
    eng._admit(0, _lm_requests([7], seed=9, max_new=8)[0])
    pool = contracts.pointers(eng._state["cache"])
    eng._decode_scan()
    assert int(eng._state["n_out"][0]) > 1
    contracts.assert_in_place(pool, eng._state["cache"], "the cache pool")


def _leaves(state):
    from repro_torch.models.common import tree_leaves
    return [state["tok"], state["live"], state["budget"], state["n_out"],
            state["out"]] + tree_leaves(state["cache"])


# ---------------------------------------------------------------------------
# RNN-T streaming decode
# ---------------------------------------------------------------------------

def test_pred_step_matches_predict_and_reference(rnnt):
    mj, params, mt, pt = rnnt
    from repro.models import rnnt as jrnnt
    cfg = get_config("rnnt-crdnn-smoke")
    toks = np.asarray([[3, 9, 1, 14]], np.int32)
    with torch.no_grad():
        want = rnnt_mod.predict(pt, cfg, torch.from_numpy(toks))
        g, h = rnnt_mod.pred_start(pt, cfg, 1)
        rows = [g]
        for u in range(toks.shape[1]):
            g, h = rnnt_mod.pred_step(pt, cfg, torch.from_numpy(toks[:, u]), h)
            rows.append(g)
    # one step's projection is a (1, d) product where predict's is a
    # (U+1, d) one: equal up to fp32 summation order
    torch.testing.assert_close(torch.stack(rows, 1), want, atol=1e-6, rtol=0)
    jg, jh = jrnnt.pred_start(params, jax_get_config("rnnt-crdnn-smoke"), 1)
    np.testing.assert_allclose(rows[0].numpy(), np.asarray(jg), atol=1e-6)


def test_rnnt_streaming_matches_reference(rnnt):
    """The port's slot engine (streaming greedy transducer search) token
    for token against the reference's non-streaming loop on the same
    bucket-padded feats; the port's own loop agrees with both.  A cap of
    4 symbols a frame (the reference test's is 8) keeps the reference's
    eager loop short and makes the forced blank (ROADMAP S8) bite."""
    mj, params, mt, pt = rnnt
    F = get_config("rnnt-crdnn-smoke").rnnt.n_feats
    rng = np.random.default_rng(1)
    reqs = [Request(uid=i, inputs={"feats": rng.normal(
                size=(L, F)).astype(np.float32)}, max_new_tokens=128)
            for i, L in enumerate([28, 13, 31, 20])]
    eng = SlotEngine(mt, pt, n_slots=2, max_new_tokens=128, max_prompt_len=64,
                     sync_every=4, max_symbols=4)
    got = {c.uid: c.tokens for c in eng.run(reqs)}
    for r in reqs:
        L = r.inputs["feats"].shape[0]
        feats = np.zeros((1, eng.bucket_for(r), F), np.float32)
        feats[0, :L] = r.inputs["feats"]
        want = jeng.rnnt_greedy_reference(mj, params, feats, np.asarray([L]),
                                          max_symbols=4)[0]
        mine = rnnt_greedy_reference(mt, pt, feats, np.asarray([L]),
                                     max_symbols=4)[0]
        assert got[r.uid] == want == mine, r.uid


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv,start", [
    (["--arch", ARCH, "--engine", "slots", "--requests", "8", "--n-slots",
      "3", "--new", "12"], "requests / 3 slots"),
    (["--arch", ARCH, "--batch", "2", "--prompt-len", "8", "--new", "6"],
     "(2, 6) tokens"),
    (["--arch", "rnnt-crdnn-smoke", "--requests", "6", "--prompt-len", "48",
      "--new", "32"], "requests / 4 slots")], ids=["slots", "oneshot", "rnnt"])
def test_launcher_prints_the_reference_summary(capsys, argv, start):
    launch.main(argv + ["--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    name = argv[1]
    assert line.startswith(f"{name}: ") and start in line
    assert ("req/s" in line and "p50 latency" in line) or "tok/s" in line
