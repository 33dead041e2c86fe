"""PyTorch port, the algebra of the Hopper kernels' designs, emulated on
the CPU in plain torch and held against the JAX reference on the same
inputs made with numpy from a seed:

- the RWKV6 WKV forward's three phases (each chunk's own state increment
  and total decay, the ordered scan over chunks, each chunk's output
  with its pairwise decays factorised over sub-chunks of 16 tokens in
  the kernel's task order, ``ops.subchunk_plan``) against the
  reference's sequential ``models/rwkv6.py:wkv_scan`` and its chunk
  algebra ``wkv_chunked``: y and the final state within 1e-5 of their
  largest entries (the parity bar of ``tests/test_torch_rwkv.py``), at
  chunks of 16, 32 and 64, decays in (0.4, 0.99), all 1e-6, and mixed
  by channel (below the 1e-8 clip, at 0.999, in (0.4, 0.99)),
  everything finite; at C = 64 under strong decays the reference's
  chunk algebra is itself 2-6e-5 off a float64 scan, and the design's
  algebra within 1e-6 of it;
- the grad sketch's 3xTF32 split (TF32 rounding, round to nearest with
  ties away, emulated by bit masking; hi.hi + hi.lo + lo.hi, lo.lo
  dropped) with the kernel's vocab tiles, online softmax, one partial a
  vocab split and the merge in split order, against the reference's
  ``kernels/grad_sketch/ref.py:grad_sketch_ref``: within 1e-4 of the
  largest entry of the sketch and of its vocab part (the bars of the
  card tests);
- the shape-only plans: the vocab split, the WKV forward's block grid
  and its sub-chunk plan each cover every tile or pair once.

The kernels themselves are held against the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.grad_sketch.ref import grad_sketch_ref as jax_sketch  # noqa: E402
from repro.models import rwkv6 as jax_rwkv  # noqa: E402
from repro_torch.kernels.grad_sketch import ops as gs_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import (  # noqa: E402
    log_decay, wkv_scan)

NEG = -1e30


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


# ---------------------------------------------------------------------------
# WKV forward: phases (a), (b), (c) with the sub-chunk factorisation
# ---------------------------------------------------------------------------

def _decays(rng, shape, kind):
    ww = rng.uniform(0.4, 0.99, shape)
    if kind == "mixed":
        n = np.arange(shape[-1]) % 3
        ww = np.where(n == 0, 1e-9, np.where(n == 1, 0.999, ww))
    elif kind != "uniform":
        ww = np.full(shape, kind)
    return ww.astype(np.float32)


def wkv_phases(r, k, v, lw, u, C):
    """The forward kernels' algebra in fp32: (a) dS_c = (k e^{tot - cum})^T
    v and tot per chunk; (b) S_0 = 0, S_{c+1} = e^{tot_c} S_c + dS_c; (c)
    y = (r e^{cp}) S_c + A v + (r . u k) v, with A's diagonal sub-blocks
    exact and its off-diagonal ones through each sub-chunk's last token,
    entries filled in ``subchunk_plan`` order -> (y, final state)."""
    B, S, H, N = r.shape
    nC = S // C

    def chunks(t):                                   # -> (B, H, nC, C, N)
        return t.reshape(B, nC, C, H, N).permute(0, 3, 1, 2, 4)

    rc, kc, vc, cum = chunks(r), chunks(k), chunks(v), chunks(lw).cumsum(3)
    zero = torch.zeros((), dtype=torch.float32)
    # (a)
    tot = cum[..., -1, :]
    k_dec = kc * torch.exp(tot[..., None, :] - cum)
    dS = torch.einsum("bhcjn,bhcjm->bhcnm", k_dec, vc)
    # (b)
    state = torch.zeros((B, H, N, N))
    starts = []
    for c in range(nC):
        starts.append(state)
        state = torch.exp(tot[:, :, c])[..., :, None] * state + dS[:, :, c]
    starts = torch.stack(starts, dim=2)              # (B, H, nC, N, N)
    # (c)
    cp = torch.cat([torch.zeros_like(cum[..., :1, :]), cum[..., :-1, :]], 3)
    pairs, tasks = wkv_ops.subchunk_plan(C)
    A = torch.zeros((B, H, nC, C, C))
    if pairs:
        i, j = (torch.tensor(x) for x in zip(*pairs))
        A[..., i, j] = (rc[..., i, :] * kc[..., j, :] * torch.exp(
            torch.minimum(cp[..., i, :] - cum[..., j, :], zero))).sum(-1)
    if tasks:
        last = (torch.arange(C) // wkv_ops.SUB) * wkv_ops.SUB \
            + wkv_ops.SUB - 1
        last = last.clamp(max=C - 1)
        k_til = kc * torch.exp(torch.minimum(cum[..., last, :] - cum, zero))
        for i, J, half in tasks:
            b = J * wkv_ops.SUB + wkv_ops.SUB - 1
            cols = J * wkv_ops.SUB + 8 * half + torch.arange(8)
            x = rc[..., i, :] * torch.exp(
                torch.minimum(cp[..., i, :] - cum[..., b, :], zero))
            A[..., i, cols] = torch.einsum("bhcn,bhcjn->bhcj", x,
                                           k_til[..., cols, :])
    dg = (rc * kc * u[None, :, None, None, :]).sum(-1)
    y = (torch.einsum("bhcin,bhcnm->bhcim", rc * torch.exp(cp), starts)
         + A @ vc) + dg[..., None] * vc
    return y.permute(0, 2, 3, 1, 4).reshape(B, S, H, N), state


def _wkv_case(B, S, H, N, decay):
    rng = np.random.default_rng(S + N)
    r, k, v = (rng.normal(size=(B, S, H, N)).astype(np.float32)
               for _ in range(3))
    w = _decays(rng, (B, S, H, N), decay)
    u = (rng.normal(size=(H, N)) * 0.1).astype(np.float32)
    return r, k, v, w, u, np.zeros((B, H, N, N), np.float32)


@pytest.mark.parametrize("decay", ["uniform", 1e-6, "mixed"])
@pytest.mark.parametrize("B,S,H,N,C", [(2, 64, 2, 16, 16),
                                       (1, 128, 3, 32, 32),
                                       (1, 192, 2, 64, 64)])
def test_wkv_subchunk_phases_match_reference(B, S, H, N, C, decay):
    """Against the reference's sequential oracle ``wkv_scan`` (on the
    clipped decays) in every case, and against its chunk algebra
    ``wkv_chunked`` wherever that is itself within 1e-5 of the oracle:
    not at C = 64 under strong decays (the next test)."""
    r, k, v, w, u, s0 = _wkv_case(B, S, H, N, decay)
    y_q, s_q = jax_rwkv.wkv_scan(r, k, v, np.clip(w, 1e-8, 1.0), u, s0)
    y_j, s_j = jax_rwkv.wkv_chunked(r, k, v, w, u, s0, chunk=C)
    tr, tk, tv, tw, tu = map(torch.from_numpy, (r, k, v, w, u))
    y, s = wkv_phases(tr, tk, tv, log_decay(tw), tu, C)
    _close(y.numpy(), y_q, 1e-5)
    _close(s.numpy(), s_q, 1e-5)
    if C < 64 or decay == "uniform":
        _close(y.numpy(), y_j, 1e-5)
        _close(s.numpy(), s_j, 1e-5)


@pytest.mark.parametrize("decay", [1e-6, "mixed"])
def test_wkv_subchunk_phases_beat_the_reference_chunks_at_strong_decays(
        decay):
    """At C = 64 under strong decays (lw down to -18.4 a token, |cum| up
    to ~1,180 in a chunk) the reference's chunk algebra takes cp = cum -
    lw, which is some ulp of 1,000 off cum_{i-1}, so its j = i - 1 decay,
    exactly 1, comes out a few 1e-5 off, and y sits 2-6e-5 of its largest
    entry off a float64 sequential scan.  The kernels' algebra takes cp_i
    = cum_{i-1} and stays within 1e-6 of it."""
    B, S, H, N, C = 1, 192, 2, 64, 64
    r, k, v, w, u, s0 = _wkv_case(B, S, H, N, decay)
    y_j, _ = jax_rwkv.wkv_chunked(r, k, v, w, u, s0, chunk=C)
    tr, tk, tv, tw, tu = map(torch.from_numpy, (r, k, v, w, u))
    y, _ = wkv_phases(tr, tk, tv, log_decay(tw), tu, C)
    f64 = [torch.from_numpy(a).double() for a in (r, k, v, w, u, s0)]
    f64[3] = f64[3].clamp(1e-8, 1.0)
    y64 = wkv_scan(*f64)[0].numpy()
    scale = np.abs(y64).max()
    emul = np.abs(y.numpy() - y64).max() / scale
    ref = np.abs(np.asarray(y_j) - y64).max() / scale
    assert emul <= 1e-6 < 1e-5 < ref


@pytest.mark.parametrize("C", [1, 8, 16, 17, 32, 48, 63, 64])
def test_wkv_subchunk_plan_covers_every_pair_once(C):
    pairs, tasks = wkv_ops.subchunk_plan(C)
    got = list(pairs)
    for i, J, half in tasks:
        j0 = J * wkv_ops.SUB + 8 * half
        assert j0 + 8 <= (J + 1) * wkv_ops.SUB   # within sub-chunk J
        assert J < i // wkv_ops.SUB     # an earlier, hence full, sub-chunk
        got += [(i, j0 + jj) for jj in range(8)]
    assert sorted(got) == [(i, j) for i in range(C) for j in range(i)]
    assert len(got) == C * (C - 1) // 2


@pytest.mark.parametrize("B,S,H,N,C", [(4, 512, 40, 64, 64),
                                       (2, 96, 1, 8, 32), (3, 64, 5, 16, 16)])
def test_wkv_grid_covers_every_chunk_and_state_entry_once(B, S, H, N, C):
    blocks, scan_blocks = wkv_ops.wkv_grid(B, S, H, N, C)
    seen = [wkv_ops.wkv_block(x, H, S // C) for x in range(blocks)]
    assert sorted(seen) == [(b, h, c) for b in range(B) for h in range(H)
                            for c in range(S // C)]
    assert (scan_blocks - 1) * wkv_ops.FWD_THREADS < B * H * N * N \
        <= scan_blocks * wkv_ops.FWD_THREADS


# ---------------------------------------------------------------------------
# grad sketch: 3xTF32, vocab tiles, online softmax, partials merged
# ---------------------------------------------------------------------------

def tf32(x):
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round to nearest with ties
    away from zero (add half of the dropped range to the magnitude bits,
    then clear them)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_3xtf32(a, b):
    ah, al = split(a)
    bh, bl = split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def sketch_3xtf32(h, w, rh, rv, t, s):
    """The kernel's algebra for (U, n, d) units: per vocab split a
    partial (m, s, p R2) over its 128-column tiles, logits and p R2 in
    3xTF32, merged in split order; then hr^T er2."""
    U, n, d = h.shape
    V = w.shape[1]
    S, per = gs_ops.vocab_splits(U, n, V)
    BN = gs_ops.BN
    out = []
    for uu in range(U):
        parts = []
        for q in range(S):
            m = torch.full((n,), NEG)
            ssum = torch.zeros(n)
            e2 = torch.zeros((n, rv.shape[1]))
            for tile in range(q * per, min((q + 1) * per, -(-V // BN))):
                cols = torch.arange(tile * BN, min((tile + 1) * BN, V))
                lg = mm_3xtf32(h[uu], w[:, cols])
                mn = torch.maximum(m, lg.max(dim=1).values)
                alpha = torch.exp(m - mn)
                p = torch.exp(lg - mn[:, None])
                ssum = ssum * alpha + p.sum(dim=1)
                e2 = e2 * alpha[:, None] + mm_3xtf32(p, rv[cols])
                m = mn
            parts.append((m, ssum, e2))
        M = torch.stack([x[0] for x in parts]).max(dim=0).values
        tot = torch.zeros(n)
        acc = torch.zeros_like(parts[0][2])
        for mq, sq, eq in parts:
            wq = torch.exp(mq - M)
            tot = tot + sq * wq
            acc = acc + eq * wq[:, None]
        er2 = (acc / torch.clamp(tot, min=1e-30)[:, None]
               - rv[t[uu].long()]) * s[uu][:, None]
        out.append((h[uu] @ rh).t() @ er2)
    return torch.stack(out)


def test_tf32_emulation_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -12, 3.0e-39])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
                         -(1.0 + 2 ** -10), 1.0, 3.0e-39])
    got = tf32(x)
    assert torch.equal(got.view(torch.int32) & 0x1FFF,
                       torch.zeros(6, dtype=torch.int32))
    assert torch.equal(got[:5], want[:5])
    g = torch.Generator().manual_seed(0)
    y = torch.randn(4096, generator=g) * 100
    hi, lo = split(y)
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("U,n,d,V,k1,k2,wscale", [
    (1, 40, 32, 300, 16, 16, 0.1), (1, 256, 64, 1000, 32, 32, 0.1),
    (3, 130, 72, 1001, 24, 40, 4.0), (2, 300, 128, 1000, 32, 72, 4.0),
    (1, 65, 33, 4099, 64, 100, 4.0)])
def test_3xtf32_sketch_matches_reference(U, n, d, V, k1, k2, wscale):
    """``wscale`` 4.0: logits of std 4 (w scaled by 4/sqrt(d)), a peaked
    softmax whose p.R2 term carries a good part of the sketch, as the
    card tests draw them."""
    rng = np.random.default_rng(n + V)
    h = rng.normal(size=(U, n, d)).astype(np.float32)
    w = rng.normal(size=(d, V)) * (wscale / np.sqrt(d) if wscale > 1
                                   else wscale)
    w = w.astype(np.float32)
    rh = rng.normal(size=(d, k1)).astype(np.float32)
    rv = rng.normal(size=(V, k2)).astype(np.float32)
    t = rng.integers(0, V, (U, n)).astype(np.int32)
    s = rng.uniform(0.5, 1.5, (U, n)).astype(np.float32)
    if U > 1:
        s[1] = 0.0
    want = np.stack([np.asarray(jax_sketch(
        jnp.asarray(h[uu]), jnp.asarray(w), jnp.asarray(rh),
        jnp.asarray(rv), jnp.asarray(t[uu]), jnp.asarray(s[uu])))
        for uu in range(U)])
    got = sketch_3xtf32(*map(torch.from_numpy, (h, w, rh, rv, t, s)))
    got = got.numpy()
    vocab = want + np.einsum("unk,unl->ukl", h @ rh,
                             rv[t] * s[..., None])
    err = np.abs(got - want).max()
    assert np.isfinite(got).all()
    assert err <= 1e-4 * np.abs(want).max()
    assert err <= 1e-4 * np.abs(vocab).max()
    if U > 1:
        assert not got[1].any()
