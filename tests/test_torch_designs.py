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
- the WKV backward's three phases (each chunk's increment r_dec^T dy of
  the state gradient, the ordered reverse scan over chunks, each
  chunk's gradients from its start state and the gradient after it),
  with cp = cum_{i-1}, the sub-chunk factorisation and the 64-wide
  products in 3xTF32, against ``jax.grad`` of the reference's
  sequential ``wkv_scan`` at 1e-5 of each leaf's largest entry (dlw at
  strong decays at 1e-5 of the largest dr entry, as the card tests hold
  the kernel), and at C = 64 under strong decays against float64
  autograd of the port's ``wkv_scan``, beside the plain chunk algebra's
  fp32 autograd;
- the RNN-T lattice's order (lane l owns q = ceil(U1 / 32) consecutive
  columns: a sequential combine over them, one shuffle scan of the
  lanes' aggregates, a fix-up) against the reference's Pallas kernel in
  interpret mode and its ``ref.py``, at the card tests' bars;
- the shape-only plans: the vocab split, the WKV forward's and
  backward's block grids, the forward's sub-chunk plan, the backward
  block's shared memory, the lattice's lane columns and ring depth.

The kernels themselves are held against the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.grad_sketch.ref import grad_sketch_ref as jax_sketch  # noqa: E402
from repro.models import rwkv6 as jax_rwkv  # noqa: E402
from repro_torch.kernels.grad_sketch import ops as gs_ops  # noqa: E402
from repro_torch.kernels.rnnt_lattice import ops as lat_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import (  # noqa: E402
    log_decay, wkv_chunked_lw, wkv_scan)

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
# WKV backward: phases (a), (b), (c), 3xTF32 products, sub-chunk factors
# ---------------------------------------------------------------------------

def wkv_bwd_phases(r, k, v, lw, u, dy, ds, C):
    """The backward kernels' algebra in fp32, the gradient of the forward
    of ``wkv_phases`` (cp_i = cum_{i-1}): (a) inc_c = (r e^{cp})^T dy and
    tot_c; (b) D_{nC-1} = ds, D_{c-1} = e^{tot_c} D_c + inc_c; (c) from the
    forward's chunk-start states and D_c: the 64-wide products dy S^T, v
    D^T, k_dec D, dy v^T, A^T dy and r_dec^T dy in 3xTF32 (``mm_3xtf32``),
    A with its diagonal sub-blocks exact and its off-diagonal ones through
    k~ = k e^{cum_b - cum} (b the last token of j's sub-chunk), pv through
    the same k~, qv through r^ = r e^{cp - cp_a} (a the first token of i's
    sub-chunk), dlw by sums over each sub-chunk's rows and then over the
    sub-chunks -> (dr, dk, dv, dlw, du)."""
    B, S, H, N = r.shape
    nC, SUB = S // C, wkv_ops.SUB
    nsub = -(-C // SUB)

    def chunks(t):                                   # -> (B, H, nC, C, N)
        return t.reshape(B, nC, C, H, N).permute(0, 3, 1, 2, 4)

    rc, kc, vc, yc = chunks(r), chunks(k), chunks(v), chunks(dy)
    cum = chunks(lw).cumsum(3)
    zero = torch.zeros((), dtype=torch.float32)

    def ex(x):
        return torch.exp(torch.minimum(x, zero))

    cp = torch.cat([torch.zeros_like(cum[..., :1, :]), cum[..., :-1, :]], 3)
    tot = cum[..., -1, :]
    # the forward's chunk-start states (its phases (a) and (b))
    k_dec = kc * ex(tot[..., None, :] - cum)
    inc_f = k_dec.transpose(-1, -2) @ vc
    state = torch.zeros((B, H, N, N))
    starts = []
    for c in range(nC):
        starts.append(state)
        state = torch.exp(tot[:, :, c])[..., :, None] * state + inc_f[:, :, c]
    starts = torch.stack(starts, dim=2)              # (B, H, nC, N, N)
    # (a) and (b)
    inc = mm_3xtf32((rc * ex(cp)).transpose(-1, -2), yc)
    D, cur = [None] * nC, ds
    for c in reversed(range(nC)):
        D[c] = cur
        cur = torch.exp(tot[:, :, c])[..., :, None] * cur + inc[:, :, c]
    D = torch.stack(D, dim=2)
    # (c)
    dr_dec = mm_3xtf32(yc, starts.transpose(-1, -2))
    dk_dec = mm_3xtf32(vc, D.transpose(-1, -2))
    lower = torch.tril(torch.ones((C, C), dtype=torch.bool), diagonal=-1)
    dA = torch.where(lower, mm_3xtf32(yc, vc.transpose(-1, -2)), zero)
    ddg = (yc * vc).sum(-1)
    dg = (rc * (kc * u[None, :, None, None, :])).sum(-1)
    pairs, tasks = wkv_ops.subchunk_plan(C)
    A = torch.zeros((B, H, nC, C, C))
    if pairs:
        i, j = (torch.tensor(x) for x in zip(*pairs))
        A[..., i, j] = (rc[..., i, :] * kc[..., j, :]
                        * ex(cp[..., i, :] - cum[..., j, :])).sum(-1)
    last = ((torch.arange(C) // SUB) * SUB + SUB - 1).clamp(max=C - 1)
    k_til = kc * ex(cum[..., last, :] - cum)
    for i, J, half in tasks:
        b = J * SUB + SUB - 1
        cols = J * SUB + 8 * half + torch.arange(8)
        x = rc[..., i, :] * ex(cp[..., i, :] - cum[..., b, :])
        A[..., i, cols] = torch.einsum("bhcn,bhcjn->bhcj", x,
                                       k_til[..., cols, :])
    dv = (mm_3xtf32(k_dec, D) + mm_3xtf32(A.transpose(-1, -2), yc)) \
        + dg[..., None] * yc
    # pv and qv: exact within a sub-chunk, factorised across sub-chunks;
    # the j = i - 1 terms apart (t and s): their decay is exactly 1 for
    # any lw, so they reach dr and dk but not the log-decays
    idx = torch.arange(C)
    sub1 = idx[:, None] == idx[None, :] + 1
    dA_x = torch.where(sub1, zero, dA)
    same = (idx[:, None] // SUB == idx[None, :] // SUB) & lower
    dA_in = torch.where(same, dA_x, zero)
    E = ex(cp[..., :, None, :] - cum[..., None, :, :])      # (.., i, j, n)
    pv = torch.einsum("bhcij,bhcjn,bhcijn->bhcin", dA_in, kc, E)
    qv = torch.einsum("bhcij,bhcin,bhcijn->bhcjn", dA_in, rc, E)
    a_of = (idx // SUB) * SUB
    r_hat = rc * ex(cp - cp[..., a_of, :])
    for I in range(1, nsub):
        a0, a1 = I * SUB, min(I * SUB + SUB, C)
        for J in range(I):
            b = J * SUB + SUB - 1
            cols = slice(J * SUB, b + 1)
            pv[..., a0:a1, :] += ex(cp[..., a0:a1, :]
                                    - cum[..., b:b + 1, :]) \
                * (dA_x[..., a0:a1, cols] @ k_til[..., cols, :])
        qv[..., :a0, :] += ex(cum[..., a0 - 1:a0, :] - cum[..., :a0, :]) \
            * (dA_x[..., a0:a1, :a0].transpose(-1, -2)
               @ r_hat[..., a0:a1, :])
    t = torch.zeros_like(rc)
    t[..., 1:, :] = dA[..., idx[1:], idx[:-1], None] * kc[..., :-1, :]
    s_ = torch.zeros_like(rc)
    s_[..., :-1, :] = dA[..., idx[1:], idx[:-1], None] * rc[..., 1:, :]
    ecp, ek = ex(cp), ex(tot[..., None, :] - cum)
    ud = ddg[..., None] * u[None, :, None, None, :]
    dr = dr_dec * ecp + (pv + t) + ud * kc
    dk = dk_dec * ek + (qv + s_) + ud * rc
    dcp = dr_dec * (rc * ecp) + rc * pv
    g = dk_dec * (kc * ek)
    dcum = -kc * qv
    # dlw_i = e^{tot} sum S D + sum_{j<i} g_j + sum_{i'>=i} d(cum)_{i'}
    #         + sum_{i'>i} d(cp)_{i'}
    # a thread a (sub-chunk, channel): its rows' sums, then the other
    # sub-chunks' totals in order
    es = (starts * D).sum(-1) * torch.exp(tot)
    dlw = torch.zeros_like(rc)
    bg, bd = [], []
    for I in range(nsub):
        rows = range(I * SUB, min(I * SUB + SUB, C))
        gs, ds_ = torch.zeros_like(es), torch.zeros_like(es)
        for i in rows:
            gs = gs + g[..., i, :]
            ds_ = ds_ + (dcum[..., i, :] + dcp[..., i, :])
        bg.append(gs)
        bd.append(ds_)
    for I in range(nsub):
        rows = range(I * SUB, min(I * SUB + SUB, C))
        P, Q = torch.zeros_like(es), torch.zeros_like(es)
        for J in range(I):
            P = P + bg[J]
        for J in reversed(range(I + 1, nsub)):
            Q = Q + bd[J]
        prefix = {}
        for i in rows:
            prefix[i] = P
            P = P + g[..., i, :]
        for i in reversed(rows):
            Q = Q + dcum[..., i, :]
            dlw[..., i, :] = (es + prefix[i]) + Q
            Q = Q + dcp[..., i, :]
    du = (ddg[..., None] * (rc * kc)).sum(3).sum(dim=(0, 2))

    def unchunk(t):
        return t.permute(0, 2, 3, 1, 4).reshape(B, S, H, N)

    return unchunk(dr), unchunk(dk), unchunk(dv), unchunk(dlw), du


def _wkv_cotangents(B, S, H, N, seed):
    rng = np.random.default_rng(seed)
    cy = rng.normal(size=(B, S, H, N)).astype(np.float32)
    cs = (rng.normal(size=(B, H, N, N)) * 0.1).astype(np.float32)
    return cy, cs


def _jax_scan_grads(r, k, v, w, u, s0, cy, cs):
    """jax.grad of the reference's sequential ``wkv_scan`` on the clipped
    decays, with dlw = dw * w."""
    import jax
    wc = np.clip(w, 1e-8, 1.0)

    def loss(r, k, v, w, u):
        y, s = jax_rwkv.wkv_scan(r, k, v, w, u, s0)
        return jnp.sum(y * cy) + jnp.sum(s * cs)

    g = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(r, k, v, wc, u)
    dr, dk, dv, dw, du = (np.asarray(x) for x in g)
    return dr, dk, dv, dw * wc, du


@pytest.mark.parametrize("decay", ["uniform", 1e-6, "mixed"])
@pytest.mark.parametrize("B,S,H,N,C", [(2, 64, 2, 16, 16),
                                       (1, 128, 3, 32, 32),
                                       (1, 192, 2, 64, 64)])
def test_wkv_bwd_phases_match_reference_grad(B, S, H, N, C, decay):
    """dr, dk, dv, dlw and du of the design against ``jax.grad`` of the
    reference's sequential oracle, each within 1e-5 of its largest entry;
    where the decays are strong (1e-6, or mixed channels at the clip),
    dlw's true entries lie below the fp32 rounding of the terms that
    cancel in it, so it is held within 1e-5 of the largest dr entry, as
    ``tests/test_torch_cuda.py`` holds the kernel."""
    r, k, v, w, u, s0 = _wkv_case(B, S, H, N, decay)
    cy, cs = _wkv_cotangents(B, S, H, N, seed=S + N + 1)
    want = _jax_scan_grads(r, k, v, w, u, s0, cy, cs)
    tr, tk, tv, tw, tu, ty, ts = map(torch.from_numpy, (r, k, v, w, u, cy, cs))
    got = wkv_bwd_phases(tr, tk, tv, log_decay(tw), tu, ty, ts, C)
    for name, a, b in zip(("dr", "dk", "dv", "dlw", "du"), got, want):
        scale = np.abs(want[0] if name == "dlw" and decay != "uniform"
                       else b).max()
        assert np.isfinite(a.numpy()).all(), name
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("decay", [1e-6, "mixed"])
def test_wkv_bwd_phases_at_least_as_close_to_float64_as_plain(decay):
    """At C = 64 under strong decays, the design's gradients sit at least
    as close to float64 autograd of the port's sequential ``wkv_scan`` as
    fp32 autograd of the plain chunk algebra (cp = cum - lw) does, leaf by
    leaf, measured against each leaf's largest float64 entry, wherever
    either is farther off than fp32 rounding (5e-7 of that entry, 8 units
    in the last place); dr, dk and dv at least 10x closer, and at decays
    of 1e-6 dlw at least 100x closer (the plain algebra's cp = cum - lw
    moves the j = i - 1 decay off 1 and its gradient off 0)."""
    B, S, H, N, C = 1, 192, 2, 64, 64
    r, k, v, w, u, s0 = _wkv_case(B, S, H, N, decay)
    cy, cs = _wkv_cotangents(B, S, H, N, seed=S + N + 1)
    tr, tk, tv, tw, tu, ty, ts = map(torch.from_numpy, (r, k, v, w, u, cy, cs))
    got = wkv_bwd_phases(tr, tk, tv, log_decay(tw), tu, ty, ts, C)

    def grads(fn, dt):
        xs = [x.to(dt).clone().requires_grad_(True)
              for x in (tr, tk, tv, log_decay(tw), tu)]
        y, st = fn(*xs)
        (torch.sum(y * ty.to(dt)) + torch.sum(st * ts.to(dt))).backward()
        return [x.grad for x in xs]

    truth = grads(lambda r, k, v, lw, u: wkv_scan(
        r, k, v, torch.exp(lw), u, torch.zeros((B, H, N, N),
                                               dtype=torch.float64)),
        torch.float64)
    plain = grads(lambda r, k, v, lw, u: wkv_chunked_lw(
        r, k, v, lw, u, torch.zeros((B, H, N, N)), C), torch.float32)
    for name, a, p, t in zip(("dr", "dk", "dv", "dlw", "du"), got, plain,
                             truth):
        scale = float(t.abs().max())
        emul = float((a.double() - t).abs().max()) / scale
        ref = float((p.double() - t).abs().max()) / scale
        assert emul <= max(ref, 5e-7), (name, emul, ref)
        if name in ("dr", "dk", "dv"):
            assert emul * 10 <= ref, (name, emul, ref)
        if name == "dlw" and decay == 1e-6:
            assert emul * 100 <= ref, (name, emul, ref)


@pytest.mark.parametrize("B,S,H,N,C", [(4, 512, 40, 64, 64),
                                       (2, 96, 1, 8, 32), (3, 64, 5, 16, 16),
                                       (2, 64, 2, 32, 64)])
def test_wkv_bwd_grid_covers_every_chunk_and_state_entry_once(B, S, H, N, C):
    """Phase (a) has one block per (lane, chunk >= 1) (chunk 0's increment
    is never read), the reverse scan one thread per (lane, n, m) state
    entry, phase (c) one block per (lane, chunk); one chunk (S = C) gives
    phase (a) no block."""
    nC = S // C
    inc_blocks, scan_blocks, grad_blocks = wkv_ops.wkv_bwd_grid(B, S, H, N, C)
    seen = [wkv_ops.wkv_bwd_inc_block(x, H, nC) for x in range(inc_blocks)]
    assert sorted(seen) == [(b, h, c) for b in range(B) for h in range(H)
                            for c in range(1, nC)]
    assert (scan_blocks - 1) * wkv_ops.FWD_THREADS < B * H * N * N \
        <= scan_blocks * wkv_ops.FWD_THREADS
    seen = [wkv_ops.wkv_block(x, H, nC) for x in range(grad_blocks)]
    assert sorted(seen) == [(b, h, c) for b in range(B) for h in range(H)
                            for c in range(nC)]


def test_wkv_bwd_grad_block_fits_two_to_an_sm():
    """Phase (c)'s shared memory at the largest chunk and head (C = N =
    64) stays under 113 KB, so two blocks fit in an H100 SM's 228 KB."""
    assert wkv_ops.bwd_grad_smem(64, 64) <= 113 * 1024
    assert all(wkv_ops.bwd_grad_smem(C, N) <= wkv_ops.bwd_grad_smem(64, 64)
               for C in (1, 16, 17, 32, 63, 64) for N in (1, 8, 31, 64))


# ---------------------------------------------------------------------------
# RNN-T lattice: lane l owns q consecutive columns, one warp scan a row
# ---------------------------------------------------------------------------

def lattice_lanes(mult, add, emit):
    """The lattice kernel's order in fp32 (``csrc/rnnt_lattice.cu``), the
    32 lanes side by side: per row, each lane's q = ceil(U1 / 32) columns
    (``ops.lane_columns``) combined in order from the previous row, an
    inclusive Hillis-Steele scan over the lanes' aggregates with the
    combine (c1, b1).(c2, b2) = (c1 + c2, logaddexp(b1 + c2, b2)), then
    each column of lane l > 0 fixed up with the value carried in from
    lane l - 1."""
    T, B, U1 = mult.shape
    W = lat_ops.WARP
    q = -(-U1 // W)

    def lanes(x):                                    # -> (T, B, W, q)
        return torch.nn.functional.pad(x, (0, W * q - U1)).reshape(
            T, B, W, q)

    m, a, e = lanes(mult), lanes(add), lanes(emit)
    cols = lat_ops.lane_columns(U1)
    valid = torch.tensor([[u0 + j < u1 for j in range(q)]
                          for u0, u1 in cols])       # (W, q)
    lane = torch.arange(W)
    prev = torch.full((B, W, q), NEG)
    rows = []
    for t in range(T):
        local = torch.empty((B, W, q))
        cs, bs = torch.zeros((B, W)), torch.full((B, W), NEG)
        for j in range(q):
            base = torch.logaddexp(prev[..., j] + m[t, ..., j], a[t, ..., j])
            b = base if j == 0 else torch.logaddexp(bs + e[t, ..., j], base)
            bs = torch.where(valid[:, j], b, bs)
            cs = torch.where(valid[:, j], cs + e[t, ..., j], cs)
            local[..., j] = bs
        for d in (1, 2, 4, 8, 16):
            c_up, b_up = torch.roll(cs, d, dims=1), torch.roll(bs, d, dims=1)
            on = lane >= d
            bs, cs = (torch.where(on, torch.logaddexp(b_up + cs, bs), bs),
                      torch.where(on, c_up + cs, cs))
        carry = torch.roll(bs, 1, dims=1)
        row, c = torch.empty_like(local), torch.zeros((B, W))
        for j in range(q):
            c = c + e[t, ..., j]
            row[..., j] = torch.where(
                lane > 0, torch.logaddexp(carry + c, local[..., j]),
                local[..., j])
        prev = row
        rows.append(row.reshape(B, W * q)[:, :U1])
    return torch.stack(rows)


def _lattice_case(T, B, U1, seed):
    """The kernel's invariants: emit[:, :, 0] = NEG and sparse additive
    seeds, as the alpha and beta lattices give them."""
    rng = np.random.default_rng(seed)
    mult = rng.normal(size=(T, B, U1)).astype(np.float32)
    add = np.where(rng.uniform(size=(T, B, U1)) < 0.3,
                   rng.normal(size=(T, B, U1)), NEG).astype(np.float32)
    emit = rng.normal(size=(T, B, U1)).astype(np.float32)
    emit[:, :, 0] = NEG
    return mult, add, emit


@pytest.mark.parametrize("U1", [1, 2, 5, 17, 33, 65, 129])
@pytest.mark.parametrize("T", [1, 9, 128])
def test_lattice_lane_order_matches_reference(T, U1):
    """Against the reference's Pallas kernel (interpret mode, as its own
    tests run it) and its ``ref.py``, at the card tests' bars (atol 1e-4,
    rtol 1e-5)."""
    from repro.kernels.rnnt_lattice.kernel import rnnt_lattice
    from repro.kernels.rnnt_lattice.ref import rnnt_lattice_ref
    ins = _lattice_case(T, 3, U1, seed=T * 1000 + U1)
    got = lattice_lanes(*map(torch.from_numpy, ins)).numpy()
    assert got.shape == (T, 3, U1) and np.isfinite(got).all()
    for want in (rnnt_lattice(*map(jnp.asarray, ins), interpret=True),
                 rnnt_lattice_ref(*map(jnp.asarray, ins))):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4,
                                   rtol=1e-5)


@pytest.mark.parametrize("U1", [1, 31, 32, 33, 64, 257, 1186, 12288])
def test_lattice_lanes_cover_each_column_once_in_order(U1):
    """Each column belongs to one lane, lanes hold consecutive runs in
    lane order, at most ceil(U1 / 32) each; the ring holds 16 rows up to
    1,185 columns and at least one at the largest row the wrapper takes."""
    cols = lat_ops.lane_columns(U1)
    assert len(cols) == lat_ops.WARP
    assert [u for u0, u1 in cols for u in range(u0, u1)] == list(range(U1))
    assert max(u1 - u0 for u0, u1 in cols) == -(-U1 // lat_ops.WARP)
    depth = lat_ops.ring_depth(U1)
    assert depth in (1, 2, 4, 8, 16)
    assert (depth == 16) == (U1 <= 1185)
    assert 4 * (-(-U1 // 4) * 4 + depth * 3 * U1) <= lat_ops.SMEM_MAX
    assert lat_ops.ring_depth(lat_ops.MAX_U1) >= 1


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
