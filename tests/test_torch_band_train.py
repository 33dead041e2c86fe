"""PyTorch port, training through the band on the CPU: the band's plain
backward and group remat, against the JAX reference (the CUDA backward
kernel is held against the plain backward in ``tests/test_torch_cuda.py``
and in ``chip_smoke.py``):

- the plain backward (``swa_attn_bwd_ref``) against ``jax.vjp`` of the
  reference's ``kernels/swa_attn/ref.py:swa_attn_ref`` at the reference
  kernel tests' five shapes (fp32 1e-4, bf16 3e-2 of each gradient's
  largest entry), in the port's GQA layout (the reference's dk / dv
  summed over the G query heads of a KV head), with per-row lengths and
  at S off every multiple of 1024;
- the plain backward against autograd of the plain forward (fp32 1e-5),
  its lse against a direct logsumexp of the band's scores, NEG on rows
  with no valid key (B3), zero gradients from rows and for keys at or
  past a row's length (B2);
- ``_mha_band``'s gradients through the one autograd function against
  ``jax.grad`` of the reference's ``_mha_band`` at S 2,048, window 16
  (1e-5), and against its masked ``_mha_full`` where the band gather
  raises (S 1,100 and 2,500; B5);
- group remat: loss and every gradient leaf bitwise those without it,
  with fewer bytes saved for the backward (counted by
  ``saved_tensors_hooks``), on the three band archs' smokes past the
  band's start (window 16: S > 1,040; ``gemma3-27b-smoke``, whose
  global layers materialise S x S scores, at S 1,100) and on the MoE,
  RWKV6, encoder-decoder and VLM smokes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.swa_attn.ref import swa_attn_ref as jax_swa_ref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.swa_attn.ops import swa_attn_op  # noqa: E402
from repro_torch.kernels.swa_attn.ref import (NEG, attn_scale,  # noqa: E402
                                              swa_attn_bwd_ref,
                                              swa_attn_fwd_ref, swa_attn_ref)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _qkv(B, S, KV, G, hd, seed):
    return (_normal((B, S, KV, G, hd), seed),
            _normal((B, S, KV, hd), seed + 1),
            _normal((B, S, KV, hd), seed + 2))


def _jax_heads(q, k, v):
    """Port layout -> the reference kernel's (B,H,S,hd), head h = kv * G +
    g (k, v repeated over G)."""
    B, S, KV, G, hd = q.shape
    qj = np.transpose(q.reshape(B, S, KV * G, hd), (0, 2, 1, 3))
    kj = np.repeat(np.transpose(k, (0, 2, 1, 3)), G, axis=1)
    vj = np.repeat(np.transpose(v, (0, 2, 1, 3)), G, axis=1)
    return qj, kj, vj


def _port_grads(dq, dk, dv, KV, G):
    """The reference's per-head gradients -> the port's layout, dk / dv
    summed over the G heads of a KV head."""
    B, H, S, hd = dq.shape
    dq = np.transpose(dq, (0, 2, 1, 3)).reshape(B, S, KV, G, hd)
    dk, dv = (np.transpose(x.reshape(B, KV, G, S, hd).sum(axis=2),
                           (0, 2, 1, 3)) for x in (dk, dv))
    return dq, dk, dv


def _reference_vjp(q, k, v, dout, W, dtype="float32"):
    """``jax.vjp`` of the reference's plain band at the port's layout."""
    KV, G = q.shape[2], q.shape[3]
    jdt = jnp.dtype(dtype)
    qj, kj, vj = (jnp.asarray(x, jdt) for x in _jax_heads(q, k, v))
    out, vjp = jax.vjp(lambda a, b, c: jax_swa_ref(a, b, c, window=W),
                       qj, kj, vj)
    B, S, _, _, hd = q.shape
    doj = jnp.asarray(np.transpose(dout.reshape(B, S, KV * G, hd),
                                   (0, 2, 1, 3)), jdt)
    grads = [np.asarray(g.astype(jnp.float32)) for g in vjp(doj)]
    return _port_grads(*grads, KV, G)


def _port_bwd(q, k, v, dout, W, lengths=None, dtype=torch.float32):
    """The port's forward (with lse) and plain backward -> numpy grads."""
    q, k, v, dout = (torch.from_numpy(x).to(dtype) for x in (q, k, v, dout))
    lens = None if lengths is None else torch.tensor(lengths,
                                                     dtype=torch.int32)
    out, lse = swa_attn_fwd_ref(q, k, v, window=W, lengths=lens)
    grads = swa_attn_bwd_ref(q, k, v, out, lse, dout, window=W,
                             lengths=lens)
    return [g.float().numpy() for g in grads], out, lse


def _close(got, want, tol):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=tol * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("B,H,S,hd,W,dtype",
                         [(2, 3, 128, 32, 32, "float32"),
                          (1, 2, 256, 64, 64, "float32"),
                          (2, 2, 64, 16, 16, "float32"),
                          (1, 2, 128, 32, 64, "bfloat16"),
                          (1, 1, 96, 16, 32, "float32")])
def test_plain_backward_matches_reference_vjp(B, H, S, hd, W, dtype):
    """The reference kernel tests' shapes, one KV head per query head."""
    q, k, v = _qkv(B, S, H, 1, hd, 0)
    dout = _normal(q.shape, 9)
    want = _reference_vjp(q, k, v, dout, W, dtype)
    got, _, _ = _port_bwd(q, k, v, dout, W, dtype=getattr(torch, dtype))
    _close(got, want, 1e-4 if dtype == "float32" else 3e-2)


@pytest.mark.parametrize("S,W,G", [(1100, 40, 3), (300, 64, 2),
                                   (77, 200, 2)],
                         ids=["S1100", "one-block", "window>S"])
def test_plain_backward_gqa_and_ragged_s(S, W, G):
    """KV 2 heads shared by G query heads, dk / dv summed over G, S off
    every multiple of the q block, a window larger than S."""
    q, k, v = _qkv(1, S, 2, G, 16, 10)
    dout = _normal(q.shape, 13)
    _close(_port_bwd(q, k, v, dout, W)[0],
           _reference_vjp(q, k, v, dout, W), 1e-4)


def test_plain_backward_per_row_lengths():
    """Row b holds lengths[b] tokens: its gradients on the valid prefix
    equal the reference's on the truncated sequence (rows past a length
    give nothing, B2), and keys at or past it get zero dk / dv."""
    B, S, KV, G, hd, W = 3, 1030, 2, 2, 16, 48
    q, k, v = _qkv(B, S, KV, G, hd, 20)
    dout = _normal(q.shape, 23)
    lengths = [S, 1000, 5]
    got, _, lse = _port_bwd(q, k, v, dout, W, lengths)
    for b, n in enumerate(lengths):
        want = _reference_vjp(q[b:b + 1, :n], k[b:b + 1, :n],
                              v[b:b + 1, :n], dout[b:b + 1, :n], W)
        _close([g[b:b + 1, :n] for g in got], want, 1e-4)
        assert not any(g[b, n:].any() for g in got)
        assert bool((lse[b, n:] == NEG).all())


@pytest.mark.parametrize("lengths", [None, [70, 33]])
def test_plain_backward_matches_autograd_and_lse(lengths):
    """The explicit backward equals autograd of the plain forward (fp32
    1e-5); lse is the logsumexp of the scaled scores inside the band, NEG
    (never -inf) on rows at or past a length (B3)."""
    B, S, KV, G, hd, W = 2, 70, 1, 3, 16, 9
    q, k, v = (torch.from_numpy(x) for x in _qkv(B, S, KV, G, hd, 30))
    dout = torch.from_numpy(_normal(q.shape, 33))
    lens = None if lengths is None else torch.tensor(lengths,
                                                     dtype=torch.int32)
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    with torch.enable_grad():
        want = torch.autograd.grad(
            swa_attn_ref(*xs, window=W, lengths=lens), xs, dout)
    out, lse = swa_attn_fwd_ref(q, k, v, window=W, lengths=lens)
    got = swa_attn_bwd_ref(q, k, v, out, lse, dout, window=W, lengths=lens)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()))
    s = torch.einsum("bikgd,bjkd->bkgij", q, k) * attn_scale(hd)
    i, j = torch.arange(S)[:, None], torch.arange(S)[None, :]
    band = (i - j >= 0) & (i - j < W)
    direct = torch.logsumexp(torch.where(band, s, -torch.inf), dim=-1)
    direct = direct.permute(0, 3, 1, 2)
    n = [S] * B if lengths is None else lengths
    for b in range(B):
        np.testing.assert_allclose(lse[b, :n[b]].numpy(),
                                   direct[b, :n[b]].numpy(), rtol=0,
                                   atol=1e-5)
        assert bool((lse[b, n[b]:] == NEG).all())
    assert bool(torch.isfinite(lse).all())


def test_op_backward_is_the_plain_backward():
    """On the CPU ``swa_attn_op`` goes through the one autograd function,
    whose backward is ``swa_attn_bwd_ref``: the same bits."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 80, 2, 2, 16, 40))
    dout = torch.from_numpy(_normal(q.shape, 43))
    lens = torch.tensor([61], dtype=torch.int32)
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    with torch.enable_grad():
        got = torch.autograd.grad(swa_attn_op(*xs, window=12, lengths=lens),
                                  xs, dout)
    out, lse = swa_attn_fwd_ref(q, k, v, window=12, lengths=lens)
    want = swa_attn_bwd_ref(q, k, v, out, lse, dout, window=12,
                            lengths=lens)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with torch.no_grad():
        assert torch.equal(swa_attn_op(q, k, v, window=12, lengths=lens),
                           out)


def _positions(B, S, lens):
    pos = np.broadcast_to(np.arange(S), (B, S))
    return np.where(pos < np.asarray(lens)[:, None], pos, -1).astype(np.int32)


def _band_grads(q, k, v, pos, W):
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    dout = torch.from_numpy(_normal(q.shape, 77))
    with torch.enable_grad():
        out = tattn._mha_band(*xs, torch.from_numpy(pos), W)
        grads = torch.autograd.grad(out, xs, dout)
    return [g.numpy() for g in grads], dout.numpy()


def test_band_grads_match_reference_band():
    """S 2,048 (where the reference's band gather runs), window 16: the
    gradients of ``_mha_band`` against ``jax.grad`` of the reference's."""
    S, W = 2048, 16
    q, k, v = _qkv(1, S, 2, 2, 16, seed=50)
    pos = _positions(1, S, [S])
    got, dout = _band_grads(q, k, v, pos, W)
    scale = 1.0 / jnp.sqrt(16).astype(jnp.float32)
    jp = jnp.asarray(pos)
    _, vjp = jax.vjp(lambda a, b, c: jattn._mha_band(a, b, c, jp, jp, W,
                                                     scale),
                     *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S,W", [(1100, 16), (2500, 700)])
def test_band_grads_where_the_reference_raises(S, W):
    """S % 1024 != 0: the reference's band gather raises (S1), so the
    port's gradients are held against its masked ``_mha_full`` (B5)."""
    q, k, v = _qkv(1, S, 2, 2, 16, seed=60)
    pos = _positions(1, S, [S])
    got, dout = _band_grads(q, k, v, pos, W)
    scale = 1.0 / jnp.sqrt(16).astype(jnp.float32)
    jp = jnp.asarray(pos)
    mask = jattn.window_mask(W)(jp, jp) & jattn._valid(jp)[..., None, :]
    with pytest.raises(TypeError, match="reshape"):
        jattn._mha_band(*map(jnp.asarray, (q, k, v)), jp, jp, W, scale)
    _, vjp = jax.vjp(lambda a, b, c: jattn._mha_full(a, b, c, mask, scale),
                     *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


def _saved_and_grads(bundle, params, batch, remat):
    """(loss, every gradient leaf, bytes saved for the backward)."""
    live = tree_map(lambda x: x.detach().requires_grad_(True), params)
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t
    with torch.enable_grad():
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            total, _ = bundle.loss_fn(live, batch, remat=remat)
        grads = torch.autograd.grad(total, tree_leaves(live))
    return total.detach(), grads, saved[0]


@pytest.mark.parametrize("arch,S", [
    ("starcoder2-3b-smoke", 2048), ("recurrentgemma-9b-smoke", 2048),
    ("gemma3-27b-smoke", 1100), ("mixtral-8x7b-smoke", 64),
    ("rwkv6-3b-smoke", 64), ("seamless-m4t-medium-smoke", 64),
    ("paligemma-3b-smoke", 64)])
def test_remat_is_bitwise_and_saves_less(arch, S):
    """Remat on against off (B4): the loss and every gradient leaf bit for
    bit, fewer bytes saved for the backward with remat."""
    b = build_model(get_config(arch))
    params = b.init_params(torch.Generator().manual_seed(0),
                           torch.device("cpu"))
    gen = torch.Generator().manual_seed(1)
    if hasattr(b, "make_batch"):
        batch = b.make_batch(gen, 2, S)
    else:
        batch = {"tokens": torch.randint(0, b.cfg.vocab_size, (2, S),
                                         generator=gen, dtype=torch.int32)}
    on = _saved_and_grads(b, params, batch, True)
    off = _saved_and_grads(b, params, batch, False)
    assert torch.equal(on[0], off[0])
    assert len(on[1]) == len(off[1]) == len(tree_leaves(params))
    assert all(torch.equal(x, y) for x, y in zip(on[1], off[1]))
    assert on[2] < off[2], (on[2], off[2])
