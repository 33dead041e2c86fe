"""PyTorch port, sliding-window attention against the JAX reference, on
the CPU (the plain versions; the CUDA kernel is held against the plain
version in ``tests/test_torch_cuda.py``):

- the plain ``swa_attn`` against the reference's ``swa_attn_ref`` at the
  reference kernel tests' five shapes and bars (fp32 1e-4, bf16 3e-2),
  in the port's GQA layout (KV heads shared by G query heads), with
  per-row valid lengths, and at S off every multiple of 1024;
- the model-level ``_mha_band`` and ``_mha_flash`` against the
  reference's at fp32 (1e-5), and, where the reference's band gather
  raises (S % 1024 != 0), against the reference's masked ``_mha_full``;
- ``attn_forward`` through its three branches (full, flash, band) on
  ``starcoder2-3b-smoke`` widths (window 16), fp32 1e-5, against the
  reference jitted as it runs (its RoPE frequencies are folded exactly
  rounded there, an ulp off in eager JAX: ROADMAP S9), and the band at
  bf16 within the LM tests' bf16 bar of 2e-2 relative error in norm
  (the kernel keeps p in fp32 for p @ v where the reference casts it to
  bf16).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.swa_attn.ref import swa_attn_ref as jax_swa_ref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.swa_attn.ops import swa_attn_op  # noqa: E402
from repro_torch.kernels.swa_attn.ref import swa_attn_ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

ARCH = "starcoder2-3b-smoke"


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _jax_heads(q, k, v):
    """Port layout (B,S,KV,G,hd), (B,S,KV,hd) -> the reference kernel's
    (B,H,S,hd) with head h = kv * G + g (k, v repeated over G)."""
    B, S, KV, G, hd = q.shape
    qj = np.transpose(q.reshape(B, S, KV * G, hd), (0, 2, 1, 3))
    kj = np.repeat(np.transpose(k, (0, 2, 1, 3)), G, axis=1)
    vj = np.repeat(np.transpose(v, (0, 2, 1, 3)), G, axis=1)
    return qj, kj, vj


def _port_from_jax_heads(o, KV, G):
    B, H, S, hd = o.shape
    return np.transpose(o, (0, 2, 1, 3)).reshape(B, S, KV, G, hd)


@pytest.mark.parametrize("B,H,S,hd,W,dtype",
                         [(2, 3, 128, 32, 32, "float32"),
                          (1, 2, 256, 64, 64, "float32"),
                          (2, 2, 64, 16, 16, "float32"),
                          (1, 2, 128, 32, 64, "bfloat16"),
                          (1, 1, 96, 16, 32, "float32")])
def test_plain_swa_matches_reference_oracle(B, H, S, hd, W, dtype):
    """The reference kernel tests' shapes, one KV head per query head."""
    q, k, v = (_normal((B, S, H, hd), seed) for seed in range(3))
    qj, kj, vj = _jax_heads(q[:, :, :, None], k, v)
    jdt = jnp.dtype(dtype)
    want = np.asarray(jax_swa_ref(jnp.asarray(qj, jdt), jnp.asarray(kj, jdt),
                                  jnp.asarray(vj, jdt), window=W
                                  ).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = swa_attn_op(*(torch.from_numpy(x).to(tdt)
                        for x in (q[:, :, :, None], k, v)), window=W)
    assert got.dtype == tdt and got.shape == (B, S, H, 1, hd)
    tol = 1e-4 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(),
                               _port_from_jax_heads(want, H, 1), atol=tol,
                               rtol=0)


@pytest.mark.parametrize("S,W", [(1100, 40), (2500, 700), (300, 64),
                                 (77, 200)],
                         ids=["S1100", "S2500", "one-block", "window>S"])
def test_plain_swa_gqa_layout_and_ragged_s(S, W):
    """KV 2 heads shared by G 3 query heads each, S off every multiple of
    the q block, and a window larger than S."""
    B, KV, G, hd = 1, 2, 3, 16
    q = _normal((B, S, KV, G, hd), 10)
    k, v = _normal((B, S, KV, hd), 11), _normal((B, S, KV, hd), 12)
    want = np.asarray(jax_swa_ref(*map(jnp.asarray, _jax_heads(q, k, v)),
                                  window=W))
    got = swa_attn_ref(*map(torch.from_numpy, (q, k, v)), window=W)
    np.testing.assert_allclose(got.numpy(), _port_from_jax_heads(want, KV, G),
                               atol=1e-4, rtol=0)


def test_plain_swa_per_row_lengths():
    """Row b holds lengths[b] tokens: its valid rows equal the reference
    on the truncated sequence, the rest are zeros."""
    B, S, KV, G, hd, W = 3, 1030, 2, 2, 16, 48
    q = _normal((B, S, KV, G, hd), 20)
    k, v = _normal((B, S, KV, hd), 21), _normal((B, S, KV, hd), 22)
    lengths = np.asarray([S, 1000, 5], np.int32)
    got = swa_attn_op(*map(torch.from_numpy, (q, k, v)), window=W,
                      lengths=torch.from_numpy(lengths)).numpy()
    for b, n in enumerate(lengths):
        want = np.asarray(jax_swa_ref(
            *map(jnp.asarray, _jax_heads(q[b:b + 1, :n], k[b:b + 1, :n],
                                         v[b:b + 1, :n])), window=W))
        np.testing.assert_allclose(got[b:b + 1, :n],
                                   _port_from_jax_heads(want, KV, G),
                                   atol=1e-4, rtol=0)
        assert not got[b, n:].any()


def _qkv(B, S, KV, G, hd, seed):
    return (_normal((B, S, KV, G, hd), seed),
            _normal((B, S, KV, hd), seed + 1),
            _normal((B, S, KV, hd), seed + 2))


def _positions(B, S, lens):
    pos = np.broadcast_to(np.arange(S), (B, S))
    return np.where(pos < np.asarray(lens)[:, None], pos, -1).astype(np.int32)


@pytest.mark.parametrize("lens", [[2048], [2048, 1500]], ids=["full", "padded"])
def test_band_matches_reference_band(lens):
    """S = 2048 (a multiple of 1024, where the reference's band gather
    runs), window 16; the padded row's valid rows are compared (pad rows
    are outside the contract)."""
    B, S, W = len(lens), 2048, 16
    q, k, v = _qkv(B, S, 2, 2, 16, seed=30)
    pos = _positions(B, S, lens)
    scale = 1.0 / jnp.sqrt(16).astype(jnp.float32)
    want = np.asarray(jattn._mha_band(*map(jnp.asarray, (q, k, v, pos, pos)),
                                      W, scale))
    got = tattn._mha_band(*map(torch.from_numpy, (q, k, v)),
                          torch.from_numpy(pos), W).numpy()
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("S,W", [(1100, 16), (2500, 700)])
def test_band_where_the_reference_raises(S, W):
    """The reference's band gather reshapes q into blocks of 1024 and
    raises for S % 1024 != 0 (ROADMAP S1); the port computes every S and
    equals the reference's masked _mha_full there."""
    q, k, v = _qkv(1, S, 2, 2, 16, seed=40)
    pos = _positions(1, S, [S])
    scale = 1.0 / jnp.sqrt(16).astype(jnp.float32)
    jq, jk, jv, jp = map(jnp.asarray, (q, k, v, pos))
    with pytest.raises(TypeError, match="reshape"):
        jattn._mha_band(jq, jk, jv, jp, jp, W, scale)
    mask = jattn.window_mask(W)(jp, jp) & jattn._valid(jp)[..., None, :]
    want = np.asarray(jattn._mha_full(jq, jk, jv, mask, scale))
    got = tattn._mha_band(*map(torch.from_numpy, (q, k, v)),
                          torch.from_numpy(pos), W).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_band_refuses_positions_it_cannot_express():
    q, k, v = map(torch.from_numpy, _qkv(1, 64, 1, 1, 16, seed=50))
    pos = torch.arange(64)[None].flip(1)
    with pytest.raises(ValueError, match="positions"):
        tattn._mha_band(q, k, v, pos, 8)


@pytest.mark.parametrize("mask", ["causal", "window"])
@pytest.mark.parametrize("lens", [[700], [700, 433]], ids=["full", "padded"])
def test_flash_matches_reference_flash(mask, lens):
    """kv blocks of 512 over S = 700 (the last block short in the port,
    padded with invalid positions in the reference)."""
    B, S = len(lens), 700
    q, k, v = _qkv(B, S, 2, 3, 16, seed=60)
    pos = _positions(B, S, lens)
    scale = 1.0 / jnp.sqrt(16).astype(jnp.float32)
    jfn = jattn.causal_mask if mask == "causal" else jattn.window_mask(100)
    tfn = tattn.causal_mask if mask == "causal" else tattn.window_mask(100)
    want = np.asarray(jattn._mha_flash(*map(jnp.asarray, (q, k, v, pos, pos)),
                                       jfn, scale))
    got = tattn._mha_flash(*map(torch.from_numpy, (q, k, v, pos, pos)), tfn,
                           tattn._scale(16)).numpy()
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=1e-5,
                                   rtol=1e-5)


@pytest.fixture(scope="module")
def attn_params():
    cj = jax_get_config(ARCH)
    from repro.models.attention import init_attn_params
    p = init_attn_params(jax.random.PRNGKey(1), cj)
    return {k: np.array(v) for k, v in p.items()}


@pytest.mark.parametrize("kind,S,lens", [
    ("local", 24, None), ("attn", 24, None),           # full
    ("attn", 4100, None),                              # flash (S*S > 4096^2)
    ("local", 2048, None), ("local", 2048, [2048, 1999]),  # band
], ids=["full-local", "full-attn", "flash", "band", "band-padded"])
def test_attn_forward_branches_match_reference(attn_params, kind, S, lens):
    cj, ct = jax_get_config(ARCH), get_config(ARCH)
    B = 1 if lens is None else len(lens)
    x = _normal((B, S, ct.d_model), 70)
    kw_j, kw_t = {}, {}
    if lens is not None:
        pos = _positions(B, S, lens)
        kw_j = dict(q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos))
        kw_t = dict(q_positions=torch.from_numpy(pos),
                    kv_positions=torch.from_numpy(pos))
    want = np.asarray(jax.jit(lambda p, x, kw: jattn.attn_forward(
        p, cj, x, kind=kind, **kw))(attn_params, x, kw_j))
    got = tattn.attn_forward({k: torch.from_numpy(v)
                              for k, v in attn_params.items()}, ct,
                             torch.from_numpy(x), kind=kind, **kw_t)[0].numpy()
    for b, n in enumerate(lens or [S]):
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=1e-5,
                                   rtol=1e-5)


def test_band_at_bf16_within_the_bf16_bar(attn_params):
    """At bf16 compute the port's band (p kept in fp32) and the
    reference's band gather (p cast to bf16 before p @ v) differ by bf16
    rounding: held at 2e-2 relative error in norm."""
    cj = dataclasses.replace(jax_get_config(ARCH), compute_dtype="bfloat16")
    ct = dataclasses.replace(get_config(ARCH), compute_dtype="bfloat16")
    x = _normal((1, 2048, ct.d_model), 80)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), attn_params)
    want = np.asarray(jax.jit(lambda p, x: jattn.attn_forward(
        p, cj, x, kind="local"))(jp, jnp.asarray(x, jnp.bfloat16)
                                 ).astype(jnp.float32))
    got = tattn.attn_forward(
        {k: torch.from_numpy(v).to(torch.bfloat16)
         for k, v in attn_params.items()}, ct,
        torch.from_numpy(x).to(torch.bfloat16), kind="local")[0]
    assert got.dtype == torch.bfloat16
    rel = np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(want)
    assert rel < 2e-2, rel


def _band_split_p(q, k, v, window):
    """The bf16 kernel's arithmetic in plain PyTorch for one head: fp32
    scores of bf16 q and k, p = exp(s - m) in fp32 (masked entries 0),
    p . v as the two bf16 products p_hi . v + p_lo . v (p_hi = bf16(p),
    p_lo = bf16(p - p_hi)) summed in fp32, divided by l = sum(p); also
    with a single bf16 p.  q, k, v (S, hd) fp32 holding bf16 values ->
    (split, single) fp32, before any cast to bf16."""
    S, hd = q.shape
    s = (q @ k.T) * (1.0 / np.sqrt(np.float32(hd)))
    pos = torch.arange(S)
    d = pos[:, None] - pos[None, :]
    s = torch.where((d >= 0) & (d < window), s, float("-inf"))
    p = torch.exp(s - s.max(-1, keepdim=True).values)
    den = p.sum(-1, keepdim=True)
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    return (hi @ v + lo @ v) / den, (hi @ v) / den


def test_split_p_keeps_the_band_within_a_quarter_of_the_one_ulp_bar():
    """The bf16 kernel feeds p . v to the tensor cores in bf16, so it
    splits p into bf16 hi + lo and runs two products into one fp32
    accumulator.  Against the plain band softmax with an fp32 p on the
    same bf16-valued inputs (one head, S 1024, W 512, hd 128), every
    fp32 output takes at most a quarter of the one-bf16-ulp bar
    ``2^-7 |want| + 1e-5`` the card check holds the kernel to (0.08 of
    it here).  A single bf16 p is not enough: its 2^-9 relative error a
    term puts the small outputs, where terms cancel, far over the 1e-5
    floor, ~60x the bar at this shape.  The outputs are compared before
    the cast to bf16, which by itself may land one ulp apart."""
    S, W, hd = 1024, 512, 128
    rng = np.random.default_rng(15)
    q, k, v = (torch.from_numpy(rng.normal(size=(S, hd)).astype(np.float32)
                                ).to(torch.bfloat16).float()
               for _ in range(3))
    split, single = _band_split_p(q, k, v, W)
    want = swa_attn_ref(q[None, :, None, None], k[None, :, None],
                        v[None, :, None], window=W)[0, :, 0, 0]
    assert want.dtype == torch.float32
    bar = 2.0 ** -7 * want.abs() + 1e-5
    assert float(((split - want).abs() / bar).max()) <= 0.25
    assert float(((single - want).abs() / bar).max()) > 10.0
