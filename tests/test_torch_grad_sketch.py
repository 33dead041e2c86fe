"""PyTorch port, the grad-sketch kernel's plain versions against the JAX
reference on the same inputs made with numpy from a seed: the port's
``grad_sketch_units_ref`` (softmax materialized) and the wrapper's CPU
path (``streamed_er2`` + segment contraction, also streamed at the
Pallas kernel's vocab tile) against the JAX Pallas ``grad_sketch_units``
in interpret mode and the JAX ``grad_sketch_ref``, at the shapes of
``tests/test_kernels.py`` and with several units.  The
Hopper kernel itself is held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerance: 1e-4 of the largest entry in fp32 (the reference's own bar
for its kernel), 2e-2 for bf16 inputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.grad_sketch.kernel import grad_sketch_units  # noqa: E402
from repro.kernels.grad_sketch.ref import grad_sketch_ref as jax_ref  # noqa: E402
from repro_torch.core.lastlayer import streamed_er2  # noqa: E402
from repro_torch.kernels.grad_sketch import ops  # noqa: E402
from repro_torch.kernels.grad_sketch.ref import (  # noqa: E402
    grad_sketch_ref, grad_sketch_units_ref)

# (U, n, d, V, k1, k2, tn, tv, dtype): test_kernels.py's shapes, U = 1,
# plus ragged multi-unit cases
SHAPES = [(1, 40, 32, 300, 16, 16, 16, 128, np.float32),
          (1, 256, 64, 1000, 32, 32, 128, 256, np.float32),
          (1, 100, 48, 517, 8, 24, 32, 100, np.float32),
          (1, 64, 32, 301, 16, 16, 32, 64, "bfloat16"),
          (1, 17, 16, 64, 8, 8, 8, 32, np.float32),
          (3, 23, 24, 131, 12, 20, 8, 64, np.float32)]


def _inputs(U, n, d, V, k1, k2, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(U, n, d)).astype(np.float32)
    w = (rng.normal(size=(d, V)) * 0.1).astype(np.float32)
    rh = rng.normal(size=(d, k1)).astype(np.float32)
    rv = rng.normal(size=(V, k2)).astype(np.float32)
    t = rng.integers(0, V, (U, n)).astype(np.int32)
    s = rng.uniform(0.5, 1.0, (U, n)).astype(np.float32)
    if U > 1:
        s[1] = 0.0                            # an all-zero-scale unit
    return h, w, rh, rv, t, s


def _streamed(h, w, rh, rv, t, s, chunk):
    """The wrapper's plain path, streamed over ``chunk``-wide vocab
    pieces."""
    U, n, d = h.shape
    hf = h.reshape(-1, d).float()
    er2 = streamed_er2(hf, w, t.reshape(-1).long(), s.reshape(-1), rv, chunk)
    return torch.einsum("unk,unl->ukl", (hf @ rh).reshape(U, n, -1),
                        er2.reshape(U, n, -1))


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


@pytest.mark.parametrize("U,n,d,V,k1,k2,tn,tv,dtype", SHAPES)
def test_plain_versions_match_pallas_and_ref(U, n, d, V, k1, k2, tn, tv,
                                             dtype):
    ins = _inputs(U, n, d, V, k1, k2, seed=n * 7 + V)
    bf16 = dtype == "bfloat16"
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    h, w, rh, rv, t, s = ins
    jh, jw = jnp.asarray(h, jdt), jnp.asarray(w, jdt)
    pallas = np.asarray(grad_sketch_units(
        jh, jw, jnp.asarray(rh), jnp.asarray(rv), jnp.asarray(t),
        jnp.asarray(s), tn=tn, tv=tv, interpret=True))
    ref = np.stack([np.asarray(jax_ref(jh[u], jw, jnp.asarray(rh),
                                       jnp.asarray(rv), jnp.asarray(t[u]),
                                       jnp.asarray(s[u])))
                    for u in range(U)])
    # the same bf16-rounded h and w on the port's side
    th = torch.from_numpy(np.array(jh.astype(jnp.float32))).to(tdt)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(tdt)
    trh, trv, tt, ts = (torch.from_numpy(x) for x in (rh, rv, t, s))
    mat = grad_sketch_units_ref(th, tw, trh, trv, tt, ts).numpy()
    streamed = ops.grad_sketch_units_op(th, tw, trh, trv, tt, ts).numpy()
    tiled = _streamed(th, tw, trh, trv, tt, ts, tv).numpy()
    assert mat.shape == streamed.shape == tiled.shape == (U, k1, k2)
    assert mat.dtype == streamed.dtype == tiled.dtype == np.float32
    tol = 2e-2 if bf16 else 1e-4
    for got in (mat, streamed, tiled):
        assert _rel(got, pallas) < tol
        assert _rel(got, ref) < tol
    if U > 1:
        assert not streamed[1].any() and not mat[1].any()


def test_single_unit_op_is_the_u1_case():
    h, w, rh, rv, t, s = (torch.from_numpy(x)
                          for x in _inputs(1, 50, 24, 400, 12, 12, seed=1))
    got = ops.grad_sketch_op(h[0], w, rh, rv, t[0], s[0])
    want = grad_sketch_ref(h[0], w, rh, rv, t[0], s[0])
    assert got.shape == (12, 12)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


def test_cpu_wrapper_takes_the_plain_path_and_counts_no_launch():
    ins = [torch.from_numpy(x) for x in _inputs(2, 9, 8, 70, 4, 6, seed=2)]
    before = ops.grad_sketch_units_op.launches
    got = ops.grad_sketch_units_op(*ins)
    assert ops.grad_sketch_units_op.launches == before
    torch.testing.assert_close(got, grad_sketch_units_ref(*ins), rtol=0,
                               atol=1e-4 * float(got.abs().max()))


@pytest.mark.parametrize("U,n,V", [(1, 2044, 49152), (3, 23, 131),
                                   (16, 2044, 49152), (1, 1, 1),
                                   (1, 2044, 65536), (2, 300, 1000),
                                   (4, 511, 8195)])
def test_vocab_split_covers_every_tile_once(U, n, V):
    S, per = ops.vocab_splits(U, n, V)
    n_tiles = -(-V // ops.BN)
    assert 1 <= S <= n_tiles and (S - 1) * per < n_tiles <= S * per
