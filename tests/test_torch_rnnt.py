"""PyTorch port, CRDNN RNN-T model: the converter round trip (bit-exact)
and ``encode``/``predict``/``joint_factors``/``joint_hidden``/
``joint_logits`` against the JAX reference on converted
``rnnt-crdnn-smoke`` parameters, fp32 with TF32 off, within 1e-5.

Covers the padding/recurrence hazards: JAX ``SAME`` stride-2 padding on
even and odd sizes, the LSTM's ``sigmoid(f + 1)`` and reversed full-T'
backward direction, and the GRU's bias-free ``h @ wh`` under r.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import rnnt as jax_rnnt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_numpy, to_numpy  # noqa: E402
from repro_torch.kernels.backend import fp32_numerics  # noqa: E402
from repro_torch.models import rnnt  # noqa: E402

ARCH = "rnnt-crdnn-smoke"


@pytest.fixture(scope="module")
def params():
    fp32_numerics()
    p = jax_rnnt.init_params(jax_get_config(ARCH), jax.random.PRNGKey(3))
    return jax.tree.map(np.asarray, p)


def _inputs(B, T, U, seed=0):
    r = get_config(ARCH).rnnt
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, T, r.n_feats)).astype(np.float32)
    tokens = rng.integers(1, r.vocab_size, (B, U)).astype(np.int32)
    return feats, tokens


def test_converter_round_trip_is_bit_exact(params):
    tp = from_numpy(params)
    back = to_numpy(tp)
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree.leaves(back))
    for path, a in flat:
        b = back
        for k in path:
            b = b[k.key]
        assert b.dtype == a.dtype and b.shape == a.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path
    assert tp["joint"]["w_out"].shape == params["joint"]["w_out"].shape


def test_torch_init_matches_reference_layout(params):
    mine = rnnt.init_params(get_config(ARCH), torch.Generator().manual_seed(0),
                            torch.device("cpu"))
    want = jax.tree.map(lambda a: a.shape, params)
    got = jax.tree.map(lambda t: tuple(t.shape), mine)
    assert got == want


@pytest.mark.parametrize("T", [32, 29, 8])
def test_encode_matches_reference(params, T):
    feats, _ = _inputs(3, T, 4, seed=T)
    want = np.asarray(jax_rnnt.encode(params, jax_get_config(ARCH),
                                      jnp.asarray(feats)))
    got = rnnt.encode(from_numpy(params), get_config(ARCH),
                      torch.from_numpy(feats)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_predict_and_joint_match_reference(params):
    feats, tokens = _inputs(2, 24, 6, seed=1)
    cj, ct = jax_get_config(ARCH), get_config(ARCH)
    tp = from_numpy(params)
    pred_w = np.asarray(jax_rnnt.predict(params, cj, jnp.asarray(tokens)))
    pred_g = rnnt.predict(tp, ct, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(pred_g, pred_w, atol=1e-5, rtol=1e-5)

    ze_w, zp_w = jax_rnnt.joint_factors(params, cj, jnp.asarray(feats),
                                        jnp.asarray(tokens))
    ze_g, zp_g = rnnt.joint_factors(tp, ct, torch.from_numpy(feats),
                                    torch.from_numpy(tokens))
    np.testing.assert_allclose(ze_g.numpy(), np.asarray(ze_w), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(zp_g.numpy(), np.asarray(zp_w), atol=1e-5,
                               rtol=1e-5)

    enc_w = jax_rnnt.encode(params, cj, jnp.asarray(feats))
    z_w = jax_rnnt.joint_hidden(params, enc_w, jnp.asarray(pred_w))
    logits_w = np.asarray(jax_rnnt.joint_logits(params, z_w))
    enc_g = rnnt.encode(tp, ct, torch.from_numpy(feats))
    z_g = rnnt.joint_hidden(tp, enc_g, torch.from_numpy(pred_g))
    logits_g = rnnt.joint_logits(tp, z_g).numpy()
    np.testing.assert_allclose(logits_g, logits_w, atol=1e-5, rtol=1e-5)


def test_same_padding_matches_xla():
    """(lo, hi) of JAX SAME for a 3-wide stride-2 window."""
    assert rnnt._same_pad(16) == (0, 1)
    assert rnnt._same_pad(15) == (1, 1)
    assert rnnt._same_pad(2) == (0, 1)
    assert rnnt._same_pad(1) == (1, 1)


def test_fp32_numerics_makes_cudnn_deterministic():
    """F3: with ``cudnn.deterministic`` False the CRDNN's convolution
    gradients differed from run to run on an H100, so ``fp32_numerics``
    (which every launcher and ``chip_smoke.py`` call) turns cuDNN's
    deterministic algorithms on and its timing-based choice off, beside
    TF32 off everywhere."""
    bk = torch.backends
    saved = (bk.cudnn.deterministic, bk.cudnn.benchmark, bk.cudnn.allow_tf32,
             bk.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    try:
        bk.cudnn.deterministic, bk.cudnn.benchmark = False, True
        bk.cudnn.allow_tf32 = bk.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        fp32_numerics()
        assert bk.cudnn.deterministic and not bk.cudnn.benchmark
        assert not bk.cudnn.allow_tf32 and not bk.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        (bk.cudnn.deterministic, bk.cudnn.benchmark, bk.cudnn.allow_tf32,
         bk.cuda.matmul.allow_tf32) = saved[:4]
        torch.set_float32_matmul_precision(saved[4])
