"""PyTorch port, RNN-T loss: the fused ``autograd.Function`` loss and the
dense oracle against the JAX fused loss and dense oracle — NLL and the
three factor gradients (dze, dzp, dw_out) at rtol 1e-4 (the
``tests/test_rnnt_loss.py`` bar) over the edge lengths t_len 1, u_len 0,
u_len U and ragged rows, with one vocab chunk and with chunks that pad
the vocab.  The JAX lattice runs as its Pallas kernel in interpret mode
in one case and through its XLA reference in the others.  The bundle's
``loss_impl="dense"`` path (the dense logits of ``models/rnnt.py:forward``
through the dense oracle, and its stage A from the dense factors) against
the reference's dense bundle, and against the port's fused path, at 1e-4
of the largest entry."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import rnnt_loss as jax_loss  # noqa: E402
from repro_torch.core import rnnt_loss  # noqa: E402
from repro_torch.core.chunking import (auto_vocab_chunk,  # noqa: E402
                                       vocab_chunks)
from repro_torch.kernels.backend import fp32_numerics  # noqa: E402

B, T, U, J, V = 3, 7, 4, 6, 13
EDGE_LENS = [
    ("full", [7, 7, 7], [4, 4, 4]),
    ("t_len_1", [1, 7, 1], [4, 2, 0]),
    ("u_len_0", [7, 5, 3], [0, 0, 0]),
    ("u_len_U", [7, 6, 5], [4, 4, 4]),
    ("ragged", [7, 1, 4], [4, 0, 2]),
]


def _case(seed, t_lens, u_lens):
    rng = np.random.default_rng(seed)
    ze = rng.normal(size=(B, T, J)).astype(np.float32)
    zp = rng.normal(size=(B, U + 1, J)).astype(np.float32)
    w = (rng.normal(size=(J, V)) * 0.5).astype(np.float32)
    labels = rng.integers(1, V, (B, U)).astype(np.int32)
    wgt = rng.uniform(0.5, 1.5, B).astype(np.float32)
    return (ze, zp, w, labels, np.asarray(t_lens, np.int32),
            np.asarray(u_lens, np.int32), wgt)


def _rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _jax_fused(ze, zp, w, labels, tl, ul, wgt, chunk, impl):
    f = lambda ze, zp, w: jnp.sum(jax_loss.rnnt_loss_fused(
        ze, zp, w, labels, tl, ul, vocab_chunk=chunk, lattice_impl=impl)
        * wgt)
    nll = jax_loss.rnnt_loss_fused(jnp.asarray(ze), jnp.asarray(zp),
                                   jnp.asarray(w), labels, tl, ul,
                                   vocab_chunk=chunk, lattice_impl=impl)
    grads = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(ze), jnp.asarray(zp),
                                          jnp.asarray(w))
    return [np.asarray(nll)] + [np.asarray(g) for g in grads]


def _jax_dense(ze, zp, w, labels, tl, ul, wgt):
    def nll_of(ze, zp, w):
        logits = jnp.tanh(ze[:, :, None, :] + zp[:, None, :, :]) @ w
        return jax_loss.rnnt_loss_from_logits(logits, labels, tl, ul)
    grads = jax.grad(lambda *a: jnp.sum(nll_of(*a) * wgt),
                     argnums=(0, 1, 2))(jnp.asarray(ze), jnp.asarray(zp),
                                        jnp.asarray(w))
    nll = nll_of(jnp.asarray(ze), jnp.asarray(zp), jnp.asarray(w))
    return [np.asarray(nll)] + [np.asarray(g) for g in grads]


def _torch(fn, ze, zp, w, labels, tl, ul, wgt):
    xs = [torch.tensor(a, requires_grad=True) for a in (ze, zp, w)]
    nll = fn(*xs, torch.from_numpy(labels), torch.from_numpy(tl),
             torch.from_numpy(ul))
    (nll * torch.from_numpy(wgt)).sum().backward()
    return [nll.detach().numpy()] + [x.grad.numpy() for x in xs]


@pytest.mark.parametrize("name,t_lens,u_lens", EDGE_LENS,
                         ids=[e[0] for e in EDGE_LENS])
@pytest.mark.parametrize("vocab_chunk", [0, 5])
def test_fused_loss_and_grads_match_reference(name, t_lens, u_lens,
                                              vocab_chunk):
    fp32_numerics()
    case = _case(1, t_lens, u_lens)
    impl = "interpret" if (name, vocab_chunk) == ("ragged", 5) else "ref"
    want_fused = _jax_fused(*case, vocab_chunk, impl)
    want_dense = _jax_dense(*case)
    got = _torch(lambda *a: rnnt_loss.rnnt_loss_fused(
        *a, vocab_chunk=vocab_chunk), *case)
    for what, g, wf, wd in zip(("nll", "dze", "dzp", "dw_out"), got,
                               want_fused, want_dense):
        assert g.shape == wf.shape, what
        assert _rel(g, wf) < 1e-4, (what, _rel(g, wf))
        assert _rel(g, wd) < 1e-4, (what, _rel(g, wd))


@pytest.mark.parametrize("name,t_lens,u_lens", EDGE_LENS[::2],
                         ids=[e[0] for e in EDGE_LENS[::2]])
def test_dense_oracle_matches_reference(name, t_lens, u_lens):
    """The port's dense oracle (autograd through the plain lattice)."""
    case = _case(2, t_lens, u_lens)
    want = _jax_dense(*case)

    def dense(ze, zp, w, labels, tl, ul):
        logits = torch.tanh(ze[:, :, None, :] + zp[:, None, :, :]) @ w
        return rnnt_loss.rnnt_loss_from_logits(logits, labels, tl, ul)

    got = _torch(dense, *case)
    for what, g, wd in zip(("nll", "dze", "dzp", "dw_out"), got, want):
        assert _rel(g, wd) < 1e-4, (what, _rel(g, wd))


def test_chunk_layout_and_auto_chunk_match_reference():
    from repro.core import chunking as jax_chunking
    w = np.random.default_rng(0).normal(size=(6, 13)).astype(np.float32)
    for chunk in (13, 5, 4):
        got_x, got_m = vocab_chunks(torch.from_numpy(w), chunk, axis=1)
        want_x, want_m = jax_chunking.vocab_chunks(jnp.asarray(w), chunk,
                                                   axis=1)
        np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    for rows, v in ((1156, 1000), (5000, 1000), (40000, 32000), (10, 37)):
        assert auto_vocab_chunk(rows, v) == \
            jax_chunking.auto_vocab_chunk(rows, v)


@pytest.mark.parametrize("Bq,U1,Jq,Vq", [(3, 5, 6, 13), (4, 33, 16, 1000),
                                         (2, 9, 4, 3)])
def test_label_columns_match_the_index_add_scatter(Bq, U1, Jq, Vq):
    """The fused backward's label-column sum, a one-hot product (its
    order fixed), against the ``index_add_`` scatter it replaced (an
    atomic, unordered sum on the card), on labels with repeats: within
    1e-6 of the largest entry."""
    rng = np.random.default_rng(Vq)
    lab = rng.integers(0, Vq, (Bq, U1))
    lab[:, ::3] = lab[0, 0]                   # one column label many times
    lab = torch.from_numpy(lab)
    rows = torch.from_numpy(rng.normal(size=(Bq, U1, Jq)).astype(np.float32))
    assert torch.unique(lab).numel() < lab.numel()
    want = torch.zeros((Vq, Jq)).index_add_(
        0, lab.reshape(-1), rows.reshape(-1, Jq)).t()
    got = rnnt_loss.label_columns(lab, rows, Vq)
    assert got.shape == (Jq, Vq)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-6 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# loss_impl="dense": the bundle's opt-in oracle path against the reference's
# ---------------------------------------------------------------------------

ARCH = "rnnt-crdnn-smoke"


def _bundles(loss_impl):
    import dataclasses

    from repro.configs import get_config as jax_get_config
    from repro.models.api import build_model as jax_build
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model

    def with_impl(cfg):
        return dataclasses.replace(
            cfg, rnnt=dataclasses.replace(cfg.rnnt, loss_impl=loss_impl))

    return (jax_build(with_impl(jax_get_config(ARCH))),
            build_model(with_impl(get_config(ARCH))))


def _unit_and_params(seed=0):
    from repro.configs import get_config as jax_get_config
    from repro.data.pipeline import asr_units
    from repro.data.synthetic import make_asr_corpus
    r = jax_get_config(ARCH).rnnt
    u = asr_units(make_asr_corpus(seed, 4, n_feats=r.n_feats,
                                  vocab_size=r.vocab_size), 4)
    batch = {k: v[0] for k, v in u.items()}
    batch["weights"] = np.asarray([1.0, 0.5, 2.0, 0.25], np.float32)
    mj, _ = _bundles("dense")
    params = jax.tree.map(np.asarray,
                          mj.init_params(jax.random.PRNGKey(seed)))
    return batch, params


def _port_loss_and_grads(bundle, params, batch):
    from repro_torch.convert import from_numpy
    from repro_torch.models.common import tree_leaves
    p = from_numpy(params)
    leaves = tree_leaves(p)
    for l in leaves:
        l.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    per_ex = bundle.per_example_loss(p, tb)
    total, _ = bundle.loss_fn(p, tb)
    grads = torch.autograd.grad(total, leaves)
    return per_ex.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_bundle_matches_reference_dense_bundle(seed):
    """``per_example_nll`` dispatches on ``loss_impl``: the port's dense
    path (``forward`` -> ``rnnt_loss_from_logits``, autograd) against the
    reference's dense path (``jax.grad``): per-example loss and every
    parameter's gradient of the weighted training loss within 1e-4 of
    the largest entry."""
    fp32_numerics()
    batch, params = _unit_and_params(seed)
    mj, mt = _bundles("dense")
    jb = jax.tree.map(jnp.asarray, batch)
    want_ex = np.asarray(mj.per_example_loss(params, jb))
    want_g = [np.asarray(g) for g in jax.tree.leaves(jax.grad(
        lambda p: mj.loss_fn(p, jb)[0])(params))]
    got_ex, got_g = _port_loss_and_grads(mt, params, batch)
    assert _rel(got_ex, want_ex) < 1e-4
    assert len(got_g) == len(want_g) == 21
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        assert _rel(g, w) < 1e-4, (i, _rel(g, w))


def test_dense_and_fused_bundles_agree():
    """The same function twice in the port: per-example loss and every
    gradient within 1e-4 of the largest entry (two fp32 summation
    orders, the reference's dense-vs-fused bar)."""
    fp32_numerics()
    batch, params = _unit_and_params(2)
    (_, fused), (_, dense) = _bundles("fused"), _bundles("dense")
    l_f, g_f = _port_loss_and_grads(fused, params, batch)
    l_d, g_d = _port_loss_and_grads(dense, params, batch)
    assert _rel(l_d, l_f) < 1e-4
    for i, (a, b) in enumerate(zip(g_d, g_f)):
        assert _rel(a, b) < 1e-4, (i, _rel(a, b))


@pytest.mark.parametrize("exact", [False, True])
def test_dense_stage_a_matches_reference(exact):
    """Stage A under ``loss_impl="dense"`` takes the dense oracle's
    factors (joint activations, the logits' autograd gradient), as the
    reference's does: the unit vector within 1e-4 of the largest
    entry, and within 1e-4 of the fused stage A's."""
    from repro.core.lastlayer import make_proj_for as jax_make_proj
    from repro.core.lastlayer import unit_gradient as jax_unit_gradient
    from repro_torch.convert import from_numpy
    from repro_torch.core.lastlayer import unit_gradient
    from repro_torch.core.sketch import Projections
    fp32_numerics()
    batch, params = _unit_and_params(3)
    mj, mt = _bundles("dense")
    proj = jax_make_proj(mj, jax.random.PRNGKey(17), 8, 16)
    want = np.asarray(jax_unit_gradient(
        mj, params, jax.tree.map(jnp.asarray, batch), proj, exact))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tproj = Projections(*(torch.from_numpy(np.array(x)) for x in proj))
    got = unit_gradient(mt, from_numpy(params), tb, tproj, exact).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-4
    fused = unit_gradient(_bundles("fused")[1], from_numpy(params), tb,
                          tproj, exact).numpy()
    assert _rel(got, fused) < 1e-4


def test_loss_impl_is_checked_and_survives_autotune():
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.train.engine import autotune_loss_vocab_chunk
    with pytest.raises(ValueError, match="loss_impl"):
        _bundles("sparse")
    import dataclasses
    cfg = get_config("rnnt-crdnn")
    cfg = dataclasses.replace(
        cfg, rnnt=dataclasses.replace(cfg.rnnt, loss_impl="dense"))
    bundle, chunk = autotune_loss_vocab_chunk(
        build_model(cfg), {"tokens": np.zeros((2, 4, 64), np.int32)}, 8)
    assert chunk < 1000 and bundle.cfg.rnnt.loss_vocab_chunk == chunk
    assert bundle.cfg.rnnt.loss_impl == "dense"
