"""PyTorch port on the card (marker ``cuda``; skipped without an NVIDIA
GPU, since a CUDA kernel has no CPU mode).  Imports no JAX, so it runs on
a machine that has only PyTorch:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each Hopper kernel is held against its plain PyTorch version on the same
card tensors (which the CPU tests hold against the JAX reference), at
ragged edge shapes; the WKV backward kernel against autograd of the
plain chunk algebra; the sliding-window attention kernel against its
plain band gather (and its refused backward); the fused loss against the
same loss on the CPU.  TF32 is off throughout (``backend.fp32_numerics``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.rnnt_loss import rnnt_loss_fused  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402
from repro_torch.kernels.grad_sketch.ops import (  # noqa: E402
    grad_sketch_op, grad_sketch_units_op)
from repro_torch.kernels.grad_sketch.ref import (  # noqa: E402
    grad_sketch_units_ref)
from repro_torch.kernels.omp_gram.ops import omp_gram_batched_op  # noqa: E402
from repro_torch.kernels.omp_gram.ref import omp_gram_batched_ref  # noqa: E402
from repro_torch.kernels.rnnt_lattice.ops import rnnt_lattice_op  # noqa: E402
from repro_torch.kernels.rnnt_lattice.ref import (  # noqa: E402
    NEG, rnnt_lattice_ref)
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_wkv_op  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import (  # noqa: E402
    log_decay, wkv_chunked_lw)
from repro_torch.kernels.swa_attn.ops import swa_attn_op  # noqa: E402
from repro_torch.kernels.swa_attn.ref import swa_attn_ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    backend.fp32_numerics()
    return torch.device("cuda")


def _lattice_inputs(T, B, U1, seed):
    rng = np.random.default_rng(seed)
    mult = rng.normal(size=(T, B, U1)).astype(np.float32)
    add = np.where(rng.uniform(size=(T, B, U1)) < 0.3,
                   rng.normal(size=(T, B, U1)), NEG).astype(np.float32)
    emit = rng.normal(size=(T, B, U1)).astype(np.float32)
    emit[:, :, 0] = NEG
    return mult, add, emit


@pytest.mark.parametrize("U1", [1, 2, 5, 17, 33, 65, 129, 257, 1186,
                                12288])
@pytest.mark.parametrize("T", [1, 9])
def test_lattice_kernel_matches_plain(card, T, U1):
    """Two launches bitwise equal, within atol 1e-4 / rtol 1e-5 of the
    plain version; U1 257, 1,186 (the first row too wide for the 16-row
    ring) and 12,288 (a ring of one row) beside the reference's shapes."""
    ins = [torch.from_numpy(x).to(card)
           for x in _lattice_inputs(T, 3, U1, seed=U1)]
    n0 = rnnt_lattice_op.launches
    got = rnnt_lattice_op(*ins)
    again = rnnt_lattice_op(*ins)
    torch.cuda.synchronize()
    assert rnnt_lattice_op.launches == n0 + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, rnnt_lattice_ref(*ins),
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("P,n,D", [(1, 1, 1), (4, 4, 4096), (3, 65, 130),
                                   (2, 130, 4099), (8, 512, 4096),
                                   (2, 1000, 4096), (5, 33, 1),
                                   (1, 257, 777)])
def test_gram_kernel_matches_plain(card, P, n, D):
    """Within 1e-4 of the largest |K| (two fp32 summation orders over D),
    two launches bitwise equal (D split without atomics), and exactly
    symmetric (each upper tile written with its mirror)."""
    g = torch.randn(P, n, D, generator=torch.Generator().manual_seed(n)
                    ).to(card)
    n0 = omp_gram_batched_op.launches
    got = omp_gram_batched_op(g)
    again = omp_gram_batched_op(g)
    torch.cuda.synchronize()
    assert omp_gram_batched_op.launches == n0 + 2
    assert torch.equal(got, again)
    assert torch.equal(got, got.transpose(1, 2))
    want = omp_gram_batched_ref(g)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    x = torch.zeros(2, 3, 4, device=card)
    with pytest.raises(TypeError):
        rnnt_lattice_op(x.double(), x.double(), x.double())
    with pytest.raises(ValueError):
        rnnt_lattice_op(x.transpose(0, 1), x.transpose(0, 1),
                        x.transpose(0, 1))
    with pytest.raises(ValueError):
        omp_gram_batched_op(x[0])


def test_fused_loss_on_card_matches_cpu(card):
    """The fused loss and its factor gradients through the lattice
    kernel, against the same loss on the CPU (plain lattice)."""
    rng = np.random.default_rng(0)
    B, T, U, J, V = 3, 16, 5, 8, 29
    ze = rng.normal(size=(B, T, J)).astype(np.float32)
    zp = rng.normal(size=(B, U + 1, J)).astype(np.float32)
    w = (rng.normal(size=(J, V)) * 0.5).astype(np.float32)
    labels = rng.integers(1, V, (B, U))
    t_lens, u_lens = np.array([16, 1, 9]), np.array([5, 0, 3])
    out = {}
    for dev in ("cpu", card):
        xs = [torch.tensor(a, device=dev, requires_grad=True)
              for a in (ze, zp, w)]
        nll = rnnt_loss_fused(*xs, torch.tensor(labels, device=dev),
                              torch.tensor(t_lens, device=dev),
                              torch.tensor(u_lens, device=dev),
                              vocab_chunk=8)
        nll.sum().backward()
        out[str(dev)] = [nll.detach().cpu()] + [x.grad.cpu() for x in xs]
    for a, b in zip(out["cpu"], out["cuda"]):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-5)


def test_fused_loss_dw_out_is_bitwise_repeatable(card):
    """The fused backward's dw_out (stage A's unit vector on the RNN-T
    path) twice on the same inputs: the same bits.  Its label columns are
    summed by a product, not by an atomic scatter."""
    rng = np.random.default_rng(3)
    B, T, U, J, V = 4, 32, 12, 64, 50
    ze = torch.tensor(rng.normal(size=(B, T, J)).astype(np.float32),
                      device=card)
    zp = torch.tensor(rng.normal(size=(B, U + 1, J)).astype(np.float32),
                      device=card)
    w0 = (rng.normal(size=(J, V)) * 0.5).astype(np.float32)
    labels = torch.tensor(rng.integers(1, 4, (B, U)), device=card)
    lens = (torch.tensor([32, 20, 9, 32], device=card),
            torch.tensor([12, 7, 3, 12], device=card))
    grads = []
    for _ in range(2):
        w = torch.tensor(w0, device=card, requires_grad=True)
        rnnt_loss_fused(ze, zp, w, labels, *lens, vocab_chunk=16
                        ).sum().backward()
        grads.append(w.grad)
    torch.cuda.synchronize()
    assert torch.isfinite(grads[0]).all()
    assert torch.equal(grads[0], grads[1])


def test_rnnt_training_gradient_is_bitwise_repeatable(card):
    """F3: the full-width ``rnnt-crdnn`` training loss's gradient, twice
    from the same params and batch, equal bit for bit on every leaf.
    With ``cudnn.deterministic`` False (before ``fp32_numerics`` set it)
    the convolution leaves differed from run to run."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import asr_units
    from repro_torch.data.synthetic import make_asr_corpus
    from repro_torch.models.api import build_model
    from repro_torch.models.common import tree_leaves, tree_map

    bundle = build_model(get_config("rnnt-crdnn"))
    corpus = make_asr_corpus(0, n_examples=4, n_feats=80, vocab_size=1000,
                             min_tokens=16, max_tokens=32,
                             frames_per_token=16, noise_fraction=0.25,
                             snr_db=5.0)
    batch = {k: torch.as_tensor(v[0]).to(card)
             for k, v in asr_units(corpus, 4).items()}
    params = bundle.init_params(torch.Generator().manual_seed(0), card)
    grads = []
    for _ in range(2):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        total, _ = bundle.loss_fn(live, batch)
        grads.append(torch.autograd.grad(total, tree_leaves(live)))
    torch.cuda.synchronize()
    assert len(grads[0]) == len(tree_leaves(params))
    for a, b in zip(*grads):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)


def _sketch_inputs(U, n, d, V, k1, k2, seed, dev):
    """Logits of std 4 (w scaled by 4/sqrt(d)), so the softmax is peaked
    and its p.R2 term carries a good part of the sketch; unit 1 (when
    there is one) has an all-zero scale row set."""
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(U, n, d, generator=g)
    wt = torch.randn(V, d, generator=g) * (4 / d ** 0.5)
    rh = torch.randn(d, k1, generator=g)
    rv = torch.randn(V, k2, generator=g)
    t = torch.randint(0, V, (U, n), generator=g, dtype=torch.int32)
    s = torch.rand(U, n, generator=g) + 0.5
    if U > 1:
        s[1] = 0.0
    h, wt, rh, rv, t, s = (x.to(dev) for x in (h, wt, rh, rv, t, s))
    return h, wt.t(), rh, rv, t, s            # w (d, V) as the tied head's view


@pytest.mark.parametrize("U,n,d,V,k1,k2", [
    (1, 2044, 3072, 49152, 64, 64),            # the LM main path's unit
    (1, 1, 1, 1, 1, 1), (1, 17, 16, 64, 8, 8), (3, 130, 72, 1001, 24, 40),
    (2, 65, 33, 4099, 64, 100), (4, 511, 256, 8195, 70, 64),
    (2, 300, 128, 1000, 32, 72)])              # n and V off the 128 tile
def test_grad_sketch_kernel_matches_plain(card, U, n, d, V, k1, k2):
    ins = _sketch_inputs(U, n, d, V, k1, k2, seed=n + V, dev=card)
    n0 = grad_sketch_units_op.launches
    got = grad_sketch_units_op(*ins)
    again = grad_sketch_units_op(*ins)
    torch.cuda.synchronize()
    assert grad_sketch_units_op.launches == n0 + 2
    assert got.shape == (U, k1, k2) and torch.equal(got, again)
    want = grad_sketch_units_ref(*ins)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    # also within 1e-4 of the vocab pass's own part (hr^T (p R2) scale),
    # which the target term R2[t] computed outside the kernel can dwarf
    h, _, rh, rv, t, s = ins
    vocab = want + torch.einsum("unk,unl->ukl", h @ rh,
                                rv[t.long()] * s[..., None])
    assert float((got - want).abs().max()) \
        <= 1e-4 * float(vocab.abs().max())
    if U > 1:
        assert not got[1].any()
    one = grad_sketch_op(ins[0][0], ins[1], ins[2], ins[3], ins[4][0],
                         ins[5][0])
    torch.testing.assert_close(one, got[0], rtol=0,
                               atol=1e-5 * float(got[0].abs().max()))


def test_grad_sketch_wrapper_refuses_what_the_kernel_does_not_take(card):
    h, w, rh, rv, t, s = _sketch_inputs(1, 8, 16, 70, 4, 4, seed=0, dev=card)
    with pytest.raises(TypeError):
        grad_sketch_units_op(h.double(), w, rh, rv, t, s)
    with pytest.raises(TypeError):
        grad_sketch_units_op(h, w.half(), rh, rv, t, s)
    with pytest.raises(ValueError):                  # (d, V) contiguous head
        grad_sketch_units_op(h, w.contiguous(), rh, rv, t, s)
    with pytest.raises(ValueError):
        grad_sketch_units_op(h.transpose(1, 2).contiguous().transpose(1, 2),
                             w, rh, rv, t, s)
    with pytest.raises(ValueError):
        grad_sketch_units_op(h, w, rh, rv, t, s.t())
    with pytest.raises(ValueError):                  # a CPU tensor in the mix
        grad_sketch_units_op(h, w, rh, rv, t.cpu(), s)


def _wkv_inputs(B, S, H, N, seed, dev, w=None):
    """r, k, v standard normal; decays in (0.4, 0.99), all equal to ``w``,
    or for ``w == "mixed"`` by channel n: n % 3 == 0 below the 1e-8 clip,
    1 at 0.999, 2 in (0.4, 0.99); u of scale 0.1; lw = log(clip(w, 1e-8,
    1))."""
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn(B, S, H, N, generator=g) for _ in range(3))
    ww = torch.rand(B, S, H, N, generator=g) * 0.59 + 0.4
    if w == "mixed":
        n = torch.arange(N) % 3
        ww = torch.where(n == 0, 1e-9, torch.where(n == 1, 0.999, ww))
    elif w is not None:
        ww = torch.full((B, S, H, N), w)
    u = torch.randn(H, N, generator=g) * 0.1
    cy = torch.randn(B, S, H, N, generator=g)
    cs = torch.randn(B, H, N, N, generator=g) * 0.1
    return [x.to(dev) for x in (r, k, v, log_decay(ww), u)], \
        (cy.to(dev), cs.to(dev))


def _wkv_run(fn, ins, cots, C):
    xs = [x.clone().requires_grad_(True) for x in ins]
    y, s = fn(*xs, C)
    (torch.sum(y * cots[0]) + torch.sum(s * cots[1])).backward()
    return [y.detach(), s.detach()] + [x.grad for x in xs]


def _wkv_plain(r, k, v, lw, u, C):
    B, _, H, N = r.shape
    return wkv_chunked_lw(r, k, v, lw, u,
                          torch.zeros(B, H, N, N, device=r.device), C)


@pytest.mark.parametrize("B,S,H,N,C,w", [
    (4, 512, 40, 64, 64, None),               # the rwkv6-3b main path
    (2, 64, 2, 16, 16, None), (1, 128, 3, 32, 32, None),
    (2, 96, 1, 8, 32, None), (1, 64, 2, 64, 64, None),
    (1, 64, 1, 8, 16, 1e-6),                  # decays near zero
    (1, 128, 2, 64, 64, 1e-8),                # every decay at the clip
    (2, 128, 2, 64, 64, "mixed"), (1, 96, 1, 16, 32, "mixed"),
    (2, 32, 2, 16, 32, "mixed"),              # one chunk (S = C)
    (1, 128, 2, 64, 32, 1e-8)])               # C = 32 at N = 64
def test_wkv_kernels_match_plain_autograd(card, B, S, H, N, C, w):
    """Forward (y, final state) and backward (dr, dk, dv, dlw, du) with
    cotangents on both outputs, against autograd of the plain chunk
    algebra on the same card tensors, each within 1e-4 of its largest
    entry; two launches agree bit for bit.  At decays of 1e-6, dlw's
    true entries (~2e-5) lie below the fp32 rounding of the terms that
    cancel in it (autograd of the plain version is itself ~3% of its
    largest entry off its fp64 value there, ``scripts/rwkv6_numerics.py``),
    so it is held finite and within 1e-5 of the largest dr entry; so at
    the 1e-8 clip and at mixed decays, whose channels at the clip have
    the same cancellation."""
    ins, cots = _wkv_inputs(B, S, H, N, seed=S + N, dev=card, w=w)
    n0, b0 = rwkv6_wkv_op.launches, rwkv6_wkv_op.bwd_launches
    got = _wkv_run(rwkv6_wkv_op, ins, cots, C)
    again = _wkv_run(rwkv6_wkv_op, ins, cots, C)
    torch.cuda.synchronize()
    assert rwkv6_wkv_op.launches == n0 + 2
    assert rwkv6_wkv_op.bwd_launches == b0 + 2
    want = _wkv_run(_wkv_plain, ins, cots, C)
    names = ("y", "state", "dr", "dk", "dv", "dlw", "du")
    for name, a, b, c in zip(names, got, again, want):
        assert torch.isfinite(a).all(), name
        assert torch.equal(a, b), name
        scale = float((want[2] if name == "dlw" and w else c).abs().max())
        tol = 1e-5 if name == "dlw" and w else 1e-4
        torch.testing.assert_close(a, c, rtol=0, atol=tol * scale, msg=name)


def test_wkv_wrapper_refuses_what_the_kernels_do_not_take(card):
    (r, k, v, lw, u), _ = _wkv_inputs(1, 128, 2, 16, seed=0, dev=card)
    with pytest.raises(TypeError):
        rwkv6_wkv_op(r.double(), k, v, lw, u, 64)
    with pytest.raises(ValueError):                  # non-contiguous
        rwkv6_wkv_op(r.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                     lw, u, 64)
    with pytest.raises(ValueError):                  # S % C != 0
        rwkv6_wkv_op(r, k, v, lw, u, 48)
    with pytest.raises(ValueError):                  # chunk above 64
        rwkv6_wkv_op(r, k, v, lw, u, 128)
    with pytest.raises(ValueError):                  # u of another shape
        rwkv6_wkv_op(r, k, v, lw, u[:1], 64)
    with pytest.raises(ValueError):                  # a CPU tensor in the mix
        rwkv6_wkv_op(r, k, v, lw, u.cpu(), 64)
    big = torch.zeros(1, 64, 1, 65, device=card)     # head dim above 64
    with pytest.raises(ValueError):
        rwkv6_wkv_op(big, big, big, big, torch.zeros(1, 65, device=card), 64)


# (B, S, KV, G, hd, window, dtype, lengths): the serving prefill shape
# (starcoder2-3b, one 8,192-token prompt) in bf16 and fp32, then S off the
# 64-row tile and off 1024, a window below the tile, a window above S,
# per-row lengths, fp32; then the bf16 tensor-core body's edges: S off its
# 192-row q tile and off 128 (129, 1100), windows off its 64-key tile (1,
# 63, 200), every head dim, and per-row lengths of 1 and S, of S - 1 and 70
SWA_EDGES = [
    (1, 8192, 2, 12, 128, 4096, "bfloat16", None),
    (1, 8192, 2, 12, 128, 4096, "float32", None),
    (1, 1100, 2, 12, 128, 256, "bfloat16", None),
    (1, 300, 2, 3, 64, 16, "bfloat16", None),
    (1, 200, 1, 2, 32, 512, "bfloat16", None),
    (2, 1500, 2, 4, 128, 700, "bfloat16", (1500, 1033)),
    (2, 777, 2, 2, 16, 100, "float32", (5, 777)),
    (1, 2048, 2, 12, 128, 1024, "float32", None),
    (1, 129, 2, 3, 128, 200, "bfloat16", None),
    (1, 1100, 1, 4, 16, 63, "bfloat16", None),
    (1, 1100, 2, 2, 32, 1, "bfloat16", None),
    (1, 1100, 1, 3, 64, 200, "bfloat16", None),
    (2, 700, 2, 2, 128, 300, "bfloat16", (1, 700)),
    (2, 700, 1, 3, 64, 63, "bfloat16", (699, 70)),
]


def _swa_inputs(B, S, KV, G, hd, dtype, seed, dev):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, KV, G, hd, generator=g)
    k, v = (torch.randn(B, S, KV, hd, generator=g) for _ in range(2))
    return [x.to(device=dev, dtype=getattr(torch, dtype)) for x in (q, k, v)]


@pytest.mark.parametrize("B,S,KV,G,hd,W,dtype,lengths", SWA_EDGES)
def test_swa_kernel_matches_plain(card, B, S, KV, G, hd, W, dtype, lengths):
    q, k, v = _swa_inputs(B, S, KV, G, hd, dtype, seed=S + hd, dev=card)
    lens = (None if lengths is None
            else torch.tensor(lengths, dtype=torch.int32, device=card))
    n0 = swa_attn_op.launches
    got = swa_attn_op(q, k, v, window=W, lengths=lens)
    again = swa_attn_op(q, k, v, window=W, lengths=lens)
    torch.cuda.synchronize()
    assert swa_attn_op.launches == n0 + 2
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.equal(got, again)                   # no atomics
    want = swa_attn_ref(q, k, v, window=W, lengths=lens).float()
    # both sum in fp32 in different orders: at bf16 both round to bf16, so
    # each element is held to one bf16 ulp of its own value; at fp32 to
    # 1e-5 of the largest entry (and the reference tests' 1e-4)
    if dtype == "float32":
        atol = min(1e-4, 1e-5 * float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=0, atol=atol)
    else:
        torch.testing.assert_close(got.float(), want, rtol=2.0 ** -7,
                                   atol=1e-5)


def test_swa_backward_raises_and_wrapper_refuses(card):
    q, k, v = _swa_inputs(1, 128, 1, 2, 32, "float32", seed=0, dev=card)
    q.requires_grad_(True)
    out = swa_attn_op(q, k, v, window=64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        out.sum().backward()
    with pytest.raises(TypeError):                   # fp16
        swa_attn_op(q.detach().half(), k.half(), v.half(), window=64)
    with pytest.raises(ValueError):                  # head dim 48
        swa_attn_op(torch.zeros(1, 8, 1, 1, 48, device=card),
                    torch.zeros(1, 8, 1, 48, device=card),
                    torch.zeros(1, 8, 1, 48, device=card), window=4)
    with pytest.raises(ValueError):                  # non-contiguous k
        swa_attn_op(q.detach(), torch.zeros(1, 128, 1, 64, device=card
                                            )[..., :32], v, window=64)
    with pytest.raises(ValueError):                  # lengths not int32
        swa_attn_op(q.detach(), k, v, window=64,
                    lengths=torch.tensor([5], device=card))
    # bf16 q contiguous but 2 bytes off the 16 its rows are copied in
    qm = torch.zeros(128 * 2 * 32 + 1, device=card,
                     dtype=torch.bfloat16)[1:].view(1, 128, 1, 2, 32)
    with pytest.raises(RuntimeError):
        swa_attn_op(qm, k.bfloat16(), v.bfloat16(), window=64)
