"""PyTorch port on the card (marker ``cuda``; skipped without an NVIDIA
GPU, since a CUDA kernel has no CPU mode).  Imports no JAX, so it runs on
a machine that has only PyTorch:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each Hopper kernel is held against its plain PyTorch version on the same
card tensors (which the CPU tests hold against the JAX reference), at
ragged edge shapes; the WKV backward kernel against autograd of the
plain chunk algebra; the sliding-window attention kernels against their
plain versions (the forward against the band gather, the forward with
lse bitwise the serving forward, the backward against the plain
backward, bitwise twice), group remat bitwise on the card; the fused
loss against the
same loss on the CPU.  The scanned epoch engine: a replayed epoch equals
the same epoch run on the card without the graph bit for bit, padding
rows are bitwise no-ops through the graph, a traced replayed epoch
runs each step kernel per-step launches x rows times while the launch
counters (which count at the launch site) see only the warm-up and the
capture, and a host sync planted in the step makes the capture raise.
Resident selection: stage A captured once a corpus and replayed bitwise,
within 1e-5 of the host stage A, on fresh params after they change; an
injected kernel failure raises on the card; the grad-sketch kernel at
U = 4 inside a graph equals its eager launch; the MoE router term's
captured backward replays bitwise.  The MoE layer: two runs bitwise,
the card within 1e-5 of the CPU.  The band at head dim 256; the WKV
forward with a padded prefill's pad rows; a slot decode of both
recurrent families leaving a dead slot's state bit-exact.  TF32 is off
throughout (``backend.fp32_numerics``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

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
from repro_torch.kernels.swa_attn.ops import _launch as swa_fwd_with_lse  # noqa: E402
from repro_torch.kernels.swa_attn.ops import (swa_attn_bwd,  # noqa: E402
                                              swa_attn_op)
from repro_torch.kernels.swa_attn.ref import (swa_attn_bwd_ref,  # noqa: E402
                                              swa_attn_ref)
from repro_torch.train.engine import EpochEngine  # noqa: E402

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
                                   (1, 257, 777),
                                   # exact stage B: a unit's flattened
                                   # dw_out at full width, 1,024 x 1,000
                                   (4, 4, 1024000)])
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


def _full_width_step(card):
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import asr_units
    from repro_torch.data.synthetic import make_asr_corpus
    from repro_torch.models.api import build_model

    bundle = build_model(get_config("rnnt-crdnn"))
    corpus = make_asr_corpus(0, n_examples=4, n_feats=80, vocab_size=1000,
                             min_tokens=16, max_tokens=32,
                             frames_per_token=16)
    batch = {k: torch.as_tensor(v[0]).to(card)
             for k, v in asr_units(corpus, 4).items()}
    return bundle, batch, bundle.init_params(
        torch.Generator().manual_seed(0), card)


def test_checkpoint_of_card_tensors_restores_bitwise_onto_card(card,
                                                               tmp_path):
    """Full-width params and AdamW state on the card, saved and restored
    with themselves as the template: every leaf back on the card, bit
    for bit, dtypes kept (the int32 step included)."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optim import adamw_init

    _, _, params = _full_width_step(card)
    opt = adamw_init(params)
    opt["m"] = {k: {n: torch.randn_like(v) for n, v in d.items()}
                for k, d in opt["m"].items()}
    tree = {"params": params, "opt": opt}
    ckpt.save(str(tmp_path), 0, tree, extra={"epoch": 0})
    got, manifest = ckpt.restore(str(tmp_path), template=tree)
    assert manifest["extra"] == {"epoch": 0}
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_guarded_off_step_is_bitwise_on_card(card):
    """G1 on the card: a full-width step on a NaN weight leaves params
    and the AdamW state bit for bit; on finite data the guarded step is
    bitwise the unguarded one."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.common import tree_leaves
    from repro_torch.train.engine import make_step_core
    from repro_torch.train.optim import make_update_for

    bundle, batch, params = _full_width_step(card)
    tc = TrainConfig(lr=0.05, optimizer="adamw", nonfinite_guard=True)
    opt = make_update_for(tc)[0](params)
    p1, o1, m1 = make_step_core(bundle, tc)(params, opt, batch, tc.lr)
    p0, o0, _ = make_step_core(bundle, TrainConfig(lr=0.05,
                                                   optimizer="adamw"))(
        params, opt, batch, tc.lr)
    assert not bool(m1["skipped"])
    for a, b in zip(tree_leaves((p1, o1)), tree_leaves((p0, o0))):
        assert torch.equal(a, b)
    poisoned = dict(batch, weights=batch["weights"].clone())
    poisoned["weights"][1] = float("nan")
    p2, o2, m2 = make_step_core(bundle, tc)(p1, o1, poisoned, tc.lr)
    assert bool(m2["skipped"]) and float(m2["loss"]) == 0.0
    for a, b in zip(tree_leaves((p2, o2)), tree_leaves((p1, o1))):
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


def test_swa_autograd_runs_backward_kernel_and_wrapper_refuses(card):
    """Autograd through ``swa_attn_op`` on the card launches the backward
    kernel once a backward, whose gradients agree bit for bit over two
    runs and stay within 1e-5 of the plain backward's largest entry; the
    wrapper refuses what the kernels do not take (fp16, head dim 48, a
    non-contiguous k, lengths not int32, a misaligned bf16 q)."""
    q, k, v = _swa_inputs(1, 128, 1, 2, 32, "float32", seed=0, dev=card)
    dout = torch.randn(q.shape, device=card)
    grads = []
    for _ in range(2):
        xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        n0 = swa_attn_op.bwd_launches
        out = swa_attn_op(*xs, window=64)
        grads.append(torch.autograd.grad(out, xs, dout))
        assert swa_attn_op.bwd_launches == n0 + 1
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    out, lse = swa_fwd_with_lse(q, k, v, None, 64, with_lse=True)
    want = swa_attn_bwd_ref(q, k, v, out, lse, dout, window=64)
    for a, b in zip(grads[0], want):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))
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


# the backward's own edges besides the forward's: at head dim 128 (dk / dv
# split the head dim over blocks of 64 keys, dq takes blocks of 128 rows)
# G 1, one plane for the in-order head sum, S one row past a tile and a
# window past S; at 64 and below (two warpgroups of 64 rows, 128-row
# blocks) S off the block with a length one past it and an odd G; at 256
# (both split) a length inside a tile and a window off the tile; at 32
# (padded to 64 columns) a length of one tile
SWA_BWD_EDGES = [(1, 129, 1, 2, 256, 63, "bfloat16", None),
                 (2, 1100, 1, 16, 256, 200, "bfloat16", (1100, 70)),
                 (2, 300, 1, 4, 256, 64, "float32", (300, 1)),
                 (1, 65, 1, 1, 128, 4096, "bfloat16", None),
                 (2, 200, 3, 5, 64, 130, "bfloat16", (200, 129)),
                 (1, 333, 2, 3, 256, 97, "bfloat16", (257,)),
                 (2, 130, 1, 6, 32, 129, "bfloat16", (64, 130))]


@pytest.mark.parametrize("B,S,KV,G,hd,W,dtype,lengths",
                         SWA_EDGES + SWA_BWD_EDGES)
def test_swa_backward_kernel_matches_plain(card, B, S, KV, G, hd, W, dtype,
                                           lengths):
    """The forward that writes lse is bitwise the serving forward; two
    backward launches bitwise equal; the kernel against the plain backward
    on the same tensors (from the kernel's out and lse): at fp32 within
    1e-5 of the largest entry of the three gradients, at bf16 each element
    within one bf16 ulp of its own value plus 1e-5 of that entry (both sum
    in fp32, in different orders, then round)."""
    q, k, v = _swa_inputs(B, S, KV, G, hd, dtype, seed=S + hd, dev=card)
    dout = torch.randn(q.shape, device=card).to(q.dtype)
    lens = (None if lengths is None
            else torch.tensor(lengths, dtype=torch.int32, device=card))
    with torch.no_grad():
        serve = swa_attn_op(q, k, v, window=W, lengths=lens)
    out, lse = swa_fwd_with_lse(q, k, v, lens, W, with_lse=True)
    assert torch.equal(out, serve)
    assert bool(torch.isfinite(lse).all())
    got = swa_attn_bwd(q, k, v, out, lse, dout, W, lens)
    again = swa_attn_bwd(q, k, v, out, lse, dout, W, lens)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = swa_attn_bwd_ref(q, k, v, out, lse, dout, window=W, lengths=lens)
    # the sums' rounding scales with the terms summed: the largest entry
    # of the three gradients (at window 1 dq is zero but for it)
    top = max(float(b.float().abs().max()) for b in want)
    for a, b in zip(got, want):
        assert a.dtype == q.dtype
        a, b = a.float(), b.float()
        rtol = 0.0 if dtype == "float32" else 2.0 ** -7
        torch.testing.assert_close(a, b, rtol=rtol, atol=1e-5 * top)


@pytest.mark.parametrize("arch,dtype,hd", [
    ("starcoder2-3b-smoke", None, None),
    ("recurrentgemma-9b-smoke", None, None),
    ("starcoder2-3b-smoke", "bfloat16", 128),
    ("recurrentgemma-9b-smoke", "bfloat16", 256)])
def test_remat_is_bitwise_on_card(card, arch, dtype, hd):
    """Group remat on the card past the band's start (window 16, S 2,048):
    the loss and every gradient leaf bitwise those without remat, the
    band's forward launched twice a local layer with remat (the recompute)
    and once without, its backward once either way.  The smokes compute
    in fp32 (the SIMT backward); in bf16 at head dims 128 and 256 they
    take the tensor-core backward, its split bodies."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.models.common import tree_leaves, tree_map

    cfg = get_config(arch)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=dtype, head_dim=hd)
    b = build_model(cfg)
    params = b.init_params(torch.Generator(device=card).manual_seed(0), card)
    toks = torch.randint(0, b.cfg.vocab_size, (2, 2048), dtype=torch.int32,
                         device=card,
                         generator=torch.Generator(device=card).manual_seed(1))
    n_local = b.cfg.layer_kinds().count("local")
    runs = []
    for remat in (True, False):
        live = tree_map(lambda x: x.detach().requires_grad_(True), params)
        f0, b0 = swa_attn_op.launches, swa_attn_op.bwd_launches
        total, _ = b.loss_fn(live, {"tokens": toks}, remat=remat)
        grads = torch.autograd.grad(total, tree_leaves(live))
        runs.append((total.detach(), grads, swa_attn_op.launches - f0,
                     swa_attn_op.bwd_launches - b0))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(x, y) for x, y in zip(runs[0][1], runs[1][1]))
    assert runs[0][2:] == (2 * n_local, n_local)
    assert runs[1][2:] == (n_local, n_local)


class _EagerOnCard(EpochEngine):
    """The scan engine's step body on the card without a graph."""

    def _ensure_graph(self):
        pass


def _scan_setup(card, arch, guard=False):
    """Units of ``arch``'s smoke config (RNN-T: 4 units of 4 utterances;
    RWKV: 8 units of 2 rows of 128 tokens, the WKV kernels' branch), an
    AdamW config and seed-0 params on the card."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import asr_units, lm_units
    from repro_torch.data.synthetic import make_asr_corpus, make_lm_corpus
    from repro_torch.models.api import build_model

    cfg = get_config(arch)
    if cfg.family == "rnnt":
        units = asr_units(make_asr_corpus(0, 16, n_feats=cfg.rnnt.n_feats,
                                          vocab_size=cfg.rnnt.vocab_size,
                                          noise_fraction=0.25), 4)
    else:
        units = lm_units(make_lm_corpus(0, 16, 128, cfg.vocab_size), 2)
    bundle = build_model(cfg)
    tc = TrainConfig(lr=0.05, optimizer="adamw", nonfinite_guard=guard)
    return bundle, tc, units, bundle.init_params(
        torch.Generator().manual_seed(0), card)


def _same_bits(a, b) -> bool:
    from repro_torch.models.common import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def test_replayed_epoch_equals_eager_epoch_bitwise(card):
    """A guarded epoch with a padding row, replayed through the captured
    graph and run eagerly on the card from the same state: the same
    params, AdamW state and losses bit for bit; then an all-padding plan
    through the graph holds the state bitwise and reports 0 losses."""
    from repro_torch.models.common import tree_map
    from repro_torch.train.optim import make_update_for

    bundle, tc, units, params = _scan_setup(card, "rnnt-crdnn-smoke",
                                            guard=True)
    init = make_update_for(tc)[0]
    outs = []
    for cls in (EpochEngine, _EagerOnCard):
        eng = cls(bundle, tc, units, device=card)
        idx, w = eng.full_plan(0)
        idx[2], w[2] = -1, 0.0
        p, o, losses = eng.run_epoch(params, init(params), tc.lr, (idx, w))
        torch.cuda.synchronize()
        outs.append((p, o, losses, eng))
    assert outs[0][3]._graph is not None and outs[1][3]._graph is None
    assert _same_bits(outs[0][:2], outs[1][:2])
    assert outs[0][2].tolist() == outs[1][2].tolist()
    assert outs[0][2][2] == 0.0 and (outs[0][2][[0, 1, 3]] > 0).all()
    assert int(outs[0][3].last_n_skipped) == 0
    eng = outs[0][3]
    before = tree_map(lambda x: x.clone(), (eng.params, eng.opt_state))
    pad = (np.full((4, 1), -1, np.int32), np.zeros((4, 1), np.float32))
    p, o, losses = eng.run_epoch(eng.params, eng.opt_state, tc.lr, pad)
    torch.cuda.synchronize()
    assert losses.tolist() == [0.0] * 4
    assert _same_bits(before, (p, o))


#: a kernel that each call of a wrapper launches once, by launch counter
_MARKERS = {"rnnt_lattice": "rnnt_lattice_kernel",
            "rwkv6_wkv": "wkv_out_kernel",
            "rwkv6_wkv_bwd": "wkv_bwd_grad_kernel"}


def _traced(fn, names):
    """``fn()`` under ``torch.profiler`` -> {name: instances of its marker
    kernel that ran on the card}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA]
    return {n: sum(ev.count for ev in evs if _MARKERS[n] in ev.key)
            for n in names}


@pytest.mark.parametrize("arch", ["rnnt-crdnn-smoke", "rwkv6-3b-smoke"])
def test_replays_launch_the_kernels(card, arch):
    """The launch counters count at the launch site: an eager step's
    counts equal its traced marker kernels; the first epoch counts the
    warm-up steps and the capture; replays add nothing to them, and a
    traced replayed epoch holds per-step launches x rows of each kernel.
    A plan of another bucket replays the same graph (one capture)."""
    from repro_torch.train.engine import make_step_core, to_device
    from repro_torch.train.optim import make_update_for

    bundle, tc, units, params = _scan_setup(card, arch)
    counters = ({"rnnt_lattice": (rnnt_lattice_op, "launches")}
                if "rnnt" in arch else
                {"rwkv6_wkv": (rwkv6_wkv_op, "launches"),
                 "rwkv6_wkv_bwd": (rwkv6_wkv_op, "bwd_launches")})
    read = lambda: {n: getattr(op, a) for n, (op, a) in counters.items()}
    delta = lambda n0: {n: c - n0[n] for n, c in read().items()}
    opt = make_update_for(tc)[0](params)
    batch = to_device({k: v[0] for k, v in units.items()}, card)
    n0 = read()
    traced = _traced(lambda: make_step_core(bundle, tc)(params, opt, batch,
                                                       tc.lr), counters)
    per_step = delta(n0)
    assert all(d > 0 for d in per_step.values()) and traced == per_step
    EpochEngine.captures = EpochEngine.replays = EpochEngine.warmup_steps = 0
    eng = EpochEngine(bundle, tc, units, device=card)
    plan = eng.full_plan(0)
    n0 = read()
    eng.run_epoch(params, opt, tc.lr, plan)
    torch.cuda.synchronize()
    assert delta(n0) == {n: d * (EpochEngine.WARMUP_STEPS + 1)
                         for n, d in per_step.items()}
    assert (EpochEngine.captures, EpochEngine.replays,
            EpochEngine.warmup_steps) == (1, len(plan[0]),
                                          EpochEngine.WARMUP_STEPS)
    for p in (eng.full_plan(1), eng.subset_plan(
            np.arange(eng.n_units // 2),
            np.ones(eng.n_units // 2, np.float32), 2)):
        n0 = read()
        traced = _traced(lambda: eng.run_epoch(eng.params, eng.opt_state,
                                               tc.lr, p), counters)
        assert delta(n0) == {n: 0 for n in per_step}
        assert traced == {n: d * len(p[0]) for n, d in per_step.items()}
    assert 0 < len(p[0]) < len(plan[0]) and EpochEngine.captures == 1


def _selector_setup(card, arch):
    """``_scan_setup``'s units on the card, seed-0 params and 16 x 16
    projections, and a stage-B config of 2 partitions."""
    from repro_torch.configs.base import PGMConfig
    from repro_torch.core.lastlayer import make_proj_for
    from repro_torch.train.engine import to_device

    bundle, _, units, params = _scan_setup(card, arch)
    proj = make_proj_for(bundle, torch.Generator().manual_seed(1), 16, 16,
                         card)
    pc = PGMConfig(subset_fraction=0.5, n_partitions=2, sketch_dim_h=16,
                   sketch_dim_v=16)
    return bundle, pc, proj, to_device(units, card), params


@pytest.mark.parametrize("arch,cu", [("rnnt-crdnn-smoke", None),
                                     ("starcoder2-3b-smoke", 4),
                                     ("rwkv6-3b-smoke", 2)])
def test_resident_stage_a_replays_one_graph_a_corpus(card, arch, cu):
    """Stage A captured once for a corpus (one chunk at a cursor) and
    replayed a chunk at a time: two rounds of replays on the same params
    bit for bit equal and within 1e-5 of the largest entry of the host
    ``units_gradients``; a replay moves no launch counter; other param tensors are copied into the captured ones, so
    the next replay equals eager stage A on them (never stale params);
    a second corpus gets a graph of its own.  The LM case runs the
    grad-sketch kernel at U = 4 inside the graph."""
    from repro_torch.core.lastlayer import (_chunk_size, units_gradients,
                                            units_gradients_batched)
    from repro_torch.core.pgm import ResidentSelector

    bundle, pc, proj, units, params = _selector_setup(card, arch)
    counters = (rnnt_lattice_op, grad_sketch_units_op, rwkv6_wkv_op)
    read = lambda: [op.launches for op in counters]
    ResidentSelector.captures = ResidentSelector.replays = 0
    sel = ResidentSelector(bundle, pc, proj, chunk_units=cu)
    g1 = sel.stage_a(params, units)
    n0 = read()
    g2 = sel.stage_a(params, units)
    torch.cuda.synchronize()
    assert read() == n0
    assert torch.equal(g1, g2)
    host = units_gradients(bundle, params, units, proj)
    scale = float(host.abs().max())
    assert float((g1 - host).abs().max()) <= 1e-5 * scale
    other = bundle.init_params(torch.Generator().manual_seed(2), card)
    g3 = sel.stage_a(other, units)
    eager = units_gradients_batched(bundle, other, units, proj,
                                    chunk_units=cu)
    torch.cuda.synchronize()
    assert not torch.equal(g3, g1)
    assert float((g3 - eager).abs().max()) <= \
        1e-5 * float(eager.abs().max())
    n_chunks = units["tokens"].shape[0] // _chunk_size(
        units["tokens"].shape[0], cu)
    assert (ResidentSelector.captures, ResidentSelector.replays) == \
        (1, 3 * n_chunks)
    val = {k: v[:2].clone() for k, v in units.items()}
    assert sel.stage_a(other, val).shape == (2, g1.shape[1])
    assert ResidentSelector.captures == 2


def test_moe_forward_is_repeatable_and_agrees_with_the_cpu(card):
    """The MoE layer (``models/moe.py``: one-hot dispatch and combine as
    plain products, no scatter, no atomics) at 16 experts top-8 with
    drops: two runs on the card bit for bit equal, and within 1e-5 of the
    same layer on the CPU (which the CPU tests hold against the
    reference)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe
    from repro_torch.models.common import tree_map

    cfg = dataclasses.replace(get_config("olmoe-1b-7b-smoke"), moe=MoEConfig(
        n_experts=16, top_k=8, d_ff_expert=32, capacity_factor=0.5))
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe_params(gen, 64, cfg.moe, cfg.ffn_type,
                            torch.device("cpu"))
    x = torch.randn((4, 512, 64), generator=gen)
    pd = tree_map(lambda t: t.to(card), p)
    o1, a1 = moe.moe_forward(pd, cfg, x.to(card))
    o2, a2 = moe.moe_forward(pd, cfg, x.to(card))
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(a1, a2)
    oc, ac = moe.moe_forward(p, cfg, x)
    torch.testing.assert_close(o1.cpu(), oc, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(a1.cpu(), ac, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("arch", ["mixtral-8x7b-smoke", "olmoe-1b-7b-smoke"])
def test_resident_router_term_replays_and_matches_host(card, arch):
    """The MoE router term in the resident graph (each unit its head
    sketch and one captured ``autograd.grad`` with respect to the routers):
    two replays bitwise, within 1e-5 of host ``units_gradients``, and at
    ``chunk_units`` 1 each head block bitwise the head-only vector."""
    import dataclasses

    from repro_torch.core.lastlayer import units_gradients
    from repro_torch.core.pgm import ResidentSelector

    bundle, pc, proj, units, params = _selector_setup(card, arch)
    pc = dataclasses.replace(pc, moe_router_term=True)
    sel = ResidentSelector(bundle, pc, proj, chunk_units=1)
    g1 = sel.stage_a(params, units)
    g2 = sel.stage_a(params, units)
    torch.cuda.synchronize()
    assert torch.equal(g1, g2)
    host = units_gradients(bundle, params, units, proj, router_term=True)
    assert g1.shape == host.shape
    assert float((g1 - host).abs().max()) <= 1e-5 * float(host.abs().max())
    head = ResidentSelector(bundle, dataclasses.replace(
        pc, moe_router_term=False), proj, chunk_units=1).stage_a(params,
                                                                 units)
    assert torch.equal(g1[:, :head.shape[1]], head)
    s = sel(params, units)
    assert s.n_selected == units["tokens"].shape[0] // 2


def test_failed_cuda_round_raises(card):
    """An injected failure of the kernel route raises out of the round,
    whatever ``on_failure`` says: no soft-random subset on the card."""
    from repro_torch.core.pgm import ResidentSelector
    from repro_torch.train import faults

    bundle, pc, proj, units, params = _selector_setup(card,
                                                      "starcoder2-3b-smoke")
    ResidentSelector.captures = 0
    sel = ResidentSelector(bundle, pc, proj, on_failure="soft_random")
    with faults.failing_selection_kernels(("cuda",)):
        with pytest.raises(RuntimeError, match="injected kernel failure"):
            sel(params, units)
    assert sel.degraded_rounds == 0 and ResidentSelector.captures == 0


def test_grad_sketch_units_in_a_graph_matches_eager(card):
    """The grad-sketch kernel at U = 4 captured in a CUDA graph (its
    212 KB shared-memory attribute set and its scratch allocated inside
    the capture): a replay equals the eager launch bit for bit, and after
    the inputs change in place, the eager launch on the new inputs."""
    g = torch.Generator().manual_seed(5)
    U, n, d, V, k = 4, 300, 128, 1000, 32
    h = torch.randn(U, n, d, generator=g).to(card)
    wt = (torch.randn(V, d, generator=g) / d ** 0.5).to(card)
    rh, rv = (torch.randn(d, k, generator=g).to(card),
              torch.randn(V, k, generator=g).to(card))
    t = torch.randint(0, V, (U, n), generator=g).to(card)
    s = (torch.rand(U, n, generator=g) + 0.5).to(card)
    eager = grad_sketch_units_op(h, wt.t(), rh, rv, t, s)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        grad_sketch_units_op(h, wt.t(), rh, rv, t, s)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = grad_sketch_units_op(h, wt.t(), rh, rv, t, s)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    h.copy_(torch.randn(U, n, d, generator=g).to(card))
    graph.replay()
    eager = grad_sketch_units_op(h, wt.t(), rh, rv, t, s)
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


class _SyncingBundle:
    """A bundle whose loss reads its value back to the host."""

    def __init__(self, bundle):
        self._bundle = bundle
        self.cfg = bundle.cfg

    def loss_fn(self, params, batch):
        total, metrics = self._bundle.loss_fn(params, batch)
        if float(total) < 0:                     # the planted host sync
            raise AssertionError("negative loss")
        return total, metrics

    def __getattr__(self, name):
        return getattr(self._bundle, name)


def test_host_sync_in_the_step_makes_capture_raise(card):
    """The warm-up runs (eager steps may read back), the capture raises,
    and nothing falls back to an eager epoch.  Last in this file: the
    capture it breaks is abandoned."""
    from repro_torch.train.optim import make_update_for

    bundle, tc, units, params = _scan_setup(card, "starcoder2-3b-smoke")
    eng = EpochEngine(_SyncingBundle(bundle), tc, units, device=card)
    with pytest.raises(RuntimeError):
        eng.run_epoch(params, make_update_for(tc)[0](params), tc.lr,
                      eng.full_plan(0))
    assert eng._graph is None
    torch.cuda.synchronize()


# the band at head dim 256 (recurrentgemma-9b's MQA: 1 KV head, G 16):
# its prefill shape in bf16 and fp32, then the smaller tiles' edges (S off
# the 128-row q tile, windows off the 64-key tile, per-row lengths)
SWA_HD256 = [
    (2, 8192, 1, 16, 256, 2048, "bfloat16", None),
    (2, 8192, 1, 16, 256, 2048, "float32", None),
    (1, 129, 1, 2, 256, 63, "bfloat16", None),
    (2, 1100, 1, 16, 256, 200, "bfloat16", (1100, 70)),
    (1, 700, 2, 2, 256, 1, "bfloat16", None),
    (2, 300, 1, 4, 256, 64, "float32", (300, 1)),
]


@pytest.mark.parametrize("B,S,KV,G,hd,W,dtype,lengths", SWA_HD256)
def test_swa_kernel_head_dim_256_matches_plain(card, B, S, KV, G, hd, W,
                                               dtype, lengths):
    """The bars of ``test_swa_kernel_matches_plain`` at head dim 256."""
    test_swa_kernel_matches_plain(card, B, S, KV, G, hd, W, dtype, lengths)


def test_wkv_prefill_with_pad_rows_matches_plain(card):
    """A padded prefill's time mix (k 0 and a log-decay of 0 from each
    row's length on, S10): y at the live rows and the final state within
    1e-4 of the plain chunk algebra's largest entry; the padded row's
    state bitwise the kernel's state over its live prefix rounded up to a
    chunk (the pad chunks carry it unchanged)."""
    (r, k, v, lw, u), _ = _wkv_inputs(2, 256, 4, 64, seed=3, dev=card)
    n = torch.tensor([256, 150], device=card)
    live = (torch.arange(256, device=card)[None, :] < n[:, None])[..., None,
                                                                  None]
    k = torch.where(live, k, torch.zeros((), device=card))
    lw = torch.where(live, lw, torch.zeros((), device=card))
    with torch.no_grad():
        y, s = rwkv6_wkv_op(r, k, v, lw, u, 64)
        yp, sp = _wkv_plain(r, k, v, lw, u, 64)
        _, s_cut = rwkv6_wkv_op(*(x[1:, :192].contiguous()
                                  for x in (r, k, v, lw)), u, 64)
    keep = live.expand_as(y)
    torch.testing.assert_close(y[keep], yp[keep], rtol=0,
                               atol=1e-4 * float(yp[keep].abs().max()))
    torch.testing.assert_close(s, sp, rtol=0,
                               atol=1e-4 * float(sp.abs().max()))
    assert torch.equal(s[1], s_cut[0])


@pytest.mark.parametrize("arch", ["recurrentgemma-9b-smoke",
                                  "rwkv6-3b-smoke"])
def test_slot_decode_keeps_dead_rows_bitwise(card, arch):
    """A decode over a pool of two slots with one not live: every leaf
    of the dead slot bitwise as it was, the live slot's recurrent state
    moved, in place on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.models.common import tree_leaves, tree_map

    bundle = build_model(get_config(arch))
    params = bundle.init_params(torch.Generator().manual_seed(0), card)
    pool = bundle.init_cache(2, 24, device=card)
    prompt = torch.randint(0, 277, (1, 12), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1)).to(card)
    with torch.no_grad():
        logits, one = bundle.prefill(params, {"tokens": prompt},
                                     cache_len=24)
        tree_map(lambda p, l: p.__setitem__(1, l[0]), pool, one)
        # the dead slot holds some other state (a fill, not a draw from
        # the card's default generator, which a capture test before may
        # have left in its capture state)
        for e in pool["groups"] + pool["tail"]:
            for k in set(e) & {"h", "conv", "S", "x_tmix", "x_cmix"}:
                e[k][0].fill_(0.25)
        before = tree_map(lambda l: l.clone(), pool)
        tok = torch.argmax(logits, -1).to(torch.int32).repeat(2)
        bundle.decode(params, pool, tok,
                      live=torch.tensor([False, True], device=card))
    torch.cuda.synchronize()
    moved = False
    for a, b in zip(tree_leaves(before), tree_leaves(pool)):
        assert b.device.type == "cuda" and torch.equal(a[0], b[0])
        moved |= not torch.equal(a[1], b[1])
    assert moved
