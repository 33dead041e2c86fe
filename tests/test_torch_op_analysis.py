"""PyTorch port, the op count and the roofline (``repro_torch/launch/
op_analysis.py``, ``launch/roofline.py``).

- hand-computed cases, as ``tests/test_hlo_analysis.py`` has for the
  reference's HLO analysis: a matmul, a loop of three layers and its
  backward, a convolution, bytes of a broadcast input;
- the train step of two smoke archs with remat off against the
  reference's ``hlo_analysis.analyze`` of ``jax.value_and_grad`` of the
  same loss compiled on the CPU: matmul FLOPs within 2% (0.11% for
  ``starcoder2-3b-smoke``; ``olmoe-1b-7b-smoke``, ``gemma3-27b-smoke``
  and ``recurrentgemma-9b-smoke`` agreed within 0.06% when tried); for
  ``rwkv6-3b-smoke`` the gap is named, the sequential WKV scan's
  per-token readout ``bhn,bhnm->bhm``, which XLA rewrites into a
  multiply and a reduce (no dot) and PyTorch runs as a ``bmm``;
- every kernel wrapper counted by its formula on the plain route, with
  none of the plain version's own ops counted, and the same on the fake
  route; a selection round the same work on the ``auto`` and ``xla``
  routes;
- ``model_flops`` and ``ideal_decode_bytes`` equal to the reference's for
  every (arch, shape) of ``cells()``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.op_analysis import count_ops  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402


def test_matmul_flops_and_bytes_exact():
    m, n, k = 64, 96, 128
    a, b = torch.zeros(m, k), torch.zeros(k, n)
    with count_ops() as c:
        a @ b
    assert c.flops == c.dot_flops == 2 * m * n * k
    assert c.bytes == 4 * (m * k + k * n + m * n)


def test_a_loop_of_three_layers_counts_each_and_its_backward():
    T, M = 3, 32
    x = torch.randn(M, M, requires_grad=True)
    ws = [torch.randn(M, M, requires_grad=True) for _ in range(T)]
    with count_ops() as c:
        h = x
        for w in ws:
            h = h @ w
    assert c.dot_flops == T * 2 * M ** 3
    with count_ops() as c:
        h = x
        for w in ws:
            h = h @ w
        torch.autograd.grad(h.sum(), [x] + ws)
    # each layer's forward, and two products in its backward
    assert c.dot_flops == 3 * T * 2 * M ** 3


def test_convolution_flops():
    B, Cin, Cout, H, W, K = 2, 3, 8, 16, 16, 3
    x = torch.randn(B, Cin, H, W)
    w = torch.randn(Cout, Cin, K, K)
    with count_ops() as c:
        out = torch.nn.functional.conv2d(x, w, padding=1)
    assert c.flops == 2 * out.numel() * Cin * K * K and c.dot_flops == 0


def test_views_are_free_and_a_broadcast_input_counts_once():
    x = torch.randn(64, 1)
    with count_ops() as c:
        y = x.t().reshape(1, 64)
        z = x.expand(64, 64) + 1.0
    assert c.by_op.get("aten.t", [0, 0, 0])[2] == 0
    assert c.by_op["aten.add"][2] == 4 * 64 + 4 * 64 * 64
    assert y.shape == (1, 64) and z.shape == (64, 64)


def _reference_dot_flops(arch, B, S):
    import jax
    from repro.configs import get_config as jcfg
    from repro.launch import hlo_analysis
    from repro.models.api import build_model as jbuild
    jb = jbuild(jcfg(arch))
    jp = jb.init_params(jax.random.PRNGKey(0))
    batch = jb.make_batch(jax.random.PRNGKey(1), B, S)
    f = jax.jit(jax.value_and_grad(
        lambda p: jb.loss_fn(p, batch, remat=False)[0]))
    return hlo_analysis.analyze(f.lower(jp).compile().as_text()).flops


def _port_step(arch, B, S):
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    b = build_model(get_config(arch))
    params = b.init_params(torch.Generator().manual_seed(0),
                           torch.device("cpu"))
    batch = b.make_batch(torch.Generator().manual_seed(1), B, S)
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with count_ops() as c:
        total, _ = b.loss_fn(live, batch, remat=False)
        torch.autograd.grad(total, tree_leaves(live))
    return c


@pytest.mark.parametrize("arch", ["starcoder2-3b-smoke", "rwkv6-3b-smoke"])
def test_train_step_matmuls_agree_with_the_reference_hlo(arch):
    B, S = 4, 32
    ref = _reference_dot_flops(arch, B, S)
    c = _port_step(arch, B, S)
    named = 0.0
    if arch.startswith("rwkv6"):
        named = _wkv_scan_readout_flops(arch, B, S)
        assert abs(c.dot_flops - ref) / ref > 0.02     # the gap is there
    assert abs(c.dot_flops - named - ref) / ref < 0.02, (c.dot_flops, named,
                                                         ref)
    assert c.flops == c.dot_flops                  # no kernel at this size


def _wkv_scan_readout_flops(arch, B, S):
    """The sequential scan's matmuls (S < 128): its per-token readout and
    their backward, forward and backward, in every layer."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6_scan.ref import wkv_scan
    cfg = get_config(arch)
    N = cfg.rwkv_head_dim
    H = cfg.d_model // N
    g = torch.Generator().manual_seed(0)
    ins = [torch.rand(B, S, H, N, generator=g, requires_grad=True)
           for _ in range(4)]
    u = torch.randn(H, N, generator=g, requires_grad=True)
    with count_ops() as c:
        y, s = wkv_scan(*ins, u, torch.zeros(B, H, N, N))
        torch.autograd.grad(y.sum() + s.sum(), ins + [u])
    return c.dot_flops * cfg.n_layers


def _kernel_cases():
    """(name, prepare, its formula's {kernel: (FLOPs, bytes)}) of every
    hand-written kernel's wrapper, forward and backward: ``prepare()``
    draws the CPU inputs and returns the call to count."""
    from repro_torch.kernels.grad_sketch import ops as gs
    from repro_torch.kernels.omp_gram import ops as gram
    from repro_torch.kernels.rnnt_lattice import ops as lat
    from repro_torch.kernels.rwkv6_scan import ops as wkv
    from repro_torch.kernels.swa_attn import ops as swa
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    grad = lambda *s: r(*s).requires_grad_(True)
    T, B, U1 = 6, 2, 5
    P, n, D = 4, 3, 32
    U, n2, d, V, k1, k2 = 2, 6, 16, 40, 8, 4
    Bw, S, H, N, C = 1, 128, 2, 8, 64
    Bs, Ss, KV, G, hd, Wn = 1, 40, 2, 2, 16, 8

    def lattice():
        ins = [r(T, B, U1) for _ in range(3)]
        return lambda: lat.rnnt_lattice_op(*ins)

    def gram_(impl):
        x = r(P, n, D)
        return lambda: gram.omp_gram_batched_op(x, impl=impl)

    def sketch(impl):
        ins = (r(U, n2, d), r(d, V), r(d, k1), r(V, k2),
               torch.randint(0, V, (U, n2), generator=g),
               torch.rand(U, n2, generator=g))
        return lambda: gs.grad_sketch_units_op(*ins, impl=impl)

    def wkv_():
        ins = [grad(Bw, S, H, N) for _ in range(3)]
        lw = (-torch.rand(Bw, S, H, N, generator=g)).requires_grad_(True)
        u = grad(H, N)

        def call():
            y, s = wkv.rwkv6_wkv_op(*ins, lw, u, C)
            torch.autograd.grad((y.sum(), s.sum()), ins + [lw, u])
        return call

    def swa_():
        q, k, v = grad(Bs, Ss, KV, G, hd), grad(Bs, Ss, KV, hd), \
            grad(Bs, Ss, KV, hd)

        def call():
            out = swa.swa_attn_op(q, k, v, window=Wn)
            torch.autograd.grad(out.sum(), [q, k, v])
        return call
    q0, k0 = torch.zeros(Bs, Ss, KV, G, hd), torch.zeros(Bs, Ss, KV, hd)
    return [
        ("rnnt_lattice", lattice, {"rnnt_lattice": lat.work(T * B * U1)}),
        ("omp_gram[auto]", lambda: gram_("auto"),
         {"omp_gram": gram.work(P, n, D)}),
        ("omp_gram[xla]", lambda: gram_("xla"),
         {"omp_gram": gram.work(P, n, D)}),
        ("grad_sketch[auto]", lambda: sketch("auto"),
         {"grad_sketch": gs.work(U, n2, d, V, k1, k2)}),
        ("grad_sketch[xla]", lambda: sketch("xla"),
         {"grad_sketch": gs.work(U, n2, d, V, k1, k2)}),
        ("rwkv6_wkv", wkv_, {"rwkv6_wkv": wkv.work(Bw, S, H, N, C),
                             "rwkv6_wkv_bwd": wkv.bwd_work(Bw, S, H, N, C)}),
        ("swa_attn", swa_, {"swa_attn": swa.work(q0, k0, k0, Wn, True),
                            "swa_attn_bwd": swa.bwd_work(q0, k0, k0, Wn)}),
    ]


@pytest.mark.parametrize("case", range(7))
def test_each_kernel_counts_its_formula_on_the_plain_route(case):
    name, prepare, want = _kernel_cases()[case]
    call = prepare()
    with count_ops() as c:
        call()
    got = {k: (v[1], v[2]) for k, v in c.kernels.items()}
    assert got == {k: (float(f), float(b)) for k, (f, b) in want.items()}
    assert all(v[0] == 1 for v in c.kernels.values())
    # none of the plain versions' own arithmetic: only the test's sums
    # and their backward's ones_like / expand remain outside the kernels
    assert c.flops == sum(f for f, _ in want.values())
    assert set(c.by_op) <= {"aten.sum", "aten.ones_like", "aten.expand",
                            "aten.clone", "aten.detach"}, (name, c.by_op)


def test_the_fake_route_counts_the_same_as_the_plain_one():
    from torch._subclasses.fake_tensor import FakeTensorMode
    for name, prepare, want in _kernel_cases():
        with count_ops() as real:
            prepare()()
        with FakeTensorMode():
            call = prepare()                   # fake inputs, drawn inside
            with count_ops() as fake:
                call()
        assert fake.kernels == real.kernels, name
        assert {k: (v[1], v[2]) for k, v in fake.kernels.items()} == \
            {k: (float(f), float(b)) for k, (f, b) in want.items()}


def test_a_selection_round_is_the_same_work_on_both_routes():
    auto, xla = roofline.selection_round_records(n_examples=16)
    assert auto["flops"] == xla["flops"] > 0
    assert auto["bytes_accessed"] == xla["bytes_accessed"]
    assert set(auto["kernels"]) == {"grad_sketch", "omp_gram"}
    assert auto["kernels"] == xla["kernels"]


def test_model_flops_and_ideal_decode_bytes_equal_the_reference():
    from repro.launch import roofline as ref
    from repro_torch.configs import cells, get_shape
    n = 0
    for arch, shape in cells():
        step = get_shape(shape).kind
        assert roofline.model_flops(arch, shape, step) == \
            ref.model_flops(arch, shape, step)
        for n_dev in (1, 256, 512):
            assert roofline.ideal_decode_bytes(arch, shape, n_dev) == \
                ref.ideal_decode_bytes(arch, shape, n_dev)
        n += 1
    assert n == 35


def test_roofline_terms_and_mfu():
    rec = {"arch": "starcoder2-3b", "shape": "train_4k", "step": "train",
           "n_devices": 1, "flops": 989e12, "bytes_accessed": 3.35e12,
           "wire_bytes": 0.0}
    t = roofline.roofline_terms(rec)
    assert np.isclose(t["compute_s"], 1.0) and np.isclose(t["memory_s"], 1.0)
    mf = roofline.model_flops("starcoder2-3b", "train_4k", "train")
    assert np.isclose(t["useful_ratio"], mf / 989e12)
    assert np.isclose(roofline.mfu(mf, 2.0), mf / 2.0 / 989e12)
