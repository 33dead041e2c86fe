"""PyTorch port, kernels: each kernel's plain version against the JAX
Pallas kernel (interpret mode) and its ``ref.py``, on the same inputs
made with numpy from a seed, and the CPU dispatch of each wrapper.  The
Hopper kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py``.

Tolerances: the lattice at the ``tests/test_kernels.py`` bar (atol 1e-4,
rtol 1e-5: NEG-valued cells agree to fp32 rounding at 1e30); the Gram at
rtol 1e-5 of its largest entry (fp32 sums over D in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.omp_gram.kernel import omp_gram_batched  # noqa: E402
from repro.kernels.omp_gram.ref import omp_gram_batched_ref  # noqa: E402
from repro.kernels.rnnt_lattice.kernel import rnnt_lattice  # noqa: E402
from repro.kernels.rnnt_lattice.ref import rnnt_lattice_ref as jax_ref  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402
from repro_torch.kernels.omp_gram.ops import omp_gram_batched_op  # noqa: E402
from repro_torch.kernels.omp_gram.ref import (  # noqa: E402
    omp_gram_batched_ref as torch_gram_ref)
from repro_torch.kernels.rnnt_lattice.ops import rnnt_lattice_op  # noqa: E402
from repro_torch.kernels.rnnt_lattice.ref import (  # noqa: E402
    NEG, rnnt_lattice_ref)

LATTICE_SHAPES = [(1, 1, 1), (5, 2, 2), (7, 3, 5), (12, 2, 8), (4, 4, 17),
                  (9, 1, 33)]


def _lattice_inputs(T, B, U1, seed):
    """The kernel's structural invariants: emit[:, :, 0] = NEG and sparse
    additive seeds, as the alpha/beta uses give them."""
    rng = np.random.default_rng(seed)
    mult = rng.normal(size=(T, B, U1)).astype(np.float32)
    add = np.where(rng.uniform(size=(T, B, U1)) < 0.3,
                   rng.normal(size=(T, B, U1)), NEG).astype(np.float32)
    emit = rng.normal(size=(T, B, U1)).astype(np.float32)
    emit[:, :, 0] = NEG
    return mult, add, emit


@pytest.mark.parametrize("T,B,U1", LATTICE_SHAPES)
def test_lattice_plain_matches_pallas_and_ref(T, B, U1):
    mult, add, emit = _lattice_inputs(T, B, U1, seed=T * 100 + U1)
    got = rnnt_lattice_ref(*(torch.from_numpy(x) for x in (mult, add, emit)))
    pallas = np.asarray(rnnt_lattice(*(jnp.asarray(x)
                                       for x in (mult, add, emit)),
                                     interpret=True))
    ref = np.asarray(jax_ref(*(jnp.asarray(x) for x in (mult, add, emit))))
    assert got.shape == (T, B, U1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), pallas, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-5)


GRAM_SHAPES = [(1, 5, 37), (2, 4, 16), (3, 17, 300), (4, 4, 4096 // 16)]


@pytest.mark.parametrize("P,n,D", GRAM_SHAPES)
def test_gram_plain_matches_pallas_and_ref(P, n, D):
    g = np.random.default_rng(P * 1000 + n).normal(size=(P, n, D)) \
        .astype(np.float32)
    got = torch_gram_ref(torch.from_numpy(g)).numpy()
    pallas = np.asarray(omp_gram_batched(jnp.asarray(g), interpret=True))
    ref = np.asarray(omp_gram_batched_ref(jnp.asarray(g)))
    assert got.shape == (P, n, n) and got.dtype == np.float32
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale)


def test_wrappers_take_the_plain_path_on_cpu_and_count_no_launch():
    mult, add, emit = (torch.from_numpy(x)
                       for x in _lattice_inputs(6, 2, 4, seed=0))
    g = torch.randn(2, 3, 8, generator=torch.Generator().manual_seed(0))
    before = (rnnt_lattice_op.launches, omp_gram_batched_op.launches)
    assert torch.equal(rnnt_lattice_op(mult, add, emit),
                       rnnt_lattice_ref(mult, add, emit))
    assert torch.equal(omp_gram_batched_op(g), torch_gram_ref(g))
    assert (rnnt_lattice_op.launches, omp_gram_batched_op.launches) == before


def test_backend_refuses_mixed_devices_and_cuda_without_a_card():
    with pytest.raises(ValueError):
        backend.on_card(torch.zeros(1), torch.zeros(1, device="meta"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            backend.resolve_device(None)
    assert backend.resolve_device("cpu").type == "cpu"
