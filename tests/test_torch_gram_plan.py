"""PyTorch port, the batched Gram kernel's launch plan and its arithmetic,
on the CPU (the kernel itself runs only on the card and is held against
the plain version in ``tests/test_torch_cuda.py``).

``kernels/omp_gram/ops.py:gram_plan`` picks, from (P, n, D) and the
card's SM count, an output tile sized to n, the upper-triangle tiles the
kernel walks, and a split of D over blocks with a scratch buffer of
partial tiles.  These tests hold the plan over a grid of shapes: the D
slices cover D exactly once, the tiles cover the upper triangle exactly
once, the scratch buffer has one tile a (split, partition, tile), and a
plain emulation of the kernel's order of sums (each slice's Gram of each
tile, the slices added in split order, each tile written with its
mirror) agrees with the plain Gram within the card test's 1e-4 of the
largest |K| and is exactly symmetric.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

from repro_torch.kernels.omp_gram.ops import BK, gram_plan, gram_tile  # noqa: E402
from repro_torch.kernels.omp_gram.ref import omp_gram_batched_ref  # noqa: E402

# (P, n, D): stage B's smoke shape, a real corpus's stage B, the card
# tests' ragged shapes, and shapes around every tile and slice edge
SHAPES = [(4, 4, 4096), (8, 512, 4096), (2, 1000, 4096), (5, 33, 1),
          (1, 257, 777), (1, 1, 1), (3, 65, 130), (2, 130, 4099),
          (1, 32, 32), (1, 64, 33), (2, 128, 4096), (1, 256, 65),
          (7, 300, 1000), (64, 16, 4096), (300, 8, 64)]
SM_COUNTS = [132, 1]


@pytest.mark.parametrize("n_sm", SM_COUNTS)
@pytest.mark.parametrize("P,n,D", SHAPES)
def test_gram_plan_slices_cover_d_once(P, n, D, n_sm):
    plan = gram_plan(P, n, D, n_sm)
    assert plan.slice % BK == 0 and plan.splits >= 1
    cover = np.zeros(D, np.int64)
    for s in range(plan.splits):
        lo, hi = s * plan.slice, min(D, (s + 1) * plan.slice)
        assert lo < hi, "an empty D slice"
        cover[lo:hi] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("n_sm", SM_COUNTS)
@pytest.mark.parametrize("P,n,D", SHAPES)
def test_gram_plan_tiles_cover_the_upper_triangle_once(P, n, D, n_sm):
    plan = gram_plan(P, n, D, n_sm)
    T = plan.tile
    assert T == (32 if n <= 32 else 128)             # sized to n
    assert plan.n_side == -(-n // T)
    assert plan.n_tiles == plan.n_side * (plan.n_side + 1) // 2
    cover = np.zeros((n, n), np.int64)
    for t in range(plan.n_tiles):
        ti, tj = gram_tile(t, plan.n_side)
        assert 0 <= ti <= tj < plan.n_side
        r = np.arange(ti * T, min(n, (ti + 1) * T))
        c = np.arange(tj * T, min(n, (tj + 1) * T))
        rr, cc = np.meshgrid(r, c, indexing="ij")
        keep = rr <= cc                          # r <= c inside a diagonal tile
        cover[rr[keep], cc[keep]] += 1
    assert (cover[np.triu_indices(n)] == 1).all()
    assert (cover[np.tril_indices(n, -1)] == 0).all()


@pytest.mark.parametrize("n_sm", SM_COUNTS)
@pytest.mark.parametrize("P,n,D", SHAPES)
def test_gram_plan_scratch_and_blocks(P, n, D, n_sm):
    """One partial tile a (split, partition, tile) when D is split, none
    otherwise; D is split only while the blocks fit one wave of two
    blocks an SM."""
    plan = gram_plan(P, n, D, n_sm)
    want = plan.splits * P * plan.n_tiles * plan.tile ** 2
    assert plan.scratch == (want if plan.splits > 1 else 0)
    if plan.splits > 1:
        assert P * plan.n_tiles * plan.splits <= 2 * n_sm


def _gram_by_plan(g, plan):
    """The kernel's order of sums in plain PyTorch: per tile and D slice
    an fp32 product, the slices added in split order, each upper tile
    written with its mirror."""
    P, n, D = g.shape
    T = plan.tile
    out = torch.full((P, n, n), float("nan"))
    for t in range(plan.n_tiles):
        ti, tj = gram_tile(t, plan.n_side)
        a = g[:, ti * T:(ti + 1) * T]
        b = g[:, tj * T:(tj + 1) * T]
        acc = None
        for s in range(plan.splits):
            lo, hi = s * plan.slice, min(D, (s + 1) * plan.slice)
            part = a[..., lo:hi] @ b[..., lo:hi].transpose(1, 2)
            acc = part if acc is None else acc + part
        rr, cc = torch.meshgrid(torch.arange(ti * T, ti * T + acc.shape[1]),
                                torch.arange(tj * T, tj * T + acc.shape[2]),
                                indexing="ij")
        keep = rr <= cc                          # r <= c inside a diagonal tile
        out[:, rr[keep], cc[keep]] = acc[:, keep]
        out[:, cc[keep], rr[keep]] = acc[:, keep]
    return out


@pytest.mark.parametrize("P,n,D", [(4, 4, 4096), (2, 130, 4099),
                                   (3, 65, 130), (1, 257, 777)])
def test_gram_by_plan_matches_plain_and_is_symmetric(P, n, D):
    g = torch.from_numpy(np.random.default_rng(n).normal(size=(P, n, D))
                         .astype(np.float32))
    got = _gram_by_plan(g, gram_plan(P, n, D))
    want = omp_gram_batched_ref(g)
    assert torch.equal(got, got.transpose(1, 2))
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
