"""Plain PyTorch version of the RNN-T lattice scan.

The port of the reference's ``core/rnnt_loss.py:lattice_scan_ref``
(re-exported there as ``kernels/rnnt_lattice/ref.py``): a Python loop
over T rows, each row solved with a Hillis–Steele doubling scan over U.

The recurrence (log semiring, per batch row):
  rows[t] = row_update(logaddexp(rows[t-1] + mult[t], add[t]), emit[t])
  row_update: a[u] = logaddexp(base[u], a[u-1] + emit[u]), emit[0] = NEG
with ``rows[-1] = NEG`` so ``add[0]`` seeds the first row.  The alpha
forward uses it directly; the beta backward uses it on (t, u)-flipped
rows with the terminal blank injected through ``add``.
"""
from __future__ import annotations

import torch

NEG = -1e30


def row_update(base: torch.Tensor, emit: torch.Tensor) -> torch.Tensor:
    """Solve a[u] = logaddexp(base[u], a[u-1] + emit[u]) along the last
    axis (``emit[..., 0]`` must be NEG): ``ceil(log2(U1))`` doubling
    steps of the combine (c1, b1).(c2, b2) = (c1+c2, logaddexp(b1+c2, b2)).
    Differentiable (the dense oracle takes autograd through it)."""
    c, b = emit, base
    d = 1
    n = b.shape[-1]
    while d < n:
        b = torch.cat([b[..., :d],
                       torch.logaddexp(b[..., :-d] + c[..., d:], b[..., d:])],
                      dim=-1)
        c = torch.cat([c[..., :d], c[..., :-d] + c[..., d:]], dim=-1)
        d *= 2
    return b


def rnnt_lattice_ref(mult: torch.Tensor, add: torch.Tensor,
                     emit: torch.Tensor) -> torch.Tensor:
    """(T, B, U1) x3 fp32 -> stacked lattice rows (T, B, U1) fp32."""
    rows = []
    prev = torch.full(mult.shape[1:], NEG, dtype=mult.dtype,
                      device=mult.device)
    for t in range(mult.shape[0]):
        prev = row_update(torch.logaddexp(prev + mult[t], add[t]), emit[t])
        rows.append(prev)
    return torch.stack(rows)
