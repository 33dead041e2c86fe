"""Plain PyTorch version of the batched Gram kernel (the port of the
reference's ``kernels/omp_gram/ref.py``)."""
from __future__ import annotations

import torch


def omp_gram_batched_ref(g: torch.Tensor) -> torch.Tensor:
    """(P, n, D) -> (P, n, n) fp32 per-partition Grams."""
    g32 = g.to(torch.float32)
    return g32 @ g32.transpose(-1, -2)
