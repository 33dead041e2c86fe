"""Tensor-JL sketching of last-layer gradients (the reference's
``core/sketch.py``).

A unit's last-layer gradient G (d_h, d_v) is sketched as ``R1^T G R2``
with independent Gaussian projections R1 (d_h, k1), R2 (d_v, k2) of
entries N(0, 1/k1) / N(0, 1/k2): an unbiased inner-product estimate
``E<S, S'> = <G, G'>``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Projections(NamedTuple):
    r_h: torch.Tensor      # (d_hidden, k1)
    r_v: torch.Tensor      # (d_vocab, k2)


def make_projections(gen: torch.Generator, d_hidden: int, d_vocab: int,
                     k1: int = 64, k2: int = 64,
                     device: torch.device = torch.device("cpu")
                     ) -> Projections:
    r_h = torch.randn((d_hidden, k1), generator=gen) / math.sqrt(float(k1))
    r_v = torch.randn((d_vocab, k2), generator=gen) / math.sqrt(float(k2))
    return Projections(r_h.to(device), r_v.to(device))


def sketch_from_factors(h: torch.Tensor, e: torch.Tensor,
                        proj: Projections) -> torch.Tensor:
    """h: (N, d_h) fp32; e: (N, d_v) fp32 -> flattened sketch (k1*k2,),
    computed as ``(H R1)^T (E R2)`` so G is never formed."""
    return ((h @ proj.r_h).t() @ (e @ proj.r_v)).reshape(-1)


def exact_from_factors(h: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Paper-faithful path: the full flattened last-layer gradient
    ``H^T E`` (d_h * d_v,)."""
    return (h.t() @ e).reshape(-1)
