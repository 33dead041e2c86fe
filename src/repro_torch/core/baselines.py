"""Subset-selection baselines of the paper (§5 Baselines), the reference's
``core/baselines.py``: Random-Subset, LargeOnly, LargeSmall, and
GRAD-MATCHPB (unpartitioned gradient matching, the method PGM
upper-bounds).

``random_subset`` draws from a ``torch.Generator``, which cannot repeat
``jax.random``'s draws, so it is held by its invariants (budget, unique
indices, unit weights), not by the reference's indices.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.pgm import Selection, partitioned_gm


def _fixed(idx: torch.Tensor, budget: int) -> Selection:
    return Selection(indices=idx.long(),
                     weights=torch.ones((budget,), device=idx.device),
                     n_selected=budget,
                     errors=torch.zeros((1,), device=idx.device))


def random_subset(gen: torch.Generator, n_units: int, budget: int,
                  device: torch.device = torch.device("cpu")) -> Selection:
    return _fixed(torch.randperm(n_units, generator=gen)[:budget].to(device),
                  budget)


def large_only(durations: torch.Tensor, budget: int) -> Selection:
    """Longest units first (paper's LargeOnly); ties keep unit order."""
    return _fixed(torch.argsort(-durations, stable=True)[:budget], budget)


def large_small(durations: torch.Tensor, budget: int) -> Selection:
    """Half smallest + half largest (paper's LargeSmall)."""
    order = torch.argsort(durations, stable=True)
    k_small = budget // 2
    k_large = budget - k_small
    return _fixed(torch.cat([order[:k_small], order[-k_large:]]), budget)


def gradmatch_pb(g_units: torch.Tensor, budget: int, lam: float = 0.5,
                 eps: float = 1e-10, nonneg: bool = True,
                 g_val: Optional[torch.Tensor] = None) -> Selection:
    """GRAD-MATCHPB: one partition over the whole candidate set."""
    return partitioned_gm(g_units, 1, budget, lam, eps, nonneg,
                          val_matching=g_val is not None, g_val=g_val)
