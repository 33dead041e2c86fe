"""PGM — Partitioned Gradient Matching (paper Algorithm 1), the
reference's ``core/pgm.py`` without a mesh.

Every ``R`` epochs:
  stage A  per-unit last-layer gradient representations of all candidate
           units (sketched by default; exact = paper-faithful);
  stage B  split the units into D partitions; per partition, gradient
           matching (Algorithm 2, ``gm.py``) against the partition's own
           summed gradient (Val=False) or the validation gradient
           (Val=True, robust mode), each with budget b_k/D;
  stage C  concatenate the partial subsets and their weights.

Stage B builds all D Gram matrices in one call of the ``omp_gram``
kernel (the Hopper kernel on the card, its plain version on the CPU).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import gm
from repro_torch.core.lastlayer import units_gradients
from repro_torch.core.sketch import Projections
from repro_torch.kernels.omp_gram.ops import omp_gram_batched_op


class Selection(NamedTuple):
    indices: torch.Tensor     # (b_k,) global unit ids, -1 padded
    weights: torch.Tensor     # (b_k,) fp32
    n_selected: int
    errors: torch.Tensor      # (D,) per-partition final E_lambda


def partitioned_gm(g_units: torch.Tensor, n_partitions: int,
                   budget_per_part: int, lam: float = 0.5,
                   eps: float = 1e-10, nonneg: bool = True,
                   val_matching: bool = False,
                   g_val: Optional[torch.Tensor] = None,
                   solver: str = "chol") -> Selection:
    n, D_sk = g_units.shape
    P = n_partitions
    if n % P:
        raise ValueError(f"n units {n} must divide into {P} partitions")
    per = n // P
    gp = g_units.reshape(P, per, D_sk).to(torch.float32).contiguous()
    if val_matching:
        target = g_val.to(torch.float32).expand(P, D_sk)
    else:
        # the partition's own summed gradient (sum, not mean, so that
        # sum_i w_i g_i reaches it with O(1) weights per unit)
        target = gp.sum(dim=1)
    K = omp_gram_batched_op(gp)
    c = torch.einsum("pnd,pd->pn", gp, target)
    tsq = torch.einsum("pd,pd->p", target, target)
    res = [gm.gram_omp(K[p], c[p], tsq[p], budget_per_part, lam, eps,
                       nonneg, solver) for p in range(P)]
    idx = torch.stack([r.indices for r in res])               # (P, budget)
    offsets = (torch.arange(P, device=idx.device) * per)[:, None]
    glob = torch.where(idx >= 0, idx + offsets, torch.full_like(idx, -1))
    return Selection(indices=glob.reshape(-1),
                     weights=torch.stack([r.weights for r in res]).reshape(-1),
                     n_selected=sum(r.n_selected for r in res),
                     errors=torch.stack([r.error for r in res]))


def _stage_b(g_units, pgm_cfg, g_val=None) -> Selection:
    n_units = g_units.shape[0]
    budget_total = max(int(pgm_cfg.subset_fraction * n_units), 1)
    D = min(pgm_cfg.n_partitions, n_units)
    budget_per = max(budget_total // D, 1)
    return partitioned_gm(g_units, D, budget_per, pgm_cfg.lam, pgm_cfg.eps,
                          pgm_cfg.nonneg_weights, pgm_cfg.val_matching,
                          g_val)


def _val_target(gv: torch.Tensor, n_units: int, pgm_cfg) -> torch.Tensor:
    """Validation target: mean gradient scaled to the partition mass so
    budgets/weights stay comparable with train matching."""
    D = min(pgm_cfg.n_partitions, n_units)
    return gv.mean(dim=0) * (n_units / D)


def pgm_select(bundle, params, units, pgm_cfg,
               proj: Optional[Projections] = None,
               val_units=None) -> Selection:
    """One selection round (stages A + B) over device-resident units."""
    n_units = units["tokens"].shape[0]
    exact = not pgm_cfg.use_sketch
    g = units_gradients(bundle, params, units, proj, exact=exact)
    g_val = None
    if pgm_cfg.val_matching:
        gv = units_gradients(bundle, params, val_units, proj, exact=exact)
        g_val = _val_target(gv, n_units, pgm_cfg)
    return _stage_b(g, pgm_cfg, g_val=g_val)
