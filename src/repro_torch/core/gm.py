"""Gradient Matching (paper Algorithm 2): Orthogonal Matching Pursuit with
l2-regularized weight refits, solved in Gram space (the reference's
``core/gm.py``).

Given unit-gradient vectors G (n, D) and a target g_t, OMP needs only
K = G G^T, c = G g_t and ||g_t||^2.  Each iteration picks the unit most
aligned with the residual and refits the ridge weights on the selected
set — by triangular solves against an incrementally grown Cholesky
factor (``solver="chol"``, the default), or by the dense masked solve
kept as the oracle (``solver="dense"``).

E_lambda(w, X) = lambda ||w||^2 + w^T K_XX w - 2 w^T c_X + ||g_t||^2.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class OMPResult(NamedTuple):
    indices: torch.Tensor     # (budget,) int64, padded with -1
    weights: torch.Tensor     # (budget,) fp32, 0 for unused slots
    n_selected: int
    error: torch.Tensor       # final E_lambda value


def gram(g: torch.Tensor) -> torch.Tensor:
    """(n, D) -> (n, n) fp32 Gram matrix (oracle of the omp_gram kernel)."""
    g = g.to(torch.float32)
    return g @ g.t()


def _masked_ridge_solve(K_sub, c_sub, active, lam):
    """Solve (K_sub + lam I) w = c_sub over the active rows; inactive
    rows are identity rows, so w_i = 0 there (the dense oracle)."""
    k = K_sub.shape[0]
    act = active.to(torch.float32)
    M = K_sub * (act[:, None] * act[None, :]) \
        + torch.eye(k, device=K_sub.device) * (lam * act + (1.0 - act))
    return torch.linalg.solve(M, c_sub * act) * act


def _chol_append(L, K, safe, j, i, lam):
    """Grow the Cholesky factor of (K_active + lam I) by the row of the
    atom ``j`` just placed at slot ``i``; rows past the active prefix
    stay identity rows, which decouples them from both solves."""
    idx = torch.arange(L.shape[0], device=L.device)
    k_col = torch.where(idx < i, K[safe, j], 0.0)
    v = torch.linalg.solve_triangular(L, k_col[:, None], upper=False)[:, 0]
    dnew = torch.sqrt(torch.clamp(K[j, j] + lam - v @ v, min=1e-12))
    row = torch.where(idx < i, v, torch.where(idx == i, dnew, 0.0))
    L = L.clone()
    L[i] = row
    return L


def _chol_ridge_solve(L, c_sub, active):
    act = active.to(torch.float32)
    y = torch.linalg.solve_triangular(L, (c_sub * act)[:, None], upper=False)
    w = torch.linalg.solve_triangular(L.t(), y, upper=True)[:, 0]
    return w * act


def _scatter_in_slot_order(n, safe, vals):
    """``zeros(n).at[safe].set(vals)`` with the reference's semantics for
    repeated indices: slots are written in order, so the last write wins.
    The inactive slots alias unit 0 with value 0; when unit 0 is selected
    while slots remain, its weight reads 0 until the budget fills, as in
    the reference."""
    b = safe.shape[0]
    later = torch.triu(torch.ones((b, b), dtype=torch.bool,
                                  device=safe.device), diagonal=1)
    overwritten = ((safe[:, None] == safe[None, :]) & later).any(dim=1)
    keep = ~overwritten
    w = torch.zeros((n,), device=vals.device)
    w[safe[keep]] = vals[keep]
    return w


def gram_omp(K: torch.Tensor, c: torch.Tensor, target_sq: torch.Tensor,
             budget: int, lam: float = 0.5, eps: float = 1e-10,
             nonneg: bool = True, solver: str = "chol") -> OMPResult:
    if solver not in ("chol", "dense"):
        raise ValueError(f"unknown gram_omp solver {solver!r}")
    n = K.shape[0]
    budget = min(budget, n)
    dev = K.device

    def error_of(w):
        return lam * torch.sum(w ** 2) + w @ (K @ w) - (2.0 * w) @ c \
            + target_sq

    slots = torch.arange(budget, device=dev)
    sel = torch.full((budget,), -1, dtype=torch.long, device=dev)
    w_full = torch.zeros((n,), device=dev)
    err = target_sq + 0.0
    L = torch.eye(budget, device=dev)
    i = 0
    while i < budget and float(err) > eps:
        # alignment of each unit with the residual r = g_t - sum w g; the
        # first maximum wins, taken units are masked with -inf
        scores = c - K @ w_full
        taken = torch.zeros((n,), dtype=torch.bool, device=dev)
        taken[sel[sel >= 0]] = True
        scores = torch.where(taken, float("-inf"), scores)
        j = int(torch.argmax(scores))  # repro_torch: noqa[host-sync-loop] -- the greedy pick indexes the next solve; stage B is eager, one read an OMP iteration (a budget of units)
        sel[i] = j
        safe = torch.where(sel >= 0, sel, torch.zeros_like(sel))
        c_sub = c[safe]
        active = slots <= i
        if solver == "chol":
            L = _chol_append(L, K, safe, j, i, lam)
            w_sub = _chol_ridge_solve(L, c_sub, active)
        else:
            w_sub = _masked_ridge_solve(K[safe][:, safe], c_sub, active, lam)
        if nonneg:
            w_sub = torch.clamp(w_sub, min=0.0)
        w_full = _scatter_in_slot_order(n, safe, w_sub * active)
        err = error_of(w_full)
        i += 1
    safe = torch.where(sel >= 0, sel, torch.zeros_like(sel))
    w_sel = w_full[safe] * (sel >= 0)
    return OMPResult(sel, w_sel, i, err)
