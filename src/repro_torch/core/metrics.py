"""Paper evaluation metrics: Overlap Index, Noise Overlap Index (§5.2
Table 4), relative test error, speedup/energy accounting (a copy of the
reference's numpy-only module)."""
from __future__ import annotations

import numpy as np


def overlap_index(prev_indices, cur_indices) -> float:
    """Fraction of common units between consecutive selection rounds,
    normalized by subset size (paper's OI)."""
    a = set(int(i) for i in np.asarray(prev_indices) if i >= 0)
    b = set(int(i) for i in np.asarray(cur_indices) if i >= 0)
    denom = max(len(b), 1)
    return len(a & b) / denom


def noise_overlap_index(sel_indices, noise_flags) -> float:
    """(# selected noisy units) / (# noisy units) (paper's NOI)."""
    flags = np.asarray(noise_flags)
    sel = [int(i) for i in np.asarray(sel_indices) if i >= 0]
    n_noisy = max(int(flags.sum()), 1)
    return float(flags[sel].sum()) / n_noisy


def relative_test_error(err: float, err_full: float) -> float:
    """Paper's Rel. Test Error (%): (err - err_full) / err_full * 100."""
    return (err - err_full) / max(err_full, 1e-12) * 100.0


def speedup(full_cost: float, subset_cost: float) -> float:
    return full_cost / max(subset_cost, 1e-12)


def training_cost_units(n_epochs: int, warm_epochs: int, subset_frac: float,
                        select_rounds: int = 0, select_cost_frac: float = 0.0
                        ) -> float:
    """Cost in full-epoch units: warm-start epochs at 1.0 + remaining epochs
    at subset_frac + selection overhead per round."""
    return (warm_epochs
            + (n_epochs - warm_epochs) * subset_frac
            + select_rounds * select_cost_frac)
