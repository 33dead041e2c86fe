"""Training loop of paper Algorithm 1 (the reference's
``train/loop.py:train_with_selection`` with ``engine="host"``, the only
engine ported): warm start on full data, re-selection every R epochs by
PGM or a baseline, weighted mini-batch SGD on the subset, newbob lr
annealing on validation loss, and cost accounting.

Initial params and sketch projections are drawn from one
``torch.Generator`` seeded with ``tc.seed`` unless the caller hands them
in (a parity test hands in the reference's).  The ``random`` baseline
draws from a generator seeded with ``(tc.seed, epoch)``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core import baselines as bl
from repro_torch.core.lastlayer import make_proj_for, units_gradients
from repro_torch.core.metrics import overlap_index
from repro_torch.core.pgm import Selection, pgm_select
from repro_torch.core.sketch import Projections
from repro_torch.data.pipeline import unit_durations
from repro_torch.kernels.backend import resolve_device
from repro_torch.models.common import tree_map
from repro_torch.train.engine import HostEngine
from repro_torch.train.optim import NewbobState, make_update_for

METHODS = ("pgm", "random", "large_only", "large_small", "gradmatch_pb",
           "full")


@dataclasses.dataclass
class History:
    train_loss: List[float] = dataclasses.field(default_factory=list)
    val_loss: List[float] = dataclasses.field(default_factory=list)
    lr: List[float] = dataclasses.field(default_factory=list)
    selections: List[Dict] = dataclasses.field(default_factory=list)
    cost_units: float = 0.0        # full-epoch-equivalent compute units
    wall_time: float = 0.0
    final_params: Any = None


def _select(method, bundle, params, units, tc: TrainConfig, epoch: int,
            proj, val_units, durations) -> Selection:
    """One selection round of ``method`` over the device-resident units
    (the reference's ``train/loop.py:_select`` without a mesh)."""
    pc = tc.pgm
    n_units = units["tokens"].shape[0]
    budget = max(int(pc.subset_fraction * n_units), 1)
    if method == "pgm":
        return pgm_select(bundle, params, units, pc, proj,
                          val_units=val_units)
    if method == "random":
        gen = torch.Generator().manual_seed(tc.seed * 1_000_003 + 1000
                                            + epoch)
        return bl.random_subset(gen, n_units, budget, durations.device)
    if method == "large_only":
        return bl.large_only(durations, budget)
    if method == "large_small":
        return bl.large_small(durations, budget)
    if method == "gradmatch_pb":
        g = units_gradients(bundle, params, units, proj,
                            exact=not pc.use_sketch)
        g_val = None
        if pc.val_matching:
            gv = units_gradients(bundle, params, val_units, proj,
                                 exact=not pc.use_sketch)
            g_val = gv.mean(dim=0) * float(n_units)
        return bl.gradmatch_pb(g, budget, pc.lam, pc.eps, pc.nonneg_weights,
                               g_val=g_val)
    raise ValueError(method)


def train_with_selection(
    bundle,
    units: Dict[str, np.ndarray],
    tc: TrainConfig,
    *,
    method: str = "pgm",
    val_units: Optional[Dict[str, np.ndarray]] = None,
    batch_units: int = 1,
    device: Optional[str] = None,
    params=None,
    proj: Optional[Projections] = None,
    log_fn: Callable[[str], None] = lambda s: None,
) -> History:
    """Run Algorithm 1 on ``device`` (the card unless ``"cpu"`` is asked
    for).  ``params``/``proj``: optional initial params dict and sketch
    projections (moved to the device)."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; one of {METHODS}")
    dev = resolve_device(device)
    eng = HostEngine(bundle, tc, units, val_units=val_units,
                     batch_units=batch_units, device=dev)
    # the engine may rebuild the bundle (loss_vocab_chunk auto-tune)
    bundle = eng.bundle
    gen = torch.Generator().manual_seed(tc.seed)
    params = (bundle.init_params(gen, dev) if params is None
              else tree_map(lambda p: torch.tensor(p, device=dev), params))
    proj = (make_proj_for(bundle, gen, tc.pgm.sketch_dim_h,
                          tc.pgm.sketch_dim_v, dev) if proj is None
            else Projections(*(torch.tensor(x, device=dev) for x in proj)))
    opt_init, _ = make_update_for(tc)
    opt_state = opt_init(params)
    durations = torch.as_tensor(unit_durations(
        {k: np.asarray(v) for k, v in units.items()})).to(dev)

    hist = History()
    newbob = NewbobState(tc.lr)
    selection: Optional[Selection] = None
    warm = tc.pgm.warm_start_epochs
    R = tc.pgm.select_every
    t0 = time.time()
    for epoch in range(tc.epochs):
        use_full = method == "full" or epoch < warm
        if not use_full and (selection is None or (epoch - warm) % R == 0):
            t_sel = time.time()
            new_sel = _select(method, bundle, params, eng.units, tc, epoch,
                              proj, eng.val_units, durations)
            oi = (overlap_index(selection.indices.cpu().numpy(),
                                new_sel.indices.cpu().numpy())
                  if selection is not None else float("nan"))
            selection = new_sel
            # a gradient pass over all units costs ~1/3 epoch
            if method in ("pgm", "gradmatch_pb"):
                hist.cost_units += 1.0 / 3.0
            indices = selection.indices.cpu().tolist()
            weights = selection.weights.cpu().tolist()
            hist.selections.append({
                "epoch": epoch,
                "indices": indices,
                "weights": weights,
                "overlap_index": oi,
                # host clock, the round's results copied back to the host
                "seconds": time.time() - t_sel,
            })
            log_fn(f"epoch {epoch}: selected {selection.n_selected} units "
                   f"(OI={oi:.3f})")
        if use_full:
            plan = eng.full_plan(epoch)
            hist.cost_units += eng.epoch_cost(use_full=True)
        else:
            plan = eng.subset_plan(selection.indices.cpu().numpy(),
                                   selection.weights.cpu().numpy(), epoch)
            hist.cost_units += eng.epoch_cost(
                n_selected=selection.n_selected)
        params, opt_state, losses = eng.run_epoch(params, opt_state,
                                                  newbob.lr, plan)
        tl = float(losses.mean()) if losses.size else float("nan")
        if eng.val_units is not None:
            vl = eng.validate(params)
            newbob = newbob.update(vl, tc.anneal_factor,
                                   tc.improvement_threshold)
        else:
            vl = float("nan")
        hist.train_loss.append(tl)
        hist.val_loss.append(vl)
        hist.lr.append(newbob.lr)
        log_fn(f"epoch {epoch}: train {tl:.4f} val {vl:.4f} "
               f"lr {newbob.lr:.4f}")
    hist.wall_time = time.time() - t0
    hist.final_params = params
    return hist
