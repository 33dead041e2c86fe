"""Training loop of paper Algorithm 1 (the reference's
``train/loop.py:train_with_selection`` on its host-engine branch, the
only engine ported): warm start on full data, re-selection every R
epochs by PGM or a baseline, weighted mini-batch SGD on the subset,
newbob lr annealing on validation loss, cost accounting, and the
reference's fault tolerance:

* a checkpoint after every epoch (``ckpt_dir``, the reference's format
  and ``extra`` keys), and ``resume`` from the newest intact one, the
  selection rebuilt from the manifest;
* with ``TrainConfig.nonfinite_guard``, the step's on-device guard and
  the host-side divergence watchdog: K consecutive skipped steps
  (``max_skipped_steps``) or a non-finite train/val loss roll the run
  back to the newest intact checkpoint (or re-initialise it without
  one) with re-keyed batch plans, giving up after 3 rollbacks;
* on SIGTERM/SIGINT, an emergency checkpoint after the epoch in flight,
  and a return with ``History.preempted``.

Initial params and sketch projections are drawn from one
``torch.Generator`` seeded with ``tc.seed`` unless the caller hands them
in (a parity test hands in the reference's).  The ``random`` baseline
draws from a generator seeded with ``(key seed, epoch)``; a watchdog
re-initialisation re-keys that seed with ``7919 + rollbacks``, where
the reference folds the same number into its ``jax.random`` key.
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
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import faults as faults_mod
from repro_torch.train.engine import HostEngine, plan_live_steps
from repro_torch.train.optim import NewbobState, make_update_for

METHODS = ("pgm", "random", "large_only", "large_small", "gradmatch_pb",
           "full")
MAX_ROLLBACKS = 3


@dataclasses.dataclass
class History:
    train_loss: List[float] = dataclasses.field(default_factory=list)
    val_loss: List[float] = dataclasses.field(default_factory=list)
    lr: List[float] = dataclasses.field(default_factory=list)
    selections: List[Dict] = dataclasses.field(default_factory=list)
    cost_units: float = 0.0        # full-epoch-equivalent compute units
    wall_time: float = 0.0
    final_params: Any = None
    skipped_steps: int = 0         # non-finite steps gated off on device
    rollbacks: int = 0             # divergence-watchdog restores
    preempted: bool = False        # returned early on SIGTERM/SIGINT


def _max_consecutive(mask: np.ndarray) -> int:
    best = cur = 0
    for v in mask:
        cur = cur + 1 if v else 0
        best = max(best, cur)
    return best


def _select(method, bundle, params, units, tc: TrainConfig, epoch: int,
            key_seed: int, proj, val_units, durations) -> Selection:
    """One selection round of ``method`` over the device-resident units
    (the reference's ``train/loop.py:_select`` without a mesh)."""
    pc = tc.pgm
    n_units = units["tokens"].shape[0]
    budget = max(int(pc.subset_fraction * n_units), 1)
    if method == "pgm":
        return pgm_select(bundle, params, units, pc, proj,
                          val_units=val_units)
    if method == "random":
        gen = torch.Generator().manual_seed(key_seed * 1_000_003 + 1000
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
    ckpt_dir: Optional[str] = None,
    resume: bool = False,
    engine: str = "host",
    fault_plan: Optional[faults_mod.FaultPlan] = None,
    device: Optional[str] = None,
    params=None,
    proj: Optional[Projections] = None,
    log_fn: Callable[[str], None] = lambda s: None,
) -> History:
    """Run Algorithm 1 on ``device`` (the card unless ``"cpu"`` is asked
    for).  ``params``/``proj``: optional initial params tree and sketch
    projections (moved to the device).  ``engine="scan"`` raises: the
    scanned engine is not ported."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; one of {METHODS}")
    if engine == "scan":      # never fall back to the host loop quietly
        raise ValueError(
            "engine='scan': the scanned epoch engine is not ported yet "
            "(ROADMAP.md queue 1, item 2); use engine='host'")
    if engine != "host":
        raise ValueError(f"unknown engine {engine!r}; the port has 'host'")
    dev = resolve_device(device)
    eng = HostEngine(bundle, tc, units, val_units=val_units,
                     batch_units=batch_units, device=dev)
    # the engine may rebuild the bundle (loss_vocab_chunk auto-tune)
    bundle = eng.bundle
    key_seed = tc.seed
    gen = torch.Generator().manual_seed(key_seed)
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
    start_epoch = 0
    guard_on = bool(tc.nonfinite_guard)

    def _restore_newest():
        """State from the newest checkpoint that passes verification ->
        ``(params, opt_state, newbob, selection, next epoch)``."""
        loaded, manifest = ckpt_mod.restore_latest_intact(
            ckpt_dir, template={"params": params, "opt": opt_state},
            log_fn=log_fn)
        saved_cm = manifest.get("compress_mode")
        if (saved_cm or "none") != "none":
            log_fn(f"warning: checkpoint was written with compress_mode="
                   f"{saved_cm!r}, resuming with 'none'")
        if manifest.get("mesh_shape") is not None:
            log_fn(f"resharded checkpoint (saved mesh "
                   f"{manifest['mesh_shape']} -> current None)")
        extra = manifest["extra"]
        sel = None
        if extra.get("sel_indices") is not None:
            idx = extra["sel_indices"]
            sel = Selection(
                torch.tensor(idx, dtype=torch.int32, device=dev),
                torch.tensor(extra["sel_weights"], dtype=torch.float32,
                             device=dev),
                sum(1 for i in idx if i >= 0),
                torch.zeros((1,), device=dev))
        return (loaded["params"], loaded["opt"],
                NewbobState(extra["lr"], extra["prev_loss"]), sel,
                extra["epoch"] + 1)

    if resume and ckpt_dir and ckpt_mod.latest_step(ckpt_dir) is not None:
        params, opt_state, newbob, selection, start_epoch = _restore_newest()
        log_fn(f"resumed at epoch {start_epoch}")

    warm = tc.pgm.warm_start_epochs
    R = tc.pgm.select_every

    def _use_full(e: int) -> bool:
        return method == "full" or e < warm

    def _plan(e: int):
        if _use_full(e):
            plan = eng.full_plan(e)
        else:
            plan = eng.subset_plan(selection.indices.cpu().numpy(),
                                   selection.weights.cpu().numpy(), e)
        if fault_plan is not None:
            # the host loop has no prefetcher: an injected plan-build
            # failure raises out of the run
            fault_plan.maybe_fail_prefetch(e)
            plan = fault_plan.poison_plan(e, plan)
        return plan

    writer = ckpt_mod.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    preempt = faults_mod.PreemptionHandler(log_fn=log_fn).install()
    t0 = time.time()
    try:
        epoch = start_epoch
        while epoch < tc.epochs:
            use_full = _use_full(epoch)
            # --- selection round ---
            if not use_full and (selection is None
                                 or (epoch - warm) % R == 0):
                t_sel = time.time()
                new_sel = _select(method, bundle, params, eng.units, tc,
                                  epoch, key_seed, proj, eng.val_units,
                                  durations)
                oi = (overlap_index(selection.indices.cpu().numpy(),
                                    new_sel.indices.cpu().numpy())
                      if selection is not None else float("nan"))
                selection = new_sel
                # a gradient pass over all units costs ~1/3 epoch
                if method in ("pgm", "gradmatch_pb"):
                    hist.cost_units += 1.0 / 3.0
                hist.selections.append({
                    "epoch": epoch,
                    "indices": selection.indices.cpu().tolist(),
                    "weights": selection.weights.cpu().tolist(),
                    "overlap_index": oi,
                    # host clock, the round's results copied to the host
                    "seconds": time.time() - t_sel,
                })
                log_fn(f"epoch {epoch}: selected {selection.n_selected} "
                       f"units (OI={oi:.3f})")

            # --- one SGD epoch ---
            plan = _plan(epoch)
            hist.cost_units += eng.epoch_cost(
                use_full=use_full,
                n_selected=None if use_full else selection.n_selected)
            params, opt_state, step_losses = eng.run_epoch(
                params, opt_state, newbob.lr, plan)
            losses = step_losses[plan_live_steps(plan)]
            tl = float(losses.mean()) if losses.size else float("nan")
            if eng.val_units is not None:
                vl = eng.validate(params)
                newbob = newbob.update(vl, tc.anneal_factor,
                                       tc.improvement_threshold)
            else:
                vl = float("nan")

            # --- divergence watchdog ---
            if guard_on:
                skm = (eng.last_skipped > 0.5 if eng.last_skipped is not None
                       else np.zeros(0, bool))
                n_sk = int(skm.sum())
                hist.skipped_steps += n_sk
                if n_sk:
                    log_fn(f"guard: skipped {n_sk} non-finite step(s) in "
                           f"epochs {epoch}..{epoch}")
                bad_train = losses.size > 0 and not np.isfinite(tl)
                bad_val = eng.val_units is not None and not np.isfinite(vl)
                K = int(tc.max_skipped_steps or 0)
                consec = _max_consecutive(skm)
                if (K > 0 and consec >= K) or bad_train or bad_val:
                    hist.rollbacks += 1
                    if hist.rollbacks > MAX_ROLLBACKS:
                        raise RuntimeError(
                            f"divergence watchdog: giving up after "
                            f"{MAX_ROLLBACKS} rollbacks")
                    reason = (f"{consec} consecutive skipped steps"
                              if K > 0 and consec >= K
                              else "non-finite loss")
                    log_fn(f"watchdog: {reason} in epochs {epoch}..{epoch}; "
                           f"rolling back with a re-keyed batch plan")
                    if writer is not None:
                        try:
                            writer.wait()
                        except Exception as e:
                            log_fn(f"warning: async checkpoint write "
                                   f"failed: {e}")
                    eng.plan_salt += 1
                    if (ckpt_dir
                            and ckpt_mod.latest_step(ckpt_dir) is not None):
                        (params, opt_state, newbob, selection,
                         epoch) = _restore_newest()
                        log_fn(f"watchdog: rolled back to epoch {epoch}")
                    else:
                        key_seed = (key_seed * 1_000_003 + 7919
                                    + hist.rollbacks)
                        params = bundle.init_params(
                            torch.Generator().manual_seed(key_seed), dev)
                        opt_state = opt_init(params)
                        newbob = NewbobState(tc.lr)
                        selection = None
                        epoch = 0
                        log_fn("watchdog: no checkpoint; restarting from "
                               "re-initialised state")
                    continue

            hist.train_loss.append(tl)
            hist.val_loss.append(vl)
            hist.lr.append(newbob.lr)
            log_fn(f"epoch {epoch}: train {tl:.4f} val {vl:.4f} "
                   f"lr {newbob.lr:.4f}")

            if fault_plan is not None:
                fault_plan.maybe_preempt(epoch)
            preempted = preempt.triggered
            if writer is not None:
                extra = {"epoch": epoch, "lr": newbob.lr,
                         "prev_loss": newbob.prev_loss,
                         "sel_indices": (selection.indices.cpu().tolist()
                                         if selection is not None else None),
                         "sel_weights": (selection.weights.cpu().tolist()
                                         if selection is not None else None)}
                if preempted:
                    extra["preempted"] = True
                writer.submit(epoch, {"params": params, "opt": opt_state},
                              extra)
            if preempted:
                if writer is not None:
                    writer.wait()
                hist.preempted = True
                log_fn(f"preemption: emergency checkpoint at epoch "
                       f"{epoch}; exiting resumably")
                break
            epoch += 1
        if writer is not None:
            writer.wait()    # raise a deferred write error before returning
    finally:
        preempt.uninstall()
        if writer is not None:
            try:
                writer.close()
            except Exception as e:
                log_fn(f"warning: checkpoint writer failed on close: {e}")

    hist.wall_time = time.time() - t0
    hist.final_params = params
    return hist
