"""Training loop of paper Algorithm 1 (the reference's
``train/loop.py:train_with_selection`` on one device): warm start on
full data, re-selection every R epochs by PGM or a baseline, weighted
mini-batch SGD on the subset, newbob lr annealing on validation loss,
cost accounting, and the reference's fault tolerance.

Execution goes through one engine interface (``train/engine.py:
make_engine``):

* ``engine="scan"`` (the default): ``EpochEngine``, units on the device
  and each epoch one captured CUDA graph of the step replayed over the
  plan (on the CPU the same loop without a graph).  ``epoch_chunk > 1``
  runs up to that many epochs of one selection context as one
  ``run_epochs`` call (validation and the fp32 newbob update on the
  device, metrics read once a chunk; chunk boundaries at selection
  epochs); a plan prefetcher builds the next plans on a worker thread
  (``data/plan_prefetch.py``), which also retries a failed build.
* ``engine="host"``: ``HostEngine``, the per-batch parity oracle.

With ``resident_selection=True`` (and ``method="pgm"``) stage A of each
round runs through ``core/pgm.ResidentSelector`` over the engine's
device-resident units: on the card one captured CUDA graph per unit
corpus (train, val), replayed every round, instead of ``pgm_select``'s
unit-by-unit eager pass.

The fault tolerance:

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
from repro_torch.core.pgm import ResidentSelector, Selection, pgm_select
from repro_torch.core.sketch import Projections
from repro_torch.data.pipeline import unit_durations
from repro_torch.data.plan_prefetch import PlanPrefetcher
from repro_torch.kernels.backend import resolve_device
from repro_torch.models.common import tree_map
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import faults as faults_mod
from repro_torch.train.engine import make_engine
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
            key_seed: int, proj, val_units, durations,
            resident: Optional[ResidentSelector] = None, mesh=None,
            data_axis: str = "data") -> Selection:
    """One selection round of ``method`` over the device-resident units
    (the reference's ``train/loop.py:_select``); ``params`` whole."""
    pc = tc.pgm
    n_units = units["tokens"].shape[0]
    budget = max(int(pc.subset_fraction * n_units), 1)
    if method == "pgm":
        if resident is not None:
            return resident(params, units, val_units=val_units)
        return pgm_select(bundle, params, units, pc, proj,
                          val_units=val_units, mesh=mesh,
                          data_axis=data_axis)
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


def _copy_to(x, dev: torch.device) -> torch.Tensor:
    """A copy of an initial leaf (numpy or a tensor) on ``dev``: the
    engines update their params in place, never the caller's."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(dev, copy=True)
    return torch.tensor(x, device=dev)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


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
    engine: str = "scan",
    resident_selection: bool = False,
    epoch_chunk: int = 1,
    fault_plan: Optional[faults_mod.FaultPlan] = None,
    device: Optional[str] = None,
    params=None,
    proj: Optional[Projections] = None,
    mesh=None,
    data_axis: str = "data",
    spec_mode: str = "tp",
    log_fn: Callable[[str], None] = lambda s: None,
) -> History:
    """Run Algorithm 1 on ``device`` (the card unless ``"cpu"`` is asked
    for) through ``engine`` (``"scan"`` or ``"host"``).  ``params``/
    ``proj``: optional initial params tree and sketch projections (moved
    to the device).  On the scan engine ``History.final_params`` are the
    engine's buffers.

    With ``mesh`` (a ``DeviceMesh``; every rank calls this with the same
    arguments) the engine trains data-parallel on it (``spec_mode``: the
    ``SpecBuilder`` policy whose batch axes split the batch; a ``pod``
    axis runs ``tc.compress_mode``), selection rounds take the sharded
    stage B over ``data_axis``, checkpoints hold whole arrays written by
    rank 0 (per-pod error-feedback state under ``err``) and restore onto
    any mesh, and only rank 0 logs."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; one of {METHODS}")
    dev = resolve_device(device)
    eng = make_engine(engine, bundle, tc, units, val_units=val_units,
                      batch_units=batch_units, device=dev, mesh=mesh,
                      spec_mode=spec_mode)
    if not eng.is_writer:
        log_fn = lambda s: None     # noqa: E731 (rank 0 alone prints)
    is_scan = eng.kind == "scan"
    # the engine may rebuild the bundle (loss_vocab_chunk auto-tune)
    bundle = eng.bundle
    key_seed = tc.seed
    gen = torch.Generator().manual_seed(key_seed)
    params = (bundle.init_params(gen, dev) if params is None
              else tree_map(lambda p: _copy_to(p, dev), params))
    proj = (make_proj_for(bundle, gen, tc.pgm.sketch_dim_h,
                          tc.pgm.sketch_dim_v, dev) if proj is None
            else Projections(*(torch.tensor(x, device=dev) for x in proj)))
    # resident rounds: one selector (on the card, one graph a corpus)
    # for the whole run, built on the engine's tuned bundle
    resident = (ResidentSelector(bundle, tc.pgm, proj, mesh=mesh,
                                 data_axis=data_axis, log_fn=log_fn)
                if resident_selection and method == "pgm" else None)
    opt_init, _ = make_update_for(tc)
    opt_state = opt_init(params)
    if is_scan:
        eng.adopt(params, opt_state)
    durations = torch.as_tensor(unit_durations(
        {k: np.asarray(v) for k, v in units.items()})).to(dev)

    hist = History()
    newbob = NewbobState(tc.lr)
    selection: Optional[Selection] = None
    start_epoch = 0
    guard_on = bool(tc.nonfinite_guard)
    mesh_shape = eng.mesh_shape
    # pod-axis compression: the per-pod top-k residuals ride the
    # checkpoint under "err", so a resume continues from them
    uses_err = eng.uses_error_feedback
    pod_mode = eng.pod_axis is not None

    def _template_fn(manifest):
        tmpl = {"params": params, "opt": opt_state}
        if uses_err and any("'err'" in k for k in manifest["arrays"]):
            tmpl["err"] = eng.init_compress_state(params)
        return tmpl

    def _restore_newest():
        """State from the newest checkpoint that passes verification ->
        ``(params, opt_state, newbob, selection, next epoch)``; on a mesh
        this rank's pod's error-feedback state."""
        loaded, manifest = ckpt_mod.restore_latest_intact(
            ckpt_dir, template_fn=_template_fn,
            sharding_fn=eng.restore_sharding, log_fn=log_fn)
        if uses_err:
            if "err" not in loaded:
                log_fn("warning: no error-feedback state in checkpoint; "
                       "top-k residuals restart from zero")
            eng.set_compress_state(loaded.get("err"))
        saved_cm = manifest.get("compress_mode")
        if (saved_cm or "none") != tc.compress_mode:
            log_fn(f"warning: checkpoint was written with compress_mode="
                   f"{saved_cm or 'none'!r}, resuming with "
                   f"{tc.compress_mode!r}")
        saved_mesh = manifest.get("mesh_shape")
        if saved_mesh != mesh_shape:
            log_fn(f"resharded checkpoint (saved mesh {saved_mesh} -> "
                   f"current {mesh_shape})")
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
    prefetcher = (PlanPrefetcher(max_pending=max(2, epoch_chunk))
                  if is_scan else None)
    sel_round = 0          # prefetch key component: one per selection

    def _use_full(e: int) -> bool:
        return method == "full" or e < warm

    def _is_sel_epoch(e: int) -> bool:
        return not _use_full(e) and (e - warm) % R == 0

    def _plan_builder(e: int, sel: Optional[Selection]):
        """A pure, host-only builder of epoch ``e``'s plan (safe on the
        prefetch thread: the selection is copied to the host here)."""
        if _use_full(e):
            base = lambda: eng.full_plan(e)
        else:
            idx, w = _host(sel.indices), _host(sel.weights)
            base = lambda: eng.subset_plan(idx, w, e)
        if fault_plan is None:
            return base

        def build():
            # the scan engine's prefetcher retries an injected failure;
            # the host engine has none, so it raises out of the run
            fault_plan.maybe_fail_prefetch(e)
            return fault_plan.poison_plan(e, base())
        return build

    def _plan_key(e: int, rnd: int):
        # the watchdog re-keys plans by bumping plan_salt; keys carry it
        # so a stale pending plan never resolves
        return (("full", eng.plan_salt, e) if _use_full(e)
                else ("subset", eng.plan_salt, rnd, e))

    def _get_plan(e: int):
        build = _plan_builder(e, selection)
        if prefetcher is None:
            return build()
        return prefetcher.get(_plan_key(e, sel_round), build)

    writer = (ckpt_mod.AsyncCheckpointer(ckpt_dir)
              if ckpt_dir and eng.is_writer else None)
    preempt = faults_mod.PreemptionHandler(log_fn=log_fn).install()
    t0 = time.time()
    try:
        epoch = start_epoch
        while epoch < tc.epochs:
            use_full = _use_full(epoch)
            # --- selection round ---
            if not use_full and (selection is None or _is_sel_epoch(epoch)):
                t_sel = time.time()
                new_sel = _select(method, bundle, params,
                                  eng.units, tc, epoch, key_seed, proj,
                                  eng.val_units, durations,
                                  resident=resident, mesh=mesh,
                                  data_axis=data_axis)
                oi = (overlap_index(selection.indices.cpu().numpy(),  # repro_torch: noqa[host-sync-loop] -- one read a selection round (the overlap index), not a step
                                    new_sel.indices.cpu().numpy())  # repro_torch: noqa[host-sync-loop] -- the same read, of the new round
                      if selection is not None else float("nan"))
                selection = new_sel
                sel_round += 1
                if prefetcher is not None:
                    prefetcher.invalidate()
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

            # --- a chunk of SGD epochs sharing this selection context ---
            if method == "full":
                boundary = tc.epochs
            elif epoch < warm:
                boundary = warm
            else:
                boundary = warm + ((epoch - warm) // R + 1) * R
            boundary = min(boundary, tc.epochs)
            chunk = (max(1, min(epoch_chunk, boundary - epoch))
                     if is_scan else 1)
            chunk_epochs = list(range(epoch, epoch + chunk))
            plans = [_get_plan(e) for e in chunk_epochs]
            # every later epoch whose selection context is decided can be
            # built on the prefetch thread while this chunk runs
            if prefetcher is not None:
                e_next = epoch + chunk
                while e_next < tc.epochs and not _is_sel_epoch(e_next):
                    if not prefetcher.schedule(
                            _plan_key(e_next, sel_round),
                            _plan_builder(e_next, selection)):
                        break
                    e_next += 1

            n_sel = None if use_full else int(selection.n_selected)
            for p in plans:
                hist.cost_units += eng.epoch_cost(p, use_full=use_full,
                                                  n_selected=n_sel)
            if epoch_chunk == 1 or not is_scan:
                # per-epoch: validation and newbob on the host.  Keyed off
                # the requested chunk size, so a chunked run uses the fp32
                # device newbob everywhere, size-1 chunks included
                params, opt_state, step_losses = eng.run_epoch(
                    params, opt_state, newbob.lr, plans[0])
                losses = step_losses[eng.plan_live_steps(plans[0])]
                train_losses = [float(np.mean(losses)) if losses.size
                                else float("nan")]
                has_live = [losses.size > 0]
                if eng.val_units is not None:
                    vl = eng.validate(params)
                    newbob = newbob.update(vl, tc.anneal_factor,
                                           tc.improvement_threshold)
                else:
                    vl = float("nan")
                val_losses, lrs = [vl], [newbob.lr]
            else:
                (params, opt_state, step_losses, vls, lrs_out, lr_out,
                 prev_out) = eng.run_epochs(params, opt_state, newbob.lr,
                                            newbob.prev_loss, plans)
                train_losses, has_live = [], []
                for i, p in enumerate(plans):
                    l = step_losses[i][eng.plan_live_steps(p)]
                    train_losses.append(float(np.mean(l)) if l.size
                                        else float("nan"))
                    has_live.append(l.size > 0)
                val_losses = [float(v) for v in vls]
                lrs = [float(v) for v in lrs_out]
                newbob = NewbobState(lr_out, prev_out)

            # --- divergence watchdog ---
            if guard_on:
                skm = (_host(eng.last_skipped).reshape(-1) > 0.5
                       if eng.last_skipped is not None
                       else np.zeros(0, bool))
                n_sk = int(np.sum(skm))
                hist.skipped_steps += n_sk
                span = f"epochs {chunk_epochs[0]}..{chunk_epochs[-1]}"
                if n_sk:
                    log_fn(f"guard: skipped {n_sk} non-finite step(s) in "
                           f"{span}")
                bad_train = any(not np.isfinite(tl) for tl, h
                                in zip(train_losses, has_live) if h)
                bad_val = (eng.val_units is not None
                           and any(not np.isfinite(v) for v in val_losses))
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
                    log_fn(f"watchdog: {reason} in {span}; rolling back "
                           f"with a re-keyed batch plan")
                    if writer is not None:
                        try:
                            writer.wait()
                        except Exception as e:
                            log_fn(f"warning: async checkpoint write "
                                   f"failed: {e}")
                    eng.barrier()      # every rank reads what rank 0 wrote
                    eng.plan_salt += 1
                    sel_round += 1
                    if prefetcher is not None:
                        prefetcher.invalidate()
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
                        if uses_err:
                            eng.set_compress_state(None)
                        newbob = NewbobState(tc.lr)
                        selection = None
                        epoch = 0
                        log_fn("watchdog: no checkpoint; restarting from "
                               "re-initialised state")
                    continue

            for e, tl, vl, lr in zip(chunk_epochs, train_losses,
                                     val_losses, lrs):
                hist.train_loss.append(tl)
                hist.val_loss.append(vl)
                hist.lr.append(lr)
                log_fn(f"epoch {e}: train {tl:.4f} val {vl:.4f} "
                       f"lr {lr:.4f}")

            last = chunk_epochs[-1]
            if fault_plan is not None:
                fault_plan.maybe_preempt(last)
            preempted = eng.any_rank(preempt.triggered)
            if ckpt_dir:
                extra = {"epoch": last, "lr": newbob.lr,
                         "prev_loss": newbob.prev_loss,
                         "sel_indices": (selection.indices.cpu().tolist()
                                         if selection is not None else None),
                         "sel_weights": (selection.weights.cpu().tolist()
                                         if selection is not None else None)}
                if preempted:
                    extra["preempted"] = True
                tree = {"params": params, "opt": opt_state}
                if uses_err:        # every pod's (a collective)
                    eng.init_compress_state_once(params)
                    tree["err"] = eng.full_err()
                if writer is not None:
                    writer.submit(last, tree, extra, mesh_shape=mesh_shape,
                                  compress_mode=(tc.compress_mode if pod_mode
                                                 else None))
            if preempted:
                if writer is not None:
                    writer.wait()
                hist.preempted = True
                log_fn(f"preemption: emergency checkpoint at epoch "
                       f"{last}; exiting resumably")
                break
            epoch += chunk
        if writer is not None:
            writer.wait()    # raise a deferred write error before returning
    finally:
        preempt.uninstall()
        if prefetcher is not None:
            prefetcher.close()
        if writer is not None:
            try:
                writer.close()
            except Exception as e:
                log_fn(f"warning: checkpoint writer failed on close: {e}")
    # on a mesh no rank returns (and, say, resumes from the checkpoints)
    # before rank 0's last write is in place
    eng.barrier()

    hist.wall_time = time.time() - t0
    hist.final_params = params
    return hist
