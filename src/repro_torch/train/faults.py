"""Deterministic fault injection (the reference's ``train/faults.py``).

Every injector fires at a configured epoch or step, never at random, so
each recovery path can be held exactly:

  * ``FaultPlan.poison_plan``   -> the step's non-finite guard gates the
                                   step off bit for bit (``engine.py``)
  * ``FaultPlan.maybe_fail_prefetch`` -> raises out of the plan build;
                                   on the scan engine the plan
                                   prefetcher retries it in place
                                   (``data/plan_prefetch.py``), on the
                                   host engine, which has none, it
                                   raises out of the run
  * ``FaultPlan.maybe_preempt`` -> ``PreemptionHandler``: the loop ends
                                   the epoch, writes an emergency
                                   checkpoint and returns resumably
  * ``corrupt_checkpoint`` / ``tamper_arrays`` -> ``restore`` refuses
                                   the step, ``restore_latest_intact``
                                   falls back to the previous one
  * ``failing_selection_kernels`` -> ``ResidentSelector``: on the CPU
                                   the round degrades to a soft-random
                                   subset (or raises), on the card it
                                   raises (``core/pgm.py``)

Injectors fire once per ``FaultPlan``: after a watchdog rollback the
replayed epochs run clean, the transient fault model the recovery is
written for.
"""
from __future__ import annotations

import contextlib
import os
import signal
import threading
from typing import Optional, Tuple

import numpy as np

from repro_torch.train import checkpoint as ckpt_mod


class FaultPlan:
    """A schedule of fire-once faults for
    ``train_with_selection(fault_plan=...)``.

    ``nan_step``/``inf_step`` are ``(epoch, step)`` pairs that poison one
    plan-weight row (the weights multiply the per-example loss, so the
    poison reaches the loss and the gradients on the device);
    ``nan_epoch`` poisons every step of one epoch, enough consecutive
    skips to trip the divergence watchdog.  ``drop_step`` turns one plan
    row into padding (ids -1, weight 0).  ``prefetch_fail_epochs`` raises
    from the plan build the first time each listed epoch's plan is
    built.  ``preempt_after_epoch`` raises SIGTERM in the loop's own
    thread once that epoch has run.
    """

    def __init__(self, *, nan_step: Optional[Tuple[int, int]] = None,
                 inf_step: Optional[Tuple[int, int]] = None,
                 nan_epoch: Optional[int] = None,
                 drop_step: Optional[Tuple[int, int]] = None,
                 prefetch_fail_epochs: Tuple[int, ...] = (),
                 preempt_after_epoch: Optional[int] = None):
        self.nan_step = nan_step
        self.inf_step = inf_step
        self.nan_epoch = nan_epoch
        self.drop_step = drop_step
        self.prefetch_fail_epochs = tuple(prefetch_fail_epochs)
        self.preempt_after_epoch = preempt_after_epoch
        self._fired = set()

    def _once(self, tag) -> bool:
        if tag in self._fired:
            return False
        self._fired.add(tag)
        return True

    def poison_plan(self, epoch: int, plan):
        idx, w = plan
        w = np.array(w, np.float32, copy=True)
        if (self.nan_step is not None and self.nan_step[0] == epoch
                and self._once(("nan_step", epoch))):
            w[self.nan_step[1] % w.shape[0]] = np.nan
        if (self.inf_step is not None and self.inf_step[0] == epoch
                and self._once(("inf_step", epoch))):
            w[self.inf_step[1] % w.shape[0]] = np.inf
        if self.nan_epoch == epoch and self._once(("nan_epoch", epoch)):
            w[:] = np.nan
        if (self.drop_step is not None and self.drop_step[0] == epoch
                and self._once(("drop_step", epoch))):
            idx = np.array(idx, np.int32, copy=True)
            row = self.drop_step[1] % w.shape[0]
            idx[row] = -1
            w[row] = 0.0
        return idx, w

    def maybe_fail_prefetch(self, epoch: int) -> None:
        if (epoch in self.prefetch_fail_epochs
                and self._once(("prefetch", epoch))):
            raise RuntimeError(f"injected prefetch failure at epoch "
                               f"{epoch}")

    def maybe_preempt(self, epoch: int) -> None:
        if (self.preempt_after_epoch is not None
                and epoch >= self.preempt_after_epoch
                and self._once("preempt")):
            signal.raise_signal(signal.SIGTERM)


class PreemptionHandler:
    """SIGTERM/SIGINT set a flag; the training loop ends the epoch in
    flight, writes an emergency checkpoint and returns with
    ``History.preempted``.  Installing from a thread other than the main
    one is a no-op (``signal.signal`` works on the main thread only)."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, log_fn=None):
        self._log = log_fn or (lambda s: None)
        self.triggered = False
        self._prev = {}

    def _handle(self, signum, frame):
        self.triggered = True
        self._log(f"received signal {signum}; checkpointing and exiting "
                  f"after the in-flight chunk")

    def install(self) -> "PreemptionHandler":
        if threading.current_thread() is not threading.main_thread():
            return self
        try:
            for s in self.SIGNALS:
                self._prev[s] = signal.signal(s, self._handle)
        except ValueError:      # an interpreter without the signal API
            self._prev.clear()
        return self

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except ValueError:
                pass
        self._prev.clear()


def corrupt_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       n_bytes: int = 64) -> str:
    """Flip ``n_bytes`` in the middle of a checkpoint's ``arrays.npz``:
    the archive then fails at decode (zip CRC) or at an array's sha256.
    Returns the damaged file's path."""
    step = ckpt_mod.latest_step(ckpt_dir) if step is None else step
    path = os.path.join(ckpt_dir, f"step_{step}", "arrays.npz")
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        pos = size // 2
        f.seek(pos)
        chunk = f.read(min(n_bytes, max(size - pos, 1)))
        f.seek(pos)
        f.write(bytes(b ^ 0xFF for b in chunk))
    return path


def tamper_arrays(ckpt_dir: str, step: Optional[int] = None, keys=None):
    """Rewrite ``arrays.npz`` with the values of ``keys`` (default all)
    moved by one, leaving the manifest as it was: a valid archive whose
    contents no longer match their sha256.  Returns the tampered keys."""
    step = ckpt_mod.latest_step(ckpt_dir) if step is None else step
    path = os.path.join(ckpt_dir, f"step_{step}", "arrays.npz")
    with np.load(path) as data:
        arrays = {k: np.array(data[k]) for k in data.files}
    targets = list(keys) if keys is not None else list(arrays)
    for k in targets:
        arrays[k] = arrays[k] + np.ones((), arrays[k].dtype)
    np.savez(path, **arrays)
    return targets


@contextlib.contextmanager
def failing_selection_kernels(routes=("cuda",)):
    """Patch ``repro_torch.core.pgm.units_gradients_batched`` so stage A
    raises on the listed routes: ``"cuda"`` (units on the card, the
    kernel route), ``"plain"`` (units on the CPU), or ``"all"``.
    ``ResidentSelector`` calls the module global at its warm-up and
    capture on the card and at every round on the CPU, so a selector that
    has not captured yet sees the failure (a captured graph makes no
    call)."""
    from repro_torch.core import pgm as pgm_mod
    orig = pgm_mod.units_gradients_batched

    def wrapper(bundle, params, units, *args, **kwargs):
        route = "cuda" if units["tokens"].device.type == "cuda" else "plain"
        if "all" in routes or route in routes:
            raise RuntimeError(f"injected kernel failure ({route!r})")
        return orig(bundle, params, units, *args, **kwargs)

    pgm_mod.units_gradients_batched = wrapper
    try:
        yield
    finally:
        pgm_mod.units_gradients_batched = orig
