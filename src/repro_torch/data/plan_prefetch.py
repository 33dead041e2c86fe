"""Host-side plan generation on a worker thread.

A copy of the reference's ``PlanPrefetcher`` (numpy and the standard
library only).  Epoch plans are tiny ``(seed, epoch)``-keyed index and
weight arrays (``data/pipeline.epoch_plan`` / ``subset_epoch_plan``
behind ``EpochEngine.full_plan`` / ``subset_plan``); building them
between epochs puts serial host work on the critical path, so the
prefetcher builds upcoming plans on one worker thread while the current
epoch's replays run on the card.

A plan built here is a host array (or a fresh tensor the builder made):
the worker never writes to an engine's static buffers.  The engine
copies a plan into its buffers on its own stream, ordered before the
replays that read it.

Determinism is free: builders are pure functions of ``(seed, epoch,
selection)``, so a prefetched plan is identical to one built
synchronously, and a resumed run, which starts with an empty buffer,
rebuilds exactly the plans the interrupted run would have used.

Keys are caller-chosen hashables (the training loop uses ``("full",
salt, epoch)`` / ``("subset", salt, selection_round, epoch)``): a new
selection round changes the key, so a superseded plan is never served.
A key that will no longer be fetched still occupies a buffer slot, so
callers that re-key call ``invalidate()`` to drop pending work.

Failures: a transient builder failure is retried in place, ``retries``
attempts with capped exponential backoff, on whichever thread runs the
build (the worker or the ``get()`` fallback).  A builder that keeps
failing re-raises its last exception from ``get()`` (the slot is freed
first, so the caller can retry synchronously); an orphaned failed build
is dropped by ``invalidate()``; ``close()``, also run by ``__del__`` and
the context manager, cancels what has not started, joins the worker and
is idempotent.
"""
from __future__ import annotations

import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, Hashable


class PlanPrefetcher:
    """Single-worker double buffer for plan construction.

    ``schedule(key, build)`` submits ``build`` (no arguments, returns the
    plan) to the worker; at most ``max_pending`` submissions are
    outstanding.  ``get(key, build)`` returns the prefetched result when
    ``key`` was scheduled, else calls ``build`` synchronously; both give
    the same value because builders are pure.  A prefetched build that
    failed re-raises its exception from ``get()``.
    """

    def __init__(self, max_pending: int = 2, retries: int = 2,
                 backoff_s: float = 0.05, max_backoff_s: float = 2.0):
        self.max_pending = int(max_pending)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self._pending: Dict[Hashable, Future] = {}
        self._ex = ThreadPoolExecutor(max_workers=1,
                                      thread_name_prefix="plan-prefetch")
        self._closed = False
        #: get() calls served from the buffer / built synchronously, and
        #: builds recovered by a retry
        self.hits = 0
        self.misses = 0
        self.retried = 0

    def _build_with_retries(self, build: Callable[[], object]):
        """Run ``build``, retrying a failure ``retries`` times with capped
        exponential backoff before letting it propagate."""
        delay = self.backoff_s
        for attempt in range(self.retries + 1):
            try:
                return build()
            except Exception:
                if attempt == self.retries:
                    raise
                self.retried += 1
                time.sleep(delay)
                delay = min(delay * 2, self.max_backoff_s)

    def schedule(self, key: Hashable, build: Callable[[], object]) -> bool:
        """Queue ``build`` for ``key``.  An already-scheduled key reports
        True; False only when closed or the buffer is full."""
        if key in self._pending:
            return True
        if self._closed or len(self._pending) >= self.max_pending:
            return False
        self._pending[key] = self._ex.submit(self._build_with_retries,
                                             build)
        return True

    def get(self, key: Hashable, build: Callable[[], object]):
        """The plan for ``key``: from the buffer when prefetched, else
        built synchronously.  A worker-side exception propagates here
        (its slot freed first)."""
        fut = self._pending.pop(key, None)
        if fut is None:
            self.misses += 1
            return self._build_with_retries(build)
        self.hits += 1
        return fut.result()

    def invalidate(self):
        """Drop every pending entry, cancelling what has not started; a
        dropped entry's result or exception is discarded."""
        for fut in self._pending.values():
            fut.cancel()
        self._pending.clear()

    def close(self):
        """Cancel what has not started, drop pending state and join the
        worker.  Idempotent; also run by ``__del__``."""
        if self._closed:
            return
        self._closed = True
        self.invalidate()
        self._ex.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:       # interpreter teardown: best effort
            pass
