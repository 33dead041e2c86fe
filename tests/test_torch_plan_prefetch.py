"""PyTorch port, the plan prefetcher (``repro_torch/data/plan_prefetch.py``,
the port's copy of ``repro/data/plan_prefetch.py``): every case of
``tests/test_plan_prefetch.py`` run against the port's copy (hits and
misses, a worker exception at ``get()``, orphaned failures, ``close()``
joining the worker, retries with backoff on both paths, the bounded
buffer), and ``tests/test_chaos.py``'s prefetch-crash property on the
port's scan engine: a transient plan-build failure is retried in place,
and the run is bit for bit the fault-free one."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import PGMConfig, TrainConfig  # noqa: E402
from repro_torch.data.pipeline import lm_units  # noqa: E402
from repro_torch.data.plan_prefetch import PlanPrefetcher  # noqa: E402
from repro_torch.data.synthetic import make_lm_corpus  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.train import faults  # noqa: E402
from repro_torch.train.loop import train_with_selection  # noqa: E402


def _worker_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("plan-prefetch")]


def test_hit_and_miss_counters():
    with PlanPrefetcher(max_pending=2) as pf:
        assert pf.schedule("a", lambda: 1)
        assert pf.get("a", lambda: -1) == 1           # prefetched
        assert pf.get("b", lambda: 2) == 2            # synchronous fallback
        assert (pf.hits, pf.misses) == (1, 1)


def test_builder_exception_propagates_to_get():
    """A worker-thread failure must surface at the consumer, not strand
    it; the slot is freed so a retry falls back to a synchronous build."""
    with PlanPrefetcher() as pf:
        pf.schedule("k", lambda: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            pf.get("k", lambda: None)
        # slot freed: same key now builds synchronously
        assert pf.get("k", lambda: 42) == 42


def test_orphaned_failed_build_does_not_block_close():
    """A failed build whose key is never fetched (e.g. superseded by a
    selection round) must not wedge invalidate()/close()."""
    pf = PlanPrefetcher()
    pf.schedule("orphan", lambda: 1 / 0)
    time.sleep(0.05)                   # let the worker run (and fail)
    pf.invalidate()
    pf.close()
    assert not _worker_threads()


def test_close_joins_worker_and_is_idempotent():
    pf = PlanPrefetcher()
    pf.schedule("a", lambda: time.sleep(0.02) or "plan")
    pf.close()
    assert not _worker_threads()
    pf.close()                                        # idempotent
    # closed prefetcher degrades to synchronous builds
    assert not pf.schedule("b", lambda: 1)
    assert pf.get("b", lambda: "sync") == "sync"


def test_del_releases_worker():
    pf = PlanPrefetcher()
    pf.schedule("a", lambda: 1)
    pf.__del__()
    assert not _worker_threads()


def _flaky(fail_times, value):
    """Builder failing ``fail_times`` times before succeeding."""
    calls = {"n": 0}

    def build():
        calls["n"] += 1
        if calls["n"] <= fail_times:
            raise RuntimeError(f"transient #{calls['n']}")
        return value
    return build, calls


def test_transient_failure_retried_on_worker_path():
    """A builder that fails then recovers is retried in place on the
    worker thread — the consumer sees only the successful result."""
    with PlanPrefetcher(retries=2, backoff_s=0.001) as pf:
        build, calls = _flaky(2, "plan")
        pf.schedule("k", build)
        assert pf.get("k", lambda: None) == "plan"
        assert calls["n"] == 3
        assert pf.retried == 2


def test_transient_failure_retried_on_miss_path():
    """The synchronous ``get()`` fallback degrades identically: same
    retry policy as the worker path."""
    with PlanPrefetcher(retries=2, backoff_s=0.001) as pf:
        build, calls = _flaky(1, 42)
        assert pf.get("unscheduled", build) == 42
        assert calls["n"] == 2
        assert (pf.retried, pf.misses) == (1, 1)


def test_permanent_failure_still_raises_after_retries():
    """Retries are capped: a deterministic failure propagates to the
    consumer once the budget is exhausted (no infinite retry loop)."""
    with PlanPrefetcher(retries=2, backoff_s=0.001) as pf:
        build, calls = _flaky(99, None)
        pf.schedule("k", build)
        with pytest.raises(RuntimeError, match="transient #3"):
            pf.get("k", lambda: None)
        assert calls["n"] == 3           # retries + 1 attempts, then give up
        assert pf.retried == 2


def test_max_pending_bounds_buffer():
    ev = threading.Event()
    with PlanPrefetcher(max_pending=2) as pf:
        assert pf.schedule("a", ev.wait)
        assert pf.schedule("b", lambda: 2)
        assert pf.schedule("a", lambda: -1)           # idempotent re-key
        assert not pf.schedule("c", lambda: 3)        # buffer full
        ev.set()
    assert not _worker_threads()


def test_prefetch_worker_crash_is_transparent():
    """``tests/test_chaos.py::test_prefetch_worker_crash_is_transparent``
    on the port's scan engine (guard on, chunks of 2): the failures at
    epochs 1 and 3 fire, are retried, and every loss is the clean run's."""
    cfg = get_config("starcoder2-3b-smoke")
    units = lm_units(make_lm_corpus(0, 32, 10, cfg.vocab_size,
                                    hard_fraction=0.4), unit_size=4)
    val = lm_units(make_lm_corpus(7, 8, 10, cfg.vocab_size), unit_size=4)
    tc = TrainConfig(lr=0.5, optimizer="sgd", epochs=6, seed=0,
                     nonfinite_guard=True,
                     pgm=PGMConfig(subset_fraction=0.75, n_partitions=2,
                                   select_every=2, warm_start_epochs=2))

    def run(fault_plan=None):
        return train_with_selection(
            build_model(cfg), units, tc, method="pgm", val_units=val,
            engine="scan", epoch_chunk=2, fault_plan=fault_plan,
            device="cpu")

    h_clean = run()
    fp = faults.FaultPlan(prefetch_fail_epochs=(1, 3))
    h_fault = run(fp)
    assert ("prefetch", 1) in fp._fired and ("prefetch", 3) in fp._fired
    assert h_fault.train_loss == h_clean.train_loss
    assert h_fault.val_loss == h_clean.val_loss
    assert h_fault.skipped_steps == 0
    assert np.isfinite(h_clean.train_loss).all()
    assert not _worker_threads()
