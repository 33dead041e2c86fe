"""Multi-rank runs of the port's distributed tests on the CPU (gloo).

``spawn(fn, world, tmp_path, *args)`` starts ``world`` processes (the
``spawn`` start method), joins them to one gloo group through a
``FileStore`` under ``tmp_path`` (never a fixed port: several pytest
workers run at once), calls ``fn(rank, world, *args)`` in each, and
returns the ranks' results in rank order (ROADMAP hazard D8).  ``fn``
must be importable by the child (a module-level function of
``tests/torch_dist_ranks.py``, which imports no JAX).  Each rank imports
``tests/torch_threads.py`` (one intra-op thread).  The join has a
timeout: a hung rendezvous or collective fails the test that started
it, and the ranks are killed.
"""
import os
import pickle
import sys
import traceback

import torch.multiprocessing as mp

TIMEOUT_S = 240


def _child(fn, rank, world, store_path, out_dir, args):
    try:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import torch_threads  # noqa: F401  (one intra-op thread)
        import torch.distributed as dist

        from repro_torch.launch.mesh import init_distributed
        init_distributed("cpu", rank=rank, world_size=world,
                         store=dist.FileStore(store_path, world),
                         timeout_s=TIMEOUT_S)
        out = fn(rank, world, *args)
        if dist.is_initialized():
            dist.destroy_process_group()
        res = ("ok", out)
    except BaseException:                       # reported by the parent
        res = ("error", traceback.format_exc())
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def spawn(fn, world: int, tmp_path, *args, timeout: float = TIMEOUT_S):
    ctx = mp.get_context("spawn")
    d = tmp_path / f"spawn_{fn.__name__}_{world}_{os.urandom(4).hex()}"
    d.mkdir()
    store = str(d / "store")
    procs = [ctx.Process(target=_child,
                         args=(fn, r, world, store, str(d), args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    if hung:
        raise AssertionError(f"{fn.__name__}: ranks {hung} of {world} "
                             f"still running after {timeout} s")
    out = []
    for r in range(world):
        path = d / f"rank{r}.pkl"
        if not path.exists():
            raise AssertionError(f"{fn.__name__}: rank {r} wrote no result "
                                 f"(exit code {procs[r].exitcode})")
        status, val = pickle.loads(path.read_bytes())
        if status != "ok":
            raise AssertionError(f"{fn.__name__}: rank {r} failed:\n{val}")
        out.append(val)
    return out
