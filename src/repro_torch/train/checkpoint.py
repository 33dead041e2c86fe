"""Fault-tolerant checkpoints of the port, in the reference's on-disk
format (``train/checkpoint.py``), so a checkpoint written by either
package restores into the other.

Layout:  <dir>/step_<n>/
            manifest.json   {step, time, mesh_shape, compress_mode,
                             arrays: {key: shape, dtype, sha256}, extra}
            arrays.npz      flat {key: np.ndarray}
         <dir>/LATEST       the newest step
A save writes ``<dir>/.tmp_<n>`` and moves it into place with
``os.replace``, so a crash mid-write never damages an older checkpoint;
``.tmp_*`` directories left by a crash are pruned by the next save or
restore.  ``AsyncCheckpointer`` copies the tree to the host at submit
(a consistent snapshot) and writes it on a background thread.

A key is the path of a leaf as ``jax.tree_util.keystr`` prints it
(``['params']['conv0']['w']``, ``[0]`` for a sequence index), built here
by :func:`keystr` without JAX, in JAX's flatten order (dict keys
sorted).  Each array carries the sha256 of its C-order bytes.  The port
has no mesh and no pod compressor: ``mesh_shape`` and ``compress_mode``
are written as null.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


def keystr(path: Tuple) -> str:
    """A leaf's key: ``[{key!r}]`` for a dict key, ``[i]`` for a sequence
    index, as ``jax.tree_util.keystr`` writes them."""
    return "".join(f"[{k!r}]" for k in path)


def _flatten(tree, path: Tuple = ()) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs of a tree of dicts, tuples and lists, in JAX's
    flatten order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k],
                                                            path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, t in enumerate(tree) for kv in _flatten(t,
                                                                  path + (i,))]
    return [(keystr(path), tree)]


def _unflatten_like(template, fn: Callable[[str, Any], Any],
                    path: Tuple = ()):
    """``template`` with each leaf replaced by ``fn(key, leaf)``."""
    if isinstance(template, dict):
        return {k: _unflatten_like(v, fn, path + (k,))
                for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten_like(v, fn, path + (i,))
                              for i, v in enumerate(template))
    return fn(keystr(path), template)


def _to_host(leaf) -> np.ndarray:
    """A copy of ``leaf`` on the host (a later in-place write to the leaf
    cannot reach the snapshot)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _prune_tmp_dirs(ckpt_dir: str) -> None:
    """Remove ``.tmp_*`` staging directories left by a crash mid-save."""
    if not os.path.isdir(ckpt_dir):
        return
    for d in os.listdir(ckpt_dir):
        if d.startswith(".tmp_"):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def _save_host(ckpt_dir: str, step: int, flat: Dict[str, np.ndarray],
               extra: Optional[Dict]) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    _prune_tmp_dirs(ckpt_dir)
    tmp = os.path.join(ckpt_dir, f".tmp_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": int(step),
        "time": time.time(),
        "mesh_shape": None,
        "compress_mode": None,
        "arrays": {k: {"shape": list(np.shape(v)),
                       "dtype": str(np.asarray(v).dtype),
                       "sha256": _sha256(v)}
                   for k, v in flat.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)          # an inf prev_loss is "Infinity"
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _update_latest(ckpt_dir, step)


def save(ckpt_dir: str, step: int, tree, extra: Optional[Dict] = None
         ) -> None:
    """Blocking atomic save of a tree of tensors (or numpy arrays)."""
    _save_host(ckpt_dir, step, {k: _to_host(v) for k, v in _flatten(tree)},
               extra)


def _update_latest(ckpt_dir: str, step: int) -> None:
    tmp = os.path.join(ckpt_dir, ".latest_tmp")
    with open(tmp, "w") as f:
        f.write(str(step))
    os.replace(tmp, os.path.join(ckpt_dir, "LATEST"))


def _steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
            if d.startswith("step_")]


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        steps = _steps(ckpt_dir)
        return max(steps) if steps else None
    with open(p) as f:
        return int(f.read().strip())


def read_manifest(ckpt_dir: str, step: Optional[int] = None) -> Dict:
    """A checkpoint's manifest, without loading its arrays."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    with open(os.path.join(ckpt_dir, f"step_{step}", "manifest.json")) as f:
        return json.load(f)


def restore(ckpt_dir: str, step: Optional[int] = None, template=None,
            verify: bool = True):
    """Load a checkpoint -> ``(tree, manifest)``.  Without ``template``
    the tree is the flat ``{key: np.ndarray}``; with one, each leaf of
    the template is replaced by the array of its key as a tensor of the
    template leaf's dtype on its device.  ``verify`` checks every array
    against its sha256 and raises ``IOError`` naming every bad key."""
    _prune_tmp_dirs(ckpt_dir)
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    if verify:
        bad = [k for k, meta in manifest["arrays"].items()
               if k not in arrays or _sha256(arrays[k]) != meta["sha256"]]
        if bad:
            raise IOError(
                f"checkpoint corruption detected in {len(bad)} array(s): "
                + ", ".join(sorted(bad)))
    if template is None:
        return arrays, manifest

    def leaf(key: str, proto):
        t = torch.from_numpy(np.array(arrays[key], copy=True))
        return t.to(device=proto.device, dtype=proto.dtype)

    return _unflatten_like(template, leaf), manifest


def restore_latest_intact(ckpt_dir: str, template=None, verify: bool = True,
                          log_fn=None):
    """Restore the newest checkpoint that passes verification, walking
    the ``step_<n>`` directories newest first; an unusable one is logged
    and skipped.  Raises ``FileNotFoundError`` without checkpoints and
    ``IOError`` when none is intact."""
    _prune_tmp_dirs(ckpt_dir)
    steps = sorted(_steps(ckpt_dir), reverse=True)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    last_err: Optional[BaseException] = None
    for step in steps:
        try:
            return restore(ckpt_dir, step, template=template, verify=verify)
        except Exception as e:   # a sha256 mismatch (IOError), a damaged
            last_err = e         # zip (BadZipFile, zlib.error) or a
            # missing array (KeyError): this step is unusable, try older
            if log_fn is not None:
                log_fn(f"[ckpt] step_{step} unusable ({e}); "
                       f"falling back to previous checkpoint")
    raise IOError(f"no intact checkpoint in {ckpt_dir} "
                  f"(tried steps {steps})") from last_err


class AsyncCheckpointer:
    """Background-thread writer: training blocks only for the copy to the
    host.  A queue of depth 1 applies back-pressure; a write's error is
    raised by the next ``submit`` or ``wait``."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            step, flat, extra = item
            try:
                _save_host(self.ckpt_dir, step, flat, extra)
            except BaseException as e:      # raised on next submit/wait
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, step: int, tree, extra: Optional[Dict] = None) -> None:
        if self._err:
            raise self._err
        self._q.put((step, {k: _to_host(v) for k, v in _flatten(tree)},
                     extra))

    def wait(self) -> None:
        self._q.join()
        if self._err:
            raise self._err

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._thread.join()
