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
by ``models/common.py:keystr`` without JAX, in JAX's flatten order (dict keys
sorted).  Each array carries the sha256 of its C-order bytes.
``mesh_shape`` is the run's ``{axis: size}`` (null on one device) and
``compress_mode`` the pod axis's gradient compressor (null without a pod
axis).  Arrays are stored whole: on a mesh rank 0 alone writes (params
and optimizer state are whole on every rank; the per-pod error-feedback
state is gathered under ``err`` as ``(n_pods, *shape)``), so a restore
onto any mesh takes its pod's row (``train/engine.py:restore_sharding``).
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.common import flatten_with_path as _flatten
from repro_torch.models.common import keystr, map_with_path  # noqa: F401


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
               extra: Optional[Dict], mesh_shape: Optional[Dict] = None,
               compress_mode: Optional[str] = None) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    _prune_tmp_dirs(ckpt_dir)
    tmp = os.path.join(ckpt_dir, f".tmp_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": int(step),
        "time": time.time(),
        "mesh_shape": mesh_shape,
        "compress_mode": compress_mode,
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


def save(ckpt_dir: str, step: int, tree, extra: Optional[Dict] = None,
         mesh_shape: Optional[Dict[str, int]] = None,
         compress_mode: Optional[str] = None) -> None:
    """Blocking atomic save of a tree of tensors (or numpy arrays)."""
    _save_host(ckpt_dir, step, {k: _to_host(v) for k, v in _flatten(tree)},
               extra, mesh_shape, compress_mode)


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
            verify: bool = True, template_fn=None, sharding_fn=None):
    """Load a checkpoint -> ``(tree, manifest)``.  Without ``template``
    the tree is the flat ``{key: np.ndarray}``; with one, each leaf of
    the template is replaced by the array of its key as a tensor of the
    template leaf's dtype on its device.  ``template_fn(manifest)``
    builds the template from the manifest instead (a tree that holds
    ``err`` only when the checkpoint does); ``sharding_fn(key, array)``
    maps each whole array to this rank's part of it before it becomes a
    tensor (a restore onto a mesh).  ``verify`` checks every array
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
    if template_fn is not None:
        template = template_fn(manifest)
    if template is None:
        return arrays, manifest

    def leaf(key: str, proto):
        a = arrays[key]
        if sharding_fn is not None:
            a = sharding_fn(key, a)
        t = torch.from_numpy(np.array(a, copy=True))
        return t.to(device=proto.device, dtype=proto.dtype)

    return map_with_path(leaf, template), manifest


def restore_latest_intact(ckpt_dir: str, template=None, verify: bool = True,
                          log_fn=None, template_fn=None, sharding_fn=None):
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
            return restore(ckpt_dir, step, template=template, verify=verify,
                           template_fn=template_fn, sharding_fn=sharding_fn)
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
            step, flat, extra, meta = item
            try:
                _save_host(self.ckpt_dir, step, flat, extra, **meta)
            except BaseException as e:      # raised on next submit/wait
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, step: int, tree, extra: Optional[Dict] = None,
               mesh_shape: Optional[Dict[str, int]] = None,
               compress_mode: Optional[str] = None) -> None:
        if self._err:
            raise self._err
        self._q.put((step, {k: _to_host(v) for k, v in _flatten(tree)},
                     extra, {"mesh_shape": mesh_shape,
                             "compress_mode": compress_mode}))

    def wait(self) -> None:
        self._q.join()
        if self._err:
            raise self._err

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._thread.join()
