"""Partition specs for params, optimizer state, batches and decode caches
(the reference's ``sharding/specs.py``), without JAX.

A spec is a tuple with one entry a dim: ``None`` (whole), a mesh-axis
name, or a tuple of axis names (the dim split over their product,
first axis major).  A one-axis tuple is written as the name, as JAX's
``PartitionSpec`` normalises it, so a port spec equals
``tuple(reference_spec)``.  The rules are the reference's: FSDP over
the data axes plus tensor parallelism over ``model``, every dim sharded
only where the axis divides it, one mesh axis never sharded twice in a
spec, the pod axis excluded from FSDP, routers replicated in ``expert``
mode, and an expert dim that does not divide in ``expert`` mode a
``ValueError`` naming the arch.

``mesh`` is a ``DeviceMesh`` or a mapping ``{axis: size}`` in axis
order: the rules read axis names and sizes only, so the CPU tests hold
them against the reference on meshes of any size without that many
ranks.  Keys are the leaves' paths as ``jax.tree_util.keystr`` writes
them (``models/common.py:keystr``).

The reference's ``MeshSharder`` only places activations for its
partitioner (``with_sharding_constraint``), and its ``kv_repeat`` does
not change a number; the port computes data-parallel and places nothing
inside the model, so neither has a counterpart here.

Storage (the reference's ``NamedSharding`` layout of a leaf): a rank
stores the block of a leaf that its mesh coordinate picks under the
leaf's spec.  Each dim is split over the product of the axes its entry
names, the first axis major (block ``j = c[a0] * n[a1] + c[a1]`` for
axes ``(a0, a1)``); a ``None`` entry keeps the dim whole.
:func:`shard_shape`, :func:`shard_slices`, :func:`shard` and
:func:`unshard` compute it from a spec, the mesh's ``{axis: size}`` and
a coordinate ``{axis: index}``, on numpy arrays or tensors alike;
:func:`err_spec` is an error-feedback leaf's ``(pod, *param_spec)``.
The engines store params, optimizer state and error-feedback state so
(``train/engine.py:MeshContext``, ``sharding/fsdp.py`` for the gathers);
tensor-parallel compute over ``model`` is ROADMAP item 16.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Mapping, Optional, Tuple

from repro_torch.models.common import map_with_path

Spec = Tuple
Coord = Mapping[str, int]


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh, Mapping):
        return {str(a): int(n) for a, n in mesh.items()}
    return {a: int(n) for a, n in zip(mesh.mesh_dim_names, mesh.mesh.shape)}


def _norm(ax):
    if isinstance(ax, tuple) and len(ax) == 1:
        return ax[0]
    return ax


def _spec(*axes) -> Spec:
    return tuple(_norm(a) for a in axes)


def axis_tuple(ax) -> Tuple[str, ...]:
    """A spec entry as a tuple of axis names (``()`` for ``None``)."""
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


def _entry_size(sizes: Mapping[str, int], ax) -> int:
    return math.prod(int(sizes[a]) for a in axis_tuple(ax))


def _entry_index(sizes: Mapping[str, int], coord: Coord, ax) -> int:
    """The block of a dim that ``coord`` stores (first axis major)."""
    j = 0
    for a in axis_tuple(ax):
        j = j * int(sizes[a]) + int(coord[a])
    return j


def shard_shape(spec: Spec, shape, sizes: Mapping[str, int]
                ) -> Tuple[int, ...]:
    """The shape of every rank's block of a leaf of ``shape``; a dim its
    entry's axes do not divide is a ``ValueError`` (``param_spec`` never
    names such an entry)."""
    shape = tuple(int(s) for s in shape)
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} for a leaf of shape {shape}")
    out = []
    for dim, ax in zip(shape, spec):
        n = _entry_size(sizes, ax)
        if dim % n:
            raise ValueError(f"dim {dim} does not split over {ax!r} "
                             f"(size {n}) in spec {spec}")
        out.append(dim // n)
    return tuple(out)


def shard_slices(spec: Spec, shape, sizes: Mapping[str, int],
                 coord: Coord) -> Tuple[slice, ...]:
    """The slice of the whole leaf that the rank at ``coord`` stores."""
    blk = shard_shape(spec, shape, sizes)
    return tuple(slice(_entry_index(sizes, coord, ax) * b,
                       (_entry_index(sizes, coord, ax) + 1) * b)
                 for b, ax in zip(blk, spec))


def shard(leaf, spec: Spec, sizes: Mapping[str, int], coord: Coord):
    """The rank at ``coord``'s block of ``leaf`` (a numpy array or a
    tensor; a view of it)."""
    return leaf[shard_slices(spec, tuple(leaf.shape), sizes, coord)]


def unshard(shard_of, spec: Spec, shape, sizes: Mapping[str, int]):
    """The whole leaf of ``shape`` from ``shard_of(coord)``, the block of
    every coordinate over the axes ``spec`` names (numpy or torch, as
    the blocks are)."""
    shape = tuple(int(s) for s in shape)
    names = sorted({a for ax in spec for a in axis_tuple(ax)})
    out = None
    for flat in range(math.prod(int(sizes[a]) for a in names)):
        coord, rest = {}, flat
        for a in reversed(names):
            coord[a] = rest % int(sizes[a])
            rest //= int(sizes[a])
        blk = shard_of(coord)
        if out is None:
            if hasattr(blk, "new_empty"):
                out = blk.new_empty(shape)
            else:
                import numpy as np
                out = np.empty(shape, dtype=blk.dtype)
        out[shard_slices(spec, shape, sizes, coord)] = blk
    return out


def err_spec(pod_axis: Optional[str], param_spec: Spec) -> Spec:
    """An error-feedback leaf ``(n_pods, *shape)``: pod-local residuals
    split like the param they track (the reference's ``err_shardings``,
    ``P(pod, *param_fsdp_spec)``)."""
    return (pod_axis,) + tuple(param_spec)


class SpecBuilder:
    """mode:
      'tp'         — FSDP over data axes + tensor parallel over 'model'
                     (MoE experts ride the 'model' axis when divisible)
      'expert'     — like 'tp', but MoE expert weights shard their
                     leading n_experts dim over an ``expert`` mesh axis
                     when the mesh has one, else over the FSDP data
                     axes, and router params stay replicated; an expert
                     dim that does not divide raises ``ValueError``
      'fsdp_sp'    — batch over data axes, sequence over 'model', params
                     fully FSDP
      'fsdp_batch' — batch over all axes, params fully FSDP

    ``pod_axis`` names the slow cross-pod axis, which params and their
    mirrored optimizer and error-feedback states never shard over; an
    ``expert`` axis is never a data axis.  ``arch`` names the config in
    error messages."""

    def __init__(self, mesh, *, fsdp: bool = True, mode: str = "tp",
                 pod_axis: Optional[str] = None,
                 arch: Optional[str] = None):
        self.sizes = mesh_sizes(mesh)
        names = tuple(self.sizes)
        self.axis_names = names
        self.mode = mode
        self.pod_axis = pod_axis
        self.arch = arch
        has_model = "model" in names
        dp = tuple(a for a in names
                   if a not in ("model", "expert") and a != pod_axis)
        self.dp_axes = dp
        self.all_axes = tuple(a for a in names
                              if a != pod_axis and a != "expert")
        self.dp = dp if len(dp) > 1 else (dp[0] if dp else None)
        if mode in ("tp", "expert"):
            self.tp = "model" if has_model else None
            self.fsdp = self.dp if fsdp else None
            self.expert = "expert" if "expert" in names else self.fsdp
        elif mode == "fsdp_sp":
            self.tp = None
            self.fsdp = self.all_axes
            self.seq = "model" if has_model else None
        elif mode == "fsdp_batch":
            self.tp = None
            self.fsdp = self.all_axes
            self.seq = None
        else:
            raise ValueError(mode)

    # -- sizes -----------------------------------------------------------
    def axsize(self, axes) -> int:
        return math.prod(self.sizes[a] for a in axis_tuple(axes))

    def _div(self, dim: int, axes) -> bool:
        return axes is not None and dim % self.axsize(axes) == 0

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """The axes a training batch's examples split over (the data
        axes; every axis but the pod's and the expert's in
        ``fsdp_batch``)."""
        return self.all_axes if self.mode == "fsdp_batch" else self.dp_axes

    # -- parameter rule, dispatched on key path and shape ----------------
    def param_spec(self, path: str, shape: Tuple[int, ...]) -> Spec:
        shape = tuple(int(s) for s in shape)
        nd = len(shape)
        is_moe = ".moe." in path or "'moe'" in path

        def guarded(*axes):
            out = [ax if self._div(dim, ax) else None
                   for dim, ax in zip(shape, axes)]
            seen, final = set(), []
            for ax in out:          # never shard one mesh axis twice
                key = tuple(ax) if isinstance(ax, tuple) else ax
                if ax is not None and key in seen:
                    final.append(None)
                    continue
                if ax is not None:
                    seen.add(key)
                final.append(ax)
            return _spec(*final)

        if nd == 0:
            return ()
        if nd == 1:
            return (None,)
        leaf = re.split(r"[.\[\]']+", path.strip("."))
        name = next((t for t in reversed(leaf) if t and t != "w"), "")
        core = _PARAM_RULES.get(name)
        if is_moe and name in ("w_in", "w_gate"):
            core = ("experts", "fsdp", "tp")        # (E, d, ff)
        if is_moe and name == "w_out":
            core = ("experts", "tp", "fsdp")        # (E, ff, d)
        if is_moe and name == "router" and self.mode == "expert":
            return (None,) * nd
        if "embed" in path and nd >= 2:
            core = (("tp", "fsdp") if self.mode in ("tp", "expert")
                    else ("model", None))
        if "lm_head" in path and nd >= 2:
            core = (("fsdp", "tp") if self.mode in ("tp", "expert")
                    else (None, "model"))
        if core is None:
            core = ("fsdp", "tp") if nd >= 2 else (None,)
        lead = nd - len(core)
        if lead < 0:
            core = core[-nd:]
            lead = 0
        axes = [None] * lead + [self._resolve(c, shape[lead + i])
                                for i, c in enumerate(core)]
        return guarded(*axes)

    def _resolve(self, tag, dim):
        if tag is None:
            return None
        if tag == "fsdp":
            return self.fsdp
        if tag == "tp":
            return self.tp
        if tag == "experts":
            if self.mode == "expert":
                ax = self.expert
                if ax is None or not self._div(dim, ax):
                    raise ValueError(
                        f"arch {self.arch or '<unknown>'}: MoE expert dim "
                        f"{dim} does not divide over expert axis {ax!r} "
                        f"(size {self.axsize(ax)}) in "
                        f"mode='expert' — resize the mesh or drop the "
                        f"expert axis instead of silently half-sharding "
                        f"the expert bank")
                return ax
            return self.tp if self._div(dim, self.tp) else None
        return tag

    def param_specs(self, tree):
        """The tree of specs of a tree of tensors (or of anything with a
        ``shape``), keyed by each leaf's path."""
        return map_with_path(lambda k, l: self.param_spec(k, l.shape), tree)

    # -- batches ---------------------------------------------------------
    def batch_spec(self, name: str, shape: Tuple[int, ...]) -> Spec:
        B = int(shape[0])
        if self.mode == "fsdp_batch":
            ax = self.all_axes if self._div(B, self.all_axes) else (
                self.dp if self._div(B, self.dp) else None)
            return _spec(ax, *([None] * (len(shape) - 1)))
        dp = self.dp if self._div(B, self.dp) else None
        rest = [None] * (len(shape) - 1)
        if (self.mode == "fsdp_sp" and len(shape) >= 2
                and self._div(shape[1], "model")):
            rest[0] = "model"
        return _spec(dp, *rest)

    def batch_specs(self, tree):
        return map_with_path(lambda k, l: self.batch_spec(k, l.shape), tree)

    # -- decode caches ---------------------------------------------------
    def cache_spec(self, path: str, shape: Tuple[int, ...],
                   batch: int) -> Spec:
        """KV caches: batch over dp when divisible, else the sequence dim
        over dp; kv-heads over model when divisible, else head_dim.
        ``shape`` is in the reference's cache layout (leading stack dims
        first)."""
        shape = tuple(int(s) for s in shape)
        nd = len(shape)
        if nd == 0:
            return ()
        leaf = re.split(r"[.\[\]']+", path.strip("."))
        name = next((t for t in reversed(leaf) if t), "")
        try:
            b_idx = shape.index(batch)
        except ValueError:
            b_idx = None
        axes = [None] * nd
        dp_used = False
        if b_idx is not None and self._div(batch, self.dp):
            axes[b_idx] = self.dp
            dp_used = True
        if name in ("k", "v") and nd >= 3:
            kv_dim, hd_dim = shape[-2], shape[-1]
            if self._div(kv_dim, self.tp):
                axes[-2] = self.tp
            elif self._div(hd_dim, self.tp):
                axes[-1] = self.tp
            if not dp_used and self._div(shape[-3], self.dp):
                axes[-3] = self.dp
        elif name in ("ck", "cv") and nd >= 3:
            if self._div(shape[-2], self.tp):
                axes[-2] = self.tp
            elif self._div(shape[-1], self.tp):
                axes[-1] = self.tp
        elif name == "S" and nd >= 3:
            if self._div(shape[-3], self.tp):
                axes[-3] = self.tp
        elif name in ("h", "conv") and nd >= 2:
            if self._div(shape[-1], self.tp):
                axes[-1] = self.tp
        return _spec(*axes)

    def cache_specs(self, tree, batch: int):
        return map_with_path(
            lambda k, l: self.cache_spec(k, l.shape, batch), tree)


# trailing-dim rules per param name: tags resolve via SpecBuilder._resolve
_PARAM_RULES: Dict[str, Tuple] = {
    "wq": ("fsdp", "tp"),
    "wk": ("fsdp", "tp"),
    "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "wg": ("fsdp", "tp"),
    "wr": ("fsdp", "tp"),
    "w_in": ("fsdp", "tp"),
    "w_gate": ("fsdp", "tp"),
    "w_gate_branch": ("fsdp", "tp"),
    "w_out": ("tp", "fsdp"),
    "router": ("fsdp", None),
    "w_enc": ("fsdp", "tp"),
    "w_pred": ("fsdp", "tp"),
    "wa": ("fsdp", "tp"),
    "wx": ("fsdp", "tp"),
    "wh": ("fsdp", "tp"),
    "decay_w1": ("fsdp", None),
    "decay_w2": (None, "tp"),
    "ddlerp_w1": ("fsdp", None),
    "ddlerp_w2": (None, None, "fsdp"),
    "conv_w": (None, "tp"),
    "pred_embed": ("tp", "fsdp"),
}
