"""Sharded storage on a mesh: per-unit gathers of the weights and
reduce-scattered gradients.

No module of the reference matches this one: its GSPMD partitioner does
the work from each leaf's ``NamedSharding`` (``train/engine.py:
state_shardings``).  Here a rank stores every leaf of params, optimizer
state and error-feedback state as its block under the leaf's spec
(``sharding/specs.py:shard``); a :class:`Layout` is one leaf's storage:
its spec, whole shape, block shape, this rank's block (``mine``) and
the storage group (the ranks that differ only on the axes the spec
names) with each member's block.

Compute runs on whole weights.  A model calls :func:`run_unit` at each
unit boundary (a group of layers, a tail layer, the embedding, the head;
the RNN-T's CNN blocks, LSTM layers, DNN, prediction network and joint;
an encoder or decoder layer).  Inside :func:`gathering` of a tree of
shards a unit gathers its leaves (:class:`GatherShard`,
``all_gather_into_tensor`` over the storage group) just before it runs,
and they are dropped when it returns.  While autograd records, a tensor
the unit saves for the backward that is a gathered weight, or a cast or
view of the whole of one, is saved as its shard and gathered again when
the backward unpacks it (``saved_tensors_hooks``, ROADMAP hazard S2), so
no unit is recomputed; a unit with ``remat`` (the stacks' group remat)
is a checkpoint region that gathers inside, so its recompute gathers
again.  Either way one unit is whole at a time.  Outside
:func:`gathering` every call here is the identity, and a run on one
device is unchanged.

``GatherShard``'s backward reduce-scatters the whole gradient into the
block (``reduce_scatter_tensor``, a sum in the weight's fp32): over the
storage group's data axes the ranks' gradients add, and over an axis
whose ranks compute the same examples (``model``; every axis when the
batch does not split) each rank sends only its own block's part, so
nothing is counted twice.  What is left to the step is where the
replicated step took it: the sum over data axes the spec does not name
and the division by the data ranks (``train/engine.py:MeshContext.
reduce_grads``).  A leaf whose spec names no axis (a dim the axes do not
divide stays whole, hazard S5) is not gathered; its gradient is
all-reduced as before.

Collectives: ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` on
every backend the port runs: NCCL on the card, gloo on the CPU and on
the CUDA tensors of ranks that share a card (hazard S1: ``chip_smoke.py``
phase 23b holds gloo's on the card bitwise against one device).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.sharding.specs import axis_tuple, shard_shape, shard_slices


class Layout:
    """One leaf's storage on a mesh.  ``parts[i]`` is the block (slices
    of the whole leaf) of the storage group's rank ``i``; ``keep[i]``
    whether this rank's gradient counts toward that block (False where
    the member differs from this rank on an axis whose ranks compute
    the same examples); ``rest`` the group of the data axes the spec
    does not name (None: none)."""

    __slots__ = ("spec", "shape", "blk", "mine", "group", "parts", "keep",
                 "rest", "tiled", "_drop")

    def __init__(self, spec, shape, blk, mine, group, parts, keep, rest):
        self.spec, self.shape, self.blk = tuple(spec), tuple(shape), blk
        self.mine = mine
        self.group, self.parts, self.keep, self.rest = group, parts, keep, rest
        # blocks that tile the leaf along dim 0 in the group's order: the
        # gathered buffer is the whole leaf as it lies
        self.tiled = all(
            sl[0] == slice(i * blk[0], (i + 1) * blk[0])
            and all(s == slice(0, n) for s, n in zip(sl[1:], shape[1:]))
            for i, sl in enumerate(parts)) if shape else False
        self._drop: Dict[int, "Layout"] = {}

    def without(self, dim: int) -> "Layout":
        """The layout of one slice of the leaf along ``dim``, a dim the
        spec keeps whole (a stacked leaf's layer axis)."""
        if dim not in self._drop:
            cut = lambda t: t[:dim] + t[dim + 1:]
            self._drop[dim] = Layout(
                cut(self.spec), cut(self.shape), cut(self.blk),
                cut(self.mine), self.group, [cut(p) for p in self.parts],
                self.keep, self.rest)
        return self._drop[dim]


class Store:
    """The layouts of one mesh and batch split, made once a (spec,
    shape).  ``data_axes``: the axes whose ranks compute different
    examples (empty when the batch does not split over them)."""

    def __init__(self, mesh, data_axes: Sequence[str]):
        from repro_torch.launch.mesh import coordinate, mesh_shape
        self.mesh = mesh
        self.sizes = mesh_shape(mesh)
        self.coord = coordinate(mesh)
        self.data_axes = tuple(data_axes)
        self._cache: Dict[Tuple, Optional[Layout]] = {}

    def layout(self, spec, shape) -> Optional[Layout]:
        """The leaf's layout; None when its spec names no axis (whole on
        every rank)."""
        key = (tuple(spec), tuple(int(s) for s in shape))
        if key not in self._cache:
            self._cache[key] = self._make(*key)
        return self._cache[key]

    def _make(self, spec, shape) -> Optional[Layout]:
        from repro_torch.launch.mesh import axes_group, storage_group
        axes = tuple(a for ax in spec for a in axis_tuple(ax))
        if not axes:
            return None
        group, coords = storage_group(self.mesh, axes)
        parts = [shard_slices(spec, shape, self.sizes, c) for c in coords]
        same = [a for a in axes if a not in self.data_axes]
        keep = [all(c[a] == self.coord[a] for a in same) for c in coords]
        rest = [a for a in self.data_axes if a not in axes]
        return Layout(spec, shape, shard_shape(spec, shape, self.sizes),
                      shard_slices(spec, shape, self.sizes, self.coord),
                      group, parts, keep,
                      axes_group(self.mesh, rest) if rest else None)


# -- collectives --------------------------------------------------------------

def gather_block(lay: Layout, block: torch.Tensor) -> torch.Tensor:
    """The whole leaf from every member's block (a collective over the
    storage group)."""
    src = block.contiguous()
    n = len(lay.parts)
    buf = src.new_empty((n * src.numel(),))
    dist.all_gather_into_tensor(buf, src.reshape(-1), group=lay.group)
    buf = buf.view((n,) + lay.blk)
    if lay.tiled:
        return buf.view(lay.shape)
    whole = src.new_empty(lay.shape)
    for i, sl in enumerate(lay.parts):
        whole[sl] = buf[i]
    return whole


def scatter_grad(lay: Layout, g: torch.Tensor) -> torch.Tensor:
    """This rank's block of the storage group's sum of ``g`` (the blocks
    ``keep`` drops sent as zeros)."""
    n = len(lay.parts)
    if lay.tiled and all(lay.keep):
        inp = g.contiguous().reshape(-1)
    else:
        inp = g.new_zeros((n,) + lay.blk)
        for i, sl in enumerate(lay.parts):
            if lay.keep[i]:
                inp[i] = g[sl]
        inp = inp.reshape(-1)
    out = g.new_empty(lay.blk)
    dist.reduce_scatter_tensor(out.view(-1), inp, group=lay.group)
    return out


class _Registry:
    """The shards of one :func:`gathering` block: each registered tensor's
    layout, how many times the forward gathered it (outside the
    backward's recomputes) and the gradients of its gathers still to be
    summed."""

    def __init__(self, pairs):
        self.entries: Dict[int, Tuple[torch.Tensor, Layout]] = {
            id(t): (t, lay) for t, lay in pairs if lay is not None}
        self.uses: Dict[int, int] = {}
        self.pending: Dict[int, list] = {}

    def get(self, t) -> Optional[Layout]:
        hit = self.entries.get(id(t))
        return hit[1] if hit is not None and hit[0] is t else None

    def add(self, t, lay: Layout) -> None:
        self.entries[id(t)] = (t, lay)

    def reduce(self, key: int, lay: Layout, g: torch.Tensor):
        """A gather's whole gradient -> its block's share.  A leaf the
        forward gathered in several units (a tied embedding: the
        embedding and the head) sums its gathers' gradients whole first,
        as one device sums them into the leaf, and reduce-scatters once,
        at its last gather's backward; the others pass zeros."""
        n = self.uses.get(key, 1)
        if n == 1:
            return scatter_grad(lay, g)
        acc = self.pending.get(key)
        acc = [g, 1] if acc is None else [acc[0] + g, acc[1] + 1]
        if acc[1] < n:
            self.pending[key] = acc
            return g.new_zeros(lay.blk)
        self.pending.pop(key, None)
        return scatter_grad(lay, acc[0])


class GatherShard(torch.autograd.Function):
    """block -> the whole leaf; backward: the whole gradient
    reduce-scattered into the block (``_Registry.reduce``)."""

    @staticmethod
    def forward(ctx, block, lay, reg, key):
        # the block itself (a stored shard, alive anyway) to gather again
        # for a saved tensor's unpack (``_SavedAsShards``)
        ctx.lay, ctx.reg, ctx.key, ctx.block = lay, reg, key, block.detach()
        ctx.whole, ctx.packed = {}, 0
        return gather_block(lay, block)

    @staticmethod
    def backward(ctx, g):
        return ctx.reg.reduce(ctx.key, ctx.lay, g), None, None, None


# -- the registry of the shards being computed on -------------------------------

_ACTIVE: List[_Registry] = []


@contextlib.contextmanager
def gathering(pairs):
    """Within the block, the tensors of ``pairs`` (``(shard, layout)``;
    a None layout is a whole leaf) are shards that :func:`run_unit`,
    :func:`gather` and :func:`unbind` gather.  A module-wide registry,
    not a thread's: the autograd engine's device thread recomputes
    checkpointed units inside the block.  A gathered gradient left
    unsummed at the end is an error (a unit's output that the loss did
    not reach)."""
    reg = _Registry(pairs)
    _ACTIVE.append(reg)
    try:
        yield reg
    finally:
        _ACTIVE.remove(reg)
    if reg.pending:
        raise RuntimeError(f"{len(reg.pending)} gathered leaves' gradients "
                           f"were not all summed: a unit gathered them "
                           f"without its output reaching the loss")


def _find(t) -> Tuple[Optional[_Registry], Optional[Layout]]:
    if not _ACTIVE or not isinstance(t, torch.Tensor):
        return None, None
    for reg in reversed(_ACTIVE):
        lay = reg.get(t)
        if lay is not None:
            return reg, lay
    return None, None


def _gather_one(t: torch.Tensor, reg: _Registry, lay: Layout):
    if torch._C._current_graph_task_id() == -1:     # not a recompute
        reg.uses[id(t)] = reg.uses.get(id(t), 0) + 1
    return GatherShard.apply(t, lay, reg, id(t))


def holds(tree) -> bool:
    """Whether any leaf of ``tree`` is a registered shard."""
    return bool(_ACTIVE) and any(_find(l)[1] is not None
                                 for l in tree_leaves(tree))


def gather(tree):
    """``tree`` with each registered shard gathered whole (differentiable,
    :class:`GatherShard`); any other leaf as it is."""
    if not _ACTIVE:
        return tree

    def one(t):
        reg, lay = _find(t)
        return t if lay is None else _gather_one(t, reg, lay)
    return tree_map(one, tree)


def unbind(t: torch.Tensor, dim: int = 0) -> List[torch.Tensor]:
    """``torch.unbind`` of a stacked leaf.  A registered shard whose spec
    keeps ``dim`` whole unbinds into registered shards of the slices'
    layout (each gathered with its unit); one that splits ``dim`` (the
    reference's spec of a small stacked leaf, a norm gamma) is gathered
    whole first."""
    reg, lay = _find(t)
    if lay is None:
        return list(torch.unbind(t, dim))
    if lay.spec[dim] is not None:
        return list(torch.unbind(_gather_one(t, reg, lay), dim))
    parts = list(torch.unbind(t, dim))
    sub = lay.without(dim)
    for p in parts:
        reg.add(p, sub)
    return parts


#: autograd nodes that only cast or view a tensor
_VIEWS = ("ToCopyBackward0", "TBackward0", "ViewBackward0",
          "PermuteBackward0", "TransposeBackward0", "UnsafeViewBackward0")


def gathered_node(t: torch.Tensor):
    """The :class:`GatherShard` node whose output ``t`` is, or is a cast
    or view of; None for any other tensor."""
    fn = t.grad_fn
    while fn is not None:
        if type(fn).__name__ == "GatherShardBackward":
            return fn
        if type(fn).__name__ not in _VIEWS or not fn.next_functions:
            return None
        fn = fn.next_functions[0][0]
    return None


class _SavedAsShards:
    """The saved-tensor hooks of a unit (S2): a tensor that is a gathered
    weight, or a view of it, or a view of a cast of all of it (its
    storage the whole leaf's size), is packed as its node's shard and its
    view (size, stride, offset, dtype), and unpacked from the whole leaf
    gathered again, once for all of the node's saved tensors; the gather
    is dropped when the last is unpacked.  Any other tensor goes to the
    hooks this unit runs inside (a dry run's count, a checkpoint), or is
    kept as it is."""

    def __init__(self):
        top = torch._C._autograd._top_saved_tensors_default_hooks(False)
        self.outer = top
        self.hooks = torch.autograd.graph.saved_tensors_hooks(self.pack,
                                                              self.unpack)

    def pack(self, t):
        node = gathered_node(t)
        if node is not None and (t.untyped_storage().nbytes()
                                 == t.element_size() * math.prod(
                                     node.lay.shape)):
            node.packed += 1
            return (_SHARD, node, t.dtype, t.size(), t.stride(),
                    t.storage_offset())
        return (None, self.outer[0](t)) if self.outer else (None, t)

    def unpack(self, packed):
        if packed[0] is not _SHARD:
            return self.outer[1](packed[1]) if self.outer else packed[1]
        _, node, dtype, size, stride, offset = packed
        whole = node.whole.get(dtype)
        if whole is None:
            with torch.no_grad():
                whole = gather_block(node.lay, node.block).to(dtype)
            node.whole[dtype] = whole
        node.packed -= 1
        if node.packed == 0:
            node.whole = {}
        return whole.as_strided(size, stride, offset)

    def __enter__(self):
        self.hooks.__enter__()
        return self

    def __exit__(self, *exc):
        self.hooks.__exit__(*exc)


_SHARD = object()          # the tag of a tensor packed as its shard


def run_unit(fn, params, *args, remat: bool = False):
    """``fn(params, *args)``, one unit of compute.  With ``params``
    holding shards, their whole leaves are gathered for ``fn``; while
    autograd records, its saved weights are kept as shards
    (:class:`_SavedAsShards`, S2).  ``remat`` makes the unit a checkpoint
    region, on one device too (the stacks' group remat): its weights are
    gathered inside it, so the recompute gathers them again.  No unit
    draws random numbers, so no generator state is stashed (a stash
    would read it inside a CUDA-graph capture) and a recompute is bitwise
    the first forward."""
    sharded = holds(params)
    if remat and torch.is_grad_enabled():
        body = (lambda *a: fn(gather(params), *a)) if sharded else \
            (lambda *a: fn(params, *a))                 # noqa: E731
        return checkpoint(body, *args, use_reentrant=False,
                          preserve_rng_state=False)
    if not sharded:
        return fn(params, *args)
    if not torch.is_grad_enabled():
        return fn(gather(params), *args)
    with _SavedAsShards():
        return fn(gather(params), *args)
