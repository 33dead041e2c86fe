"""Meshes of the port on ``torch.distributed`` (the reference's
``launch/mesh.py``).

One process per rank, PyTorch's SPMD idiom: a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group, with the reference's axis names (``data``, ``model``, ``pod``,
``expert``), and a collective goes to the group of the axes it reduces
over (:func:`axes_group`; one axis is ``mesh.get_group(name)``).  The
process group comes first: :func:`init_distributed` reads the ranks
``torchrun`` exports, or takes them from the caller.  Backends: gloo on
the CPU, NCCL on the card.  A mesh on the card takes one card a rank,
so a world larger than the visible cards is refused.

Nothing here touches a device at import.
"""
from __future__ import annotations

import math
import os
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: the reference's production meshes: one pod of 16 x 16 = 256 chips as
#: (data, model), two pods of them as (pod, data, model)
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def init_distributed(device_type: str = "cuda", *, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     store: Optional[dist.Store] = None,
                     allow_shared_card: bool = False,
                     timeout_s: float = 600.0) -> Tuple[int, int]:
    """Join the default process group -> ``(rank, world_size)``.

    Without arguments the ranks and the rendezvous come from
    ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``
    / ``MASTER_PORT``); a caller may pass a ``store`` (a ``FileStore``)
    with ``rank`` and ``world_size``.  On
    the card rank r drives card ``LOCAL_RANK`` (else r), and a world
    larger than the visible cards raises ``ValueError`` unless
    ``allow_shared_card`` (ranks sharing one card over gloo, the only
    way two ranks run on a one-card machine).  A group already joined is
    kept."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        n_cards = torch.cuda.device_count()
        if allow_shared_card:
            backend = "gloo"
        elif world_size > n_cards:
            raise ValueError(
                f"world size {world_size} on 'cuda' needs a card a rank; "
                f"{n_cards} visible")
        local = int(os.environ.get("LOCAL_RANK", str(rank)))
        torch.cuda.set_device(local % max(n_cards, 1))
    dist.init_process_group(backend=backend, rank=rank,
                            world_size=world_size, store=store,
                            timeout=timedelta(seconds=timeout_s))
    return rank, world_size


def check_world(shape: Sequence[int], axes: Sequence[str]) -> None:
    """Raise unless the world (the joined group's, else ``torchrun``'s
    ``WORLD_SIZE``, else 1) has one rank a mesh position, saying how to
    launch."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} "
                         f"differ in length")
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    n = math.prod(shape)
    if n != world:
        spec = "x".join(map(str, shape))
        raise ValueError(
            f"mesh {spec} over {tuple(axes)} needs {n} ranks, the world has "
            f"{world}: launch one process a rank, e.g. torchrun "
            f"--standalone --nproc-per-node {n} -m repro_torch.launch.train "
            f"... --mesh {spec}")


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over axis names ``axes``, on the
    default process group (``init_distributed``), whose world size must
    equal the shape's product (``ValueError`` otherwise, saying how to
    launch)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    check_world(shape, axes)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: 16 x 16 = 256 ranks as (data, model).  Multi-pod: 2 x
    16 x 16 = 512 ranks as (pod, data, model).  Refused (``make_mesh``)
    unless the world has exactly that many ranks."""
    shape, axes = PRODUCTION[bool(multi_pod)]
    return make_mesh(shape, axes, device_type)


def require_mesh(mesh) -> None:
    """Refuse anything but a ``DeviceMesh`` as a mesh."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise ValueError(f"mesh must be a torch.distributed DeviceMesh "
                         f"(launch/mesh.py:make_mesh), got "
                         f"{type(mesh).__name__}")


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` in the mesh's axis order (the checkpoint
    manifest's ``mesh_shape``)."""
    return {a: int(n) for a, n in zip(axis_names(mesh), mesh.mesh.shape)}


def coordinate(mesh) -> Dict[str, int]:
    """This rank's coordinate on every axis."""
    return dict(zip(axis_names(mesh), mesh.get_coordinate()))


def rank_coords(mesh) -> Dict[int, Dict[str, int]]:
    """Every rank's coordinate: ``{rank: {axis: index}}``."""
    names = axis_names(mesh)
    grid = mesh.mesh
    out = {}
    for flat, r in enumerate(grid.reshape(-1).tolist()):
        idx, rest = [], flat
        for n in reversed(grid.shape):
            idx.append(rest % n)
            rest //= n
        out[int(r)] = dict(zip(names, reversed(idx)))
    return out


def axes_group(mesh, axes: Sequence[str]):
    """The process group of the ranks that differ only on ``axes``: the
    axis's own group for one axis, the world for all of them, and for
    another set a group made once (every rank makes every such group, in
    one order, as ``new_group`` asks) and cached on the mesh."""
    axes = tuple(a for a in axis_names(mesh) if a in set(axes))
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if set(axes) == set(axis_names(mesh)):
        return dist.group.WORLD
    cache = mesh.__dict__.setdefault("_repro_axes_groups", {})
    if axes not in cache:
        coords = rank_coords(mesh)
        others = [a for a in axis_names(mesh) if a not in axes]
        parts: Dict[tuple, list] = {}
        for r in sorted(coords):
            parts.setdefault(tuple(coords[r][a] for a in others),
                             []).append(r)
        me = dist.get_rank()
        for key in sorted(parts):
            g = dist.new_group(parts[key])
            if me in parts[key]:
                cache[axes] = g
    return cache[axes]


def all_gather_flat(out: torch.Tensor, inp: torch.Tensor, group=None):
    """``out`` (world * n,) <- every rank's ``inp`` (n,), in rank order
    (``all_gather_single``, or ``all_gather_into_tensor`` where the
    installed torch predates it)."""
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, inp, group=group)
    return out
