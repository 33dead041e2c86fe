"""Dry run of the port: for one (arch x shape x mesh) cell, build the real
train, prefill, decode or select step at full size under PyTorch's
``FakeTensorMode`` and count it, with no allocation and no card: the
counterpart of the reference's ``repro/launch/dryrun.py``, which lowers
and compiles its steps against shape-only arguments.

Per cell it records, per rank:

  * the op count of one step (``launch/op_analysis.py``: FLOPs, HBM
    bytes, each hand-written kernel by its formula through the wrappers'
    shape-only route, the collective schedule and its wire bytes);
  * the bytes of params, gradients, optimizer state and error-feedback
    state under the port's storage: on a mesh this rank's shards, cut
    by the real ``MeshContext`` (``train/engine.py``, sharded storage;
    a leaf whose dims the axes do not divide stays whole); the decode
    cache; and the activations saved for the backward
    (``torch.autograd.graph.saved_tensors_hooks``, storages counted once,
    params excluded; under group remat only each group's inputs are
    saved), with the count of saved tensors that are a gathered weight
    or a cast or view of one (``saved_gathered``: 0, since each unit
    saves its weights as shards or gathers them inside its checkpoint
    region, hazard S2);
    transient buffers (one unit's gathered weights among them) are not
    counted, so the total is a floor;
  * ``fits``: that floor within one 80 GB card.

Fake tensors hold no values, so what reads values is not run and not
counted: a prefill's check that its positions have the band kernel's
form (``models/attention.py:band_lengths``), and stage B's OMP loop in
the select step (its greedy picks index the next solve; the Gram is
counted).

The mesh is a mapping ``{axis: size}`` (``single``: data 16 x model 16,
``multi``: pod 2 x data 16 x model 16), joined as rank 0 of a fake
process group of that size (``torch.testing``'s ``fake`` backend, which
moves nothing), so the step's real ``MeshContext`` issues its real
collectives.  The batch splits over the spec's batch axes; ranks along
``model`` compute the same examples, as the port does (tensor-parallel
compute is ROADMAP item 16).  Serving steps have no mesh in the port:
each data rank serves its share of the batch.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-27b --shape train_4k
  python -m repro_torch.launch.dryrun --arch rwkv6-3b --shape long_500k \\
      --mesh multi
  python -m repro_torch.launch.dryrun --list

``--device`` is ``cuda`` by default (fake CUDA tensors need a CUDA build
of PyTorch, not a card); ``--device cpu`` counts the same step on fake
CPU tensors, which a CPU-only build allows.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Dict, Mapping, Optional

import torch

from repro_torch.configs import SHAPES, cells, get_config, get_shape
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.launch.roofline import HBM_BYTES, model_flops, \
    step_model_flops
from repro_torch.sharding.fsdp import gathered_node

MESHES = {"none": {}, "single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
SELECT_UNIT = 4            # examples a unit of the select step
SELECT_PARTITIONS = 16     # stage B's partitions (the reference's)
SKETCH_DIM = 64


class Refused(Exception):
    """A cell the port refuses to build (a mesh its step cannot split
    the batch over, hazard D7; a family with no dry-run cell), recorded
    as such."""


def mesh_name(mesh: Mapping[str, int]) -> str:
    if not mesh:
        return "none"
    return "x".join(f"{a}{n}" for a, n in mesh.items())


def train_policy(cfg, shape: ShapeConfig, mesh: Mapping[str, int]) -> str:
    """The reference's spec mode a training cell: MoE and RNN-T keep
    ``tp``; recurrent stacks ``fsdp_batch`` when the batch covers every
    rank, else ``tp``; dense attention ``fsdp_sp`` (its sequence split
    is over ``model``: ``tp`` on a mesh without that axis)."""
    total = math.prod(mesh.values()) if mesh else 1
    if (cfg.moe is not None or cfg.family == "rnnt"
            or (mesh and "model" not in mesh)):
        return "tp"

    if set(cfg.layer_kinds()) & {"rec", "rwkv"}:
        return "fsdp_batch" if shape.global_batch % total == 0 else "tp"
    return "fsdp_sp"


def tree_bytes(tree) -> int:
    from repro_torch.models.common import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class saved_bytes:
    """``with saved_bytes(exclude) as s: ...``: the bytes of every
    storage autograd saves for the backward in the block, each storage
    once, those of ``exclude`` (the params) left out."""

    def __init__(self, exclude=()):
        self.exclude = {_storage_key(t) for t in exclude}
        self.seen: Dict[int, int] = {}
        self.gathered = 0

    def _pack(self, t):
        key = _storage_key(t)
        if key not in self.exclude and key not in self.seen:
            self.seen[key] = t.untyped_storage().nbytes()
        self.gathered += gathered_node(t) is not None
        return t

    def __enter__(self):
        self.hooks = torch.autograd.graph.saved_tensors_hooks(
            self._pack, lambda t: t)
        self.hooks.__enter__()
        return self

    def __exit__(self, *exc):
        self.hooks.__exit__(*exc)

    @property
    def total(self) -> int:
        return sum(self.seen.values())


class _fake_world:
    """Rank 0 of a fake process group of ``n`` ranks (nothing moves),
    and the ``DeviceMesh`` of ``mesh`` over it; nothing without a
    mesh."""

    def __init__(self, mesh: Mapping[str, int], device_type: str):
        self.mesh, self.device_type = dict(mesh), device_type

    def __enter__(self):
        if not self.mesh:
            return None
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore

        from repro_torch.launch.mesh import make_mesh
        if dist.is_initialized():
            raise RuntimeError("the dry run joins a fake process group of "
                               "its own; a group is already initialised")
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=math.prod(self.mesh.values()))
        try:
            return make_mesh(tuple(self.mesh.values()), tuple(self.mesh),
                             self.device_type)
        except BaseException:
            dist.destroy_process_group()
            raise

    def __exit__(self, *exc):
        if self.mesh:
            import torch.distributed as dist
            dist.destroy_process_group()


def _on(batch, device):
    return {k: v.to(device) for k, v in batch.items()}


def build_and_count(arch: str, shape: ShapeConfig, *, step: str,
                    mesh: Mapping[str, int], device: str = "cuda",
                    n_layers: Optional[int] = None, optimizer: str = "adamw",
                    compress_mode: str = "none", fake: bool = True) -> Dict:
    """One step of the cell counted (``fake=False`` runs it on real
    tensors, for holding the fake count against a real one at a small
    size) -> the record's counts and memory."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.op_analysis import count_ops
    from repro_torch.models.api import build_model

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if cfg.family == "rnnt":
        raise Refused(f"{arch}: the dry run's cells are the LM families "
                      f"(configs.cells)")
    bundle = build_model(cfg)
    dev = torch.device(device)
    policy = train_policy(cfg, shape, mesh) if step in ("train", "select") \
        else "tp"
    sizes = dict(mesh)
    batch_axes = ()
    if sizes:
        from repro_torch.sharding.specs import SpecBuilder
        pod = "pod" if "pod" in sizes else None
        batch_axes = SpecBuilder(sizes, mode=policy, pod_axis=pod).batch_axes
    dp = math.prod(sizes[a] for a in batch_axes) * sizes.get("pod", 1) \
        if sizes else 1
    rank_batch = max(shape.global_batch // dp, 1)
    mem = {"params": 0, "grads": 0, "opt_state": 0, "err": 0,
           "activations": 0, "cache": 0}
    rec = {"policy": policy, "batch_axes": list(batch_axes),
           "rank_batch": rank_batch, "omp": None}
    mode = FakeTensorMode() if fake else None
    gen = torch.Generator().manual_seed(0)
    tc = TrainConfig(lr=1e-4, optimizer=optimizer,
                     compress_mode=compress_mode)
    with _fake_world(sizes, dev.type) as dmesh:
        ctx = None
        if dmesh is not None and step == "train":
            from repro_torch.launch.mesh import rank_coords
            from repro_torch.train.engine import MeshContext
            # the mesh's rank tables are real tensors: built before the
            # fake mode
            try:
                ctx = MeshContext(dmesh, tc, bundle, policy,
                                  shape.global_batch, 1, shape.seq_len)
            except ValueError as e:
                raise Refused(str(e)) from e
            rank_coords(dmesh)

        if mode is not None:
            mode.__enter__()
        try:
            if step == "train":
                from repro_torch.train.compress import init_error_state
                from repro_torch.train.engine import make_step_core
                from repro_torch.train.optim import (make_update_for,
                                                     make_update_in_place)
                params = bundle.init_params(gen, dev)
                if ctx is not None:         # this rank's shards
                    params = ctx.shard_tree(params)
                opt = make_update_for(tc)[0](params)
                err = (init_error_state(params) if compress_mode == "topk"
                       else None)
                whole = shape.global_batch if ctx is not None else rank_batch
                batch = _on(bundle.make_batch(gen, whole, shape.seq_len), dev)
                stepf = make_step_core(bundle, tc,
                                       update=make_update_in_place(tc),
                                       ctx=ctx)
                lr = torch.full((), 1e-4, device=dev)
                mem.update(params=tree_bytes(params), grads=tree_bytes(params),
                           opt_state=tree_bytes(opt), err=tree_bytes(err))
                from repro_torch.models.common import tree_leaves
                with count_ops() as c, \
                        saved_bytes(tree_leaves(params)) as saved:
                    stepf(params, opt, batch, lr, err=err)
                mem["activations"] = saved.total
                rec["saved_gathered"] = saved.gathered
            elif step in ("prefill", "decode"):
                params = bundle.init_params(
                    gen, dev, dtype=getattr(torch, cfg.compute_dtype))
                mem["params"] = tree_bytes(params)
                if step == "prefill":
                    batch = _on(bundle.make_batch(gen, rank_batch,
                                                  shape.seq_len), dev)
                    with torch.no_grad(), count_ops() as c:
                        _, cache = bundle.prefill(params, batch)
                else:
                    cache = bundle.init_cache(rank_batch, shape.seq_len,
                                              device=dev)
                    tokens = torch.zeros((rank_batch,), dtype=torch.int32,
                                         device=dev)
                    with torch.no_grad(), count_ops() as c:
                        bundle.decode(params, cache, tokens)
                mem["cache"] = tree_bytes(cache)
            elif step == "select":
                from repro_torch.core.lastlayer import (
                    make_proj_for, units_gradients_batched)
                from repro_torch.kernels.omp_gram.ops import \
                    omp_gram_batched_op
                params = bundle.init_params(gen, dev)
                mem["params"] = tree_bytes(params)
                proj = make_proj_for(bundle, gen, SKETCH_DIM, SKETCH_DIM, dev)
                n_units = max(shape.global_batch // dp, 1)
                one = bundle.make_batch(gen, n_units * SELECT_UNIT,
                                        shape.seq_len)
                units = {k: v.reshape((n_units, SELECT_UNIT) + v.shape[1:])
                         .to(dev) for k, v in one.items()}
                parts = max(SELECT_PARTITIONS // dp, 1)
                with torch.no_grad(), count_ops() as c:
                    g = units_gradients_batched(bundle, params, units, proj)
                    if g.shape[0] % parts == 0:
                        omp_gram_batched_op(g.reshape(parts, -1, g.shape[1]))
                rec["omp"] = ("not counted: OMP's greedy loop reads each pick "
                              "back to the host (data-dependent)")
            else:
                raise ValueError(f"step must be train, prefill, decode or "
                                 f"select; got {step!r}")
        finally:
            if mode is not None:
                mode.__exit__(None, None, None)
    mem["total"] = sum(mem.values())
    counts = c.to_dict()
    rec.update(counts, bytes_accessed=counts.pop("bytes"), memory=mem,
               fits=mem["total"] <= HBM_BYTES)
    rec.pop("bytes", None)
    return rec


def run_cell(arch: str, shape_name: str, *, mesh="single",
             step: Optional[str] = None, device: str = "cuda",
             out_path: Optional[str] = None, verbose: bool = True,
             shape: Optional[ShapeConfig] = None, **kw) -> Dict:
    """One cell -> its record (written to ``out_path`` as JSON).  ``mesh``
    is ``none`` / ``single`` / ``multi`` or a mapping ``{axis: size}``;
    ``shape`` overrides the named shape (a cut of a card run's)."""
    sizes = MESHES[mesh] if isinstance(mesh, str) else dict(mesh)
    shape = shape or get_shape(shape_name)
    step = step or shape.kind
    t0 = time.time()
    rec = {"status": "ok", "arch": arch, "shape": shape.name, "step": step,
           "seq_len": shape.seq_len, "global_batch": shape.global_batch,
           "mesh": mesh_name(sizes), "mesh_shape": sizes,
           "n_devices": math.prod(sizes.values()) if sizes else 1,
           "device": device}
    cfg = get_config(arch)
    if kw.get("n_layers") is not None:
        cfg = dataclasses.replace(cfg, n_layers=kw["n_layers"])
    rec["model_flops"] = (
        model_flops(arch, shape.name, step)
        if shape.name in SHAPES and kw.get("n_layers") is None
        and step == shape.kind
        else step_model_flops(cfg, shape.global_batch, shape.seq_len, step))
    try:
        rec.update(build_and_count(arch, shape, step=step, mesh=sizes,
                                   device=device, **kw))
    except Refused as e:
        rec.update(status="refused", reason=str(e))
    rec["seconds"] = time.time() - t0
    if verbose:
        if rec["status"] == "ok":
            m = rec["memory"]
            print(f"[dryrun] {arch} x {shape.name} x {rec['mesh']} "
                  f"({step}, {rec['policy']}, {rec['rank_batch']} a rank) "
                  f"in {rec['seconds']:.1f} s: {rec['flops']:.4e} FLOP "
                  f"({rec['dot_flops']:.4e} in matmuls, "
                  f"{rec['kernel_flops']:.4e} in kernels), "
                  f"{rec['bytes_accessed']:.4e} B, wire "
                  f"{rec['wire_bytes']:.4e} B; memory a rank "
                  f"{m['total'] / 1e9:.2f} GB (params {m['params'] / 1e9:.2f}"
                  f", grads {m['grads'] / 1e9:.2f}, optimizer "
                  f"{m['opt_state'] / 1e9:.2f}, err {m['err'] / 1e9:.2f}, "
                  f"activations {m['activations'] / 1e9:.2f}, cache "
                  f"{m['cache'] / 1e9:.2f}), fits 80 GB: {rec['fits']}",
                  flush=True)
        else:
            print(f"[dryrun] {arch} x {shape.name} x {rec['mesh']}: "
                  f"refused: {rec['reason']}", flush=True)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--step", default=None,
                    help="train|prefill|decode|select (default: the shape's)")
    ap.add_argument("--mesh", default="single", choices=sorted(MESHES))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "sgd"])
    ap.add_argument("--compress-mode", default="none",
                    choices=["none", "bf16", "topk"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)
    if args.list:
        for arch, shape, status in cells(include_skips=True):
            print(f"{arch:24s} {shape:12s} {status}")
        return 0
    if not args.arch or not args.shape:
        ap.error("--arch and --shape are required (or --list)")
    if args.device == "cuda" and torch.version.cuda is None:
        ap.error("fake CUDA tensors need a CUDA build of PyTorch; pass "
                 "--device cpu to count the step on fake CPU tensors")
    rec = run_cell(args.arch, args.shape, mesh=args.mesh, step=args.step,
                   device=args.device, out_path=args.out,
                   optimizer=args.optimizer,
                   compress_mode=args.compress_mode)
    return 0 if rec["status"] in ("ok", "refused") else 1


if __name__ == "__main__":
    raise SystemExit(main())
