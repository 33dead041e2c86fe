"""Rank functions of the port's sharded-storage tests
(``tests/test_torch_fsdp_*.py``), run by ``torch_dist_helpers.spawn`` in
every rank of a gloo group, and the one-device control they are held
to.  This module imports no JAX.  Every function returns picklable
numpy values and plain Python numbers."""
import numpy as np
import torch

from repro_torch.models.common import (flatten_with_path, tree_leaves,
                                       tree_unflatten)
from torch_dist_ranks import np_tree, t_tree


def _run_kw(run):
    from repro_torch.configs.base import TrainConfig
    return TrainConfig(**run)


def _rows(units, n_rows):
    """The first ``n_rows`` rows of epoch 0's full plan, one unit a row."""
    from repro_torch.data.pipeline import epoch_plan
    n_units = int(np.asarray(units["tokens"]).shape[0])
    idx = epoch_plan(n_units, 0, 0, 1)[:n_rows]
    return idx, np.ones(idx.shape, np.float32)


def halves_steps(arch, run, units, params, n_rows, world=2):
    """One device, the control of the sharded steps: each row of
    ``_rows`` taken in ``world`` equal parts of its examples as the data
    ranks take them, each part's weighted mean loss scaled by its weight
    sum over the parts' mean (D1), the parts' gradients added in part
    order and divided by ``world``, as the ranks' reduce-scatter and mean
    do, then clipped and applied -> (each row's loss, params, optimizer
    state) as numpy trees."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.train.optim import clip_by_global_norm, make_update_for
    bundle = build_model(get_config(arch))
    tc = _run_kw(run)
    init, update = make_update_for(tc)
    p = t_tree(params)
    o = init(p)
    host = {k: np.asarray(v) for k, v in units.items()}
    unit_size = int(host["tokens"].shape[1])
    losses = []
    for sel, wr in zip(*_rows(units, n_rows)):
        batch = {k: torch.from_numpy(np.array(
            v[sel].reshape((-1,) + v.shape[2:]), copy=True))
            for k, v in host.items()}
        batch["weights"] = batch["weights"] * torch.from_numpy(
            np.repeat(wr, unit_size))
        n = int(batch["tokens"].shape[0]) // world
        parts = [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                 for i in range(world)]
        ws = [torch.sum(q["weights"].to(torch.float32)).reshape(1)
              for q in parts]
        w_sum = ws[0]
        for w in ws[1:]:
            w_sum = w_sum + w
        live = [x.detach().requires_grad_(True) for x in tree_leaves(p)]
        grads, scaled = None, None
        for q, w_r in zip(parts, ws):
            s = (w_r / torch.clamp(w_sum / world, min=1e-9)).reshape(())
            with torch.enable_grad():
                _, m = bundle.loss_fn(tree_unflatten(p, live), q)
                g = torch.autograd.grad(m["loss"] * s + m["aux_loss"], live)
            grads = list(g) if grads is None else \
                [a + b for a, b in zip(grads, g)]
            part = (m["loss"].detach() * s).to(torch.float32)
            scaled = part if scaled is None else scaled + part
        with torch.no_grad():
            grads, _ = clip_by_global_norm(
                tree_unflatten(p, [x / world for x in grads]), tc.grad_clip)
            p, o = update(p, grads, o, tc.lr)
        losses.append(float(scaled / world))
    return losses, np_tree(p), np_tree(o)


def sharded_steps(rank, world, cases, shape=None, axes=("data",)):
    """Each case ``(arch, engine, run kw, units, params, n_rows)`` on a
    mesh (``(world,)`` data by default): a fresh engine from the whole
    ``params``, ``_rows`` run as one epoch -> [(each row's loss, the
    whole params and optimizer state gathered back, this rank's stored
    shards of params and optimizer state by path, the engine's
    coordinate)]."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import coordinate, make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.train.engine import make_engine
    from repro_torch.train.optim import make_update_for
    mesh = make_mesh(shape or (world,), axes, "cpu")
    out = []
    for arch, engine, run, units, params, n_rows in cases:
        tc = _run_kw(run)
        eng = make_engine(engine, build_model(get_config(arch)), tc, units,
                          mesh=mesh)
        p = eng.shard_state(t_tree(params))
        o = make_update_for(tc)[0](p)
        if engine == "scan":
            eng.adopt(p, o)
        p, o, losses = eng.run_epoch(p, o, tc.lr, _rows(units, n_rows))
        stored = {("params" + k): v.detach().numpy().copy()
                  for k, v in flatten_with_path(p)}
        stored.update({("opt" + k): v.detach().numpy().copy()
                       for k, v in flatten_with_path(o)})
        out.append(([float(x) for x in losses], np_tree(eng.whole_state(p)),
                    np_tree(eng.whole_state(o)), stored, coordinate(mesh)))
    return out


def stage_a(rank, world, cases):
    """Each case ``(arch, units, params, projections)`` on a ``(world,)``
    data mesh: stage A (``units_gradients_batched``) on the engine's
    shards of ``params``, gathered unit by unit -> [(U, D) numpy]."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.lastlayer import units_gradients_batched
    from repro_torch.core.sketch import Projections
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.train.engine import HostEngine
    mesh = make_mesh((world,), ("data",), "cpu")
    out = []
    for arch, units, params, proj in cases:
        bundle = build_model(get_config(arch))
        eng = HostEngine(bundle, TrainConfig(), units, mesh=mesh)
        p = eng.shard_state(t_tree(params))
        with torch.no_grad(), eng.gathering(p):
            g = units_gradients_batched(
                bundle, p, eng.units,
                Projections(*(torch.from_numpy(x) for x in proj)))
        out.append(g.numpy())
    return out


def checkpoint_save(rank, world, arch, run, units, params, n_rows, root):
    """``sharded_steps``' host-engine steps on a ``(world,)`` data mesh,
    then a checkpoint of params and optimizer state written as the
    training loop writes one (each leaf gathered whole, rank 0 writes)
    -> the whole state saved (numpy)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.engine import HostEngine
    from repro_torch.train.optim import make_update_for
    tc = _run_kw(run)
    eng = HostEngine(build_model(get_config(arch)), tc, units,
                     mesh=make_mesh((world,), ("data",), "cpu"))
    p = eng.shard_state(t_tree(params))
    p, o, _ = eng.run_epoch(p, make_update_for(tc)[0](p), tc.lr,
                            _rows(units, n_rows))
    tree = eng.whole_state({"params": p, "opt": o}, to_host=True)
    if eng.is_writer:
        ckpt.save(root, 1, tree, mesh_shape=eng.mesh_shape)
    eng.barrier()
    return np_tree(tree)


def checkpoint_restore(rank, world, arch, run, units, params, ckpt_dir):
    """A checkpoint restored onto a ``(world,)`` data mesh through the
    engine's ``restore_sharding`` -> (the restored state gathered whole,
    this rank's stored blocks by path, its coordinate)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import coordinate, make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.engine import HostEngine
    from repro_torch.train.optim import make_update_for
    tc = _run_kw(run)
    mesh = make_mesh((world,), ("data",), "cpu")
    eng = HostEngine(build_model(get_config(arch)), tc, units, mesh=mesh)
    p = eng.shard_state(t_tree(params))
    tmpl = {"params": p, "opt": make_update_for(tc)[0](p)}
    got, _ = ckpt.restore(ckpt_dir, template=tmpl,
                          sharding_fn=eng.restore_sharding)
    stored = {k: v.numpy().copy() for k, v in flatten_with_path(got)}
    return np_tree(eng.whole_state(got)), stored, coordinate(mesh)


def topk_cases(rank, world, cases):
    """Each case ``(g, err, spec, k_frac)`` (whole numpy leaves) on a
    ``(world,)`` data mesh: this rank's blocks through ``topk_compress``
    with the leaf's layout -> [(sent, new_err)] gathered whole."""
    from repro_torch.launch.mesh import coordinate, make_mesh, mesh_shape
    from repro_torch.sharding.fsdp import Store, gather_block
    from repro_torch.sharding.specs import shard
    from repro_torch.train.compress import topk_compress
    mesh = make_mesh((world,), ("data",), "cpu")
    store = Store(mesh, ("data",))
    sizes, coord = mesh_shape(mesh), coordinate(mesh)
    out = []
    for g, e, spec, k_frac in cases:
        lay = store.layout(spec, g.shape)
        blk = lambda a: torch.from_numpy(  # noqa: E731
            np.array(shard(a, spec, sizes, coord), copy=True))
        sent, new = topk_compress({"g": blk(g)}, {"g": blk(e)}, k_frac,
                                  [lay])
        out.append((gather_block(lay, sent["g"]).numpy(),
                    gather_block(lay, new["g"]).numpy()))
    return out


def two_rank_body(rank, world, steps, a_cases, ck_case, topk):
    """``tests/test_torch_fsdp_steps.py``'s 2-rank cases in one group:
    ``sharded_steps``, ``stage_a``, ``checkpoint_save(*ck_case)``,
    ``topk_cases``."""
    return (sharded_steps(rank, world, steps),
            stage_a(rank, world, a_cases),
            checkpoint_save(rank, world, *ck_case),
            topk_cases(rank, world, topk))


def four_rank_body(rank, world, runs, ck_case, topk, steps):
    """The 4-rank cases in one group: ``torch_dist_ranks.train_runs`` on
    a (4,) data mesh, ``checkpoint_restore(*ck_case)``, ``topk_cases``,
    and ``sharded_steps`` of ``steps`` on a 2 x 2 data x model mesh."""
    from torch_dist_ranks import train_runs
    return (train_runs(rank, world, runs, (4,), ("data",)),
            checkpoint_restore(rank, world, *ck_case),
            topk_cases(rank, world, topk),
            sharded_steps(rank, world, steps, (2, 2), ("data", "model")))

