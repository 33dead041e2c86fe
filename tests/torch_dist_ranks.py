"""Rank functions of the port's distributed CPU tests, run by
``torch_dist_helpers.spawn`` in every rank of a gloo group.  This module
imports no JAX: each rank imports only PyTorch and the port.  Every
function returns picklable numpy values and plain Python numbers."""
import numpy as np
import torch

from repro_torch.models.common import tree_leaves, tree_map


def np_tree(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def t_tree(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)),
                    tree)


# -- train/compress.py ------------------------------------------------------

def compress_modes(rank, world, grads, errs, k_frac):
    """``compressed_psum`` over the world (the pod group) in each mode on
    this rank's pod's gradients -> {mode: (reduced, new err)}."""
    from repro_torch.train.compress import compressed_psum
    out = {}
    for mode in ("none", "bf16", "topk"):
        red, new = compressed_psum(t_tree(grads[rank]), None, mode,
                                   t_tree(errs[rank]), k_frac)
        out[mode] = (np_tree(red), np_tree(new))
    return out


# -- core/pgm.py: sharded stage B ---------------------------------------------

def stage_b_cases(rank, world, cases):
    """Each case ``(g, g_val, PGMConfig kwargs)`` through ``_stage_b`` on
    a ``(world,)`` data mesh, this rank holding its block of ``g`` where
    the partitions divide (D4) and all of it where they do not ->
    [(indices, weights, n_selected, errors, sharded)]."""
    from repro_torch.configs.base import PGMConfig
    from repro_torch.core.pgm import _sharded_axis, _stage_b, unit_block
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((world,), ("data",), "cpu")
    out = []
    for g, g_val, pc_kw in cases:
        pc = PGMConfig(**pc_kw)
        n = g.shape[0]
        gt = torch.from_numpy(g)
        gv = None if g_val is None else torch.from_numpy(g_val)
        sharded = _sharded_axis(mesh, "data", pc, n)
        if sharded:
            lo, hi = unit_block(mesh, "data", n)
            sel = _stage_b(gt[lo:hi], pc, g_val=gv, mesh=mesh)
        else:
            sel = _stage_b(gt, pc, g_val=gv)
        out.append((sel.indices.numpy(), sel.weights.numpy(),
                    int(sel.n_selected), sel.errors.numpy(), sharded))
    return out


def resident_rounds(rank, world, cases):
    """Each case ``(arch, units, val units or None, params, projections,
    PGMConfig kwargs)`` as one ``ResidentSelector`` round on a
    ``(world,)`` data mesh -> [(indices, weights, n_selected)]."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PGMConfig
    from repro_torch.core.pgm import ResidentSelector
    from repro_torch.core.sketch import Projections
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    mesh = make_mesh((world,), ("data",), "cpu")
    out = []
    for arch, units, val, params, proj, pc_kw in cases:
        sel = ResidentSelector(
            build_model(get_config(arch)), PGMConfig(**pc_kw),
            Projections(*(torch.from_numpy(x) for x in proj)), mesh=mesh,
            on_failure="raise")
        s = sel(t_tree(params), t_tree(units),
                val_units=None if val is None else t_tree(val))
        out.append((s.indices.numpy(), s.weights.numpy(),
                    int(s.n_selected)))
    return out


# -- train/engine.py and train/loop.py on a mesh -----------------------------

def history(h):
    return {"train_loss": list(h.train_loss), "val_loss": list(h.val_loss),
            "lr": list(h.lr), "cost_units": h.cost_units,
            "selections": [{k: s[k] for k in ("epoch", "indices",
                                              "weights")}
                           for s in h.selections]}


def _tc(run, sel, **kw):
    from repro_torch.configs.base import PGMConfig, TrainConfig
    return TrainConfig(**run, pgm=PGMConfig(**sel), **kw)


def train_runs(rank, world, runs, shape, axes):
    """Each run ``(arch, engine, units, val, run kw, selection kw, params,
    projections, train_with_selection kw)`` on one mesh -> [history]."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import train_with_selection
    mesh = make_mesh(shape, axes, "cpu")
    out = []
    for arch, engine, units, val, run, sel, params, proj, kw in runs:
        h = train_with_selection(
            build_model(get_config(arch)), units, _tc(run, sel, **kw.pop(
                "tc", {})), val_units=val, engine=engine, device="cpu",
            params=params, proj=proj, mesh=mesh, **kw)
        out.append(history(h))
    return out


def _snapshot(trees):
    return [t.clone() for t in tree_leaves(trees)]


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def guard_checks(rank, world, arch, units, run, sel, params):
    """On a ``(world,)`` data mesh with the guard on: a padding row
    leaves params and optimizer state bitwise (D5); a NaN weight in the
    last rank's examples gates every rank off the step, bitwise, with
    its skip flagged on every rank; a live step moves the state.  Then
    the ``ValueError`` of an MoE engine on the same units (D7), or
    None."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.train.engine import EpochEngine
    from repro_torch.train.optim import make_update_for
    mesh = make_mesh((world,), ("data",), "cpu")
    tc = _tc(run, sel, nonfinite_guard=True)
    bundle = build_model(get_config(arch))
    eng = EpochEngine(bundle, tc, units, batch_units=1, mesh=mesh)
    p = t_tree(params)
    o = make_update_for(tc)[0](p)
    eng.adopt(p, o)
    before = _snapshot((p, o))
    pad = (np.full((1, 1), -1, np.int32), np.zeros((1, 1), np.float32))
    _, _, losses = eng.run_epoch(p, o, tc.lr, pad)
    pad_held = _same(before, _snapshot((p, o))) and losses.tolist() == [0.0]
    bad = {k: np.array(v, copy=True) for k, v in units.items()}
    bad["weights"][0, -1] = np.nan      # the last example: the last rank's
    eng_bad = EpochEngine(bundle, tc, bad, batch_units=1, mesh=mesh)
    eng_bad.adopt(p, o)
    row = (np.zeros((1, 1), np.int32), np.ones((1, 1), np.float32))
    eng_bad.run_epoch(p, o, tc.lr, row)
    nan_held = _same(before, _snapshot((p, o)))
    skipped = float(eng_bad.last_skipped[0])
    eng.run_epoch(p, o, tc.lr, row)
    moved = not _same(before, _snapshot((p, o)))
    # D7: an MoE batch whose rank share is not a whole number of groups
    try:
        EpochEngine(build_model(get_config("olmoe-1b-7b-smoke")), tc,
                    units, batch_units=1, mesh=mesh)
        d7 = None
    except ValueError as e:
        d7 = str(e)
    return pad_held, nan_held, skipped, moved, d7


def topk_resume(rank, world, units, val, params, proj, root):
    """A top-k run on a 2 x 2 data x pod mesh, uninterrupted (4 epochs)
    and cut after 2 then resumed, each with a checkpoint directory under
    ``root`` -> (the whole run's history, the resumed one's, the whole
    run's last manifest)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.loop import train_with_selection
    mesh = make_mesh((2, 2), ("data", "pod"), "cpu")
    bundle = build_model(get_config("starcoder2-3b-smoke"))
    run = dict(lr=0.5, optimizer="sgd", epochs=4)
    sel = dict(subset_fraction=0.5, n_partitions=2, select_every=2,
               warm_start_epochs=1, sketch_dim_h=16, sketch_dim_v=16)
    kw = dict(method="pgm", val_units=val, engine="scan", device="cpu",
              params=params, proj=proj, mesh=mesh, batch_units=2,
              epoch_chunk=2)
    tc = _tc(run, sel, compress_mode="topk", compress_k_frac=0.1)
    full = train_with_selection(bundle, units, tc, ckpt_dir=f"{root}/full",
                                **kw)
    cut = _tc(dict(run, epochs=2), sel, compress_mode="topk",
              compress_k_frac=0.1)
    train_with_selection(bundle, units, cut, ckpt_dir=f"{root}/cut", **kw)
    logs = []
    res = train_with_selection(bundle, units, tc, ckpt_dir=f"{root}/cut",
                               resume=True, log_fn=logs.append, **kw)
    return (history(full), history(res), ckpt.read_manifest(f"{root}/full"),
            logs)


def _lm_run(world, units, val, params, proj, epochs, **kw):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import train_with_selection
    mesh = None if world == 1 else make_mesh((world,), ("data",), "cpu")
    tc = _tc(dict(lr=0.5, optimizer="sgd", epochs=epochs),
             dict(subset_fraction=0.5, n_partitions=2, select_every=2,
                  warm_start_epochs=1, sketch_dim_h=16, sketch_dim_v=16))
    logs = []
    h = train_with_selection(
        build_model(get_config("starcoder2-3b-smoke")), units, tc,
        method="pgm", val_units=val, engine="scan", device="cpu",
        params=params, proj=proj, mesh=mesh, batch_units=2,
        log_fn=logs.append, **kw)
    return history(h), logs


def reshard_save(rank, world, units, val, params, proj, root):
    """On a ``(world,)`` data mesh: 3 epochs with a checkpoint after each
    under ``root/whole`` -> the history."""
    return _lm_run(world, units, val, params, proj, 3,
                   ckpt_dir=f"{root}/whole")[0]


def reshard_resume(rank, world, units, val, params, proj, ckpt_dir):
    """Resume to 3 epochs from ``ckpt_dir`` on a ``(world,)`` data mesh
    (no mesh at 1) -> (history, log lines)."""
    return _lm_run(world, units, val, params, proj, 3, ckpt_dir=ckpt_dir,
                   resume=True)


def launcher_lines(rank, world, argv, params, proj, units_odd):
    """The launcher's ``main(argv)`` on this group, its training run
    started from ``params``/``proj`` (the reference's draws), rank 0's
    printed lines captured -> (lines, the ValueError message of a batch
    of 3-example units on the 2 x 2 data x pod mesh)."""
    import contextlib
    import io

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import train as launcher
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.train.engine import EpochEngine
    try:
        EpochEngine(build_model(get_config("starcoder2-3b-smoke")),
                    TrainConfig(compress_mode="bf16"), units_odd,
                    batch_units=1,
                    mesh=make_mesh((2, 2), ("data", "pod"), "cpu"))
        odd = None
    except ValueError as e:
        odd = str(e)
    inner = launcher.train_with_selection

    def with_draws(*a, **kw):
        return inner(*a, params=params, proj=proj, **kw)

    launcher.train_with_selection = with_draws
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launcher.main(argv)
    return buf.getvalue().splitlines(), odd
