"""Optimizers of the port: SGD(+momentum), AdamW, gradient clipping and
the paper's "newbob" scheduler (the reference's ``train/optim.py``).

Params, grads and optimizer states are nested dicts of tensors; updates
are functional (they return new trees and leave their inputs as they
were), like the reference's, so a parity test can hold the state before
and after one step side by side.  ``make_update_in_place`` commits the
same arithmetic into the existing tensors leaf by leaf, the counterpart
of the reference's donated scan carry.

``lr`` is a Python float or a 0-dim fp32 tensor on the params' device
(what a captured step reads); the two give the same bits for the same
fp32 value, since a Python scalar enters an fp32 op rounded to fp32.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import tree_leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in tree_leaves(tree)))


def tree_all_finite(tree) -> torch.Tensor:
    """0-dim bool tensor: every leaf of ``tree`` is free of NaN/Inf.

    The reference checker of the non-finite guard's semantics.  The step
    itself does not sweep the tree: clipping already computes the global
    norm, and any NaN/Inf leaf poisons that sum of squares, so the guard
    checks ``isfinite(gnorm)``, one scalar."""
    ok = torch.ones((), dtype=torch.bool,
                    device=tree_leaves(tree)[0].device)
    for l in tree_leaves(tree):
        ok = ok & torch.all(torch.isfinite(l))
    return ok


def require_masters(params) -> None:
    """Training updates fp32 master weights: refuse a tree with any other
    floating leaf, such as the serving weights that
    ``LMBundle.serving_params`` or ``init_params(dtype=...)`` make (an
    update of bf16 masters would round every step and give another
    run)."""
    odd = sorted({str(l.dtype) for l in tree_leaves(params)
                  if l.is_floating_point() and l.dtype != torch.float32})
    if odd:
        raise ValueError(
            f"training needs fp32 master weights; these params hold {odd} "
            f"leaves (serving weights in the compute dtype cannot be "
            f"trained)")


def clip_by_global_norm(grads, max_norm: float):
    n = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), n


# SGD (+ momentum) — the paper trains with plain SGD at lr 1-2

def sgd_init(params, momentum: float = 0.0):
    dev = tree_leaves(params)[0].device
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev)}
    if momentum:
        state["mu"] = tree_map(torch.zeros_like, params)
    return state


def sgd_update(params, grads, state, lr, momentum: float = 0.0,
               weight_decay: float = 0.0):
    step = state["step"] + 1
    if weight_decay:
        grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
    if momentum:
        mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
        upd, new_state = mu, {"step": step, "mu": mu}
    else:
        upd, new_state = grads, {"step": step}
    return tree_map(lambda p, u: p - lr * u, params, upd), new_state


# AdamW

def adamw_init(params):
    dev = tree_leaves(params)[0].device
    z = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=dev)
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree_map(z, params), "v": tree_map(z, params)}


def adamw_update(params, grads, state, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay: float = 0.0):
    step = state["step"] + 1
    t = step.to(torch.float32)
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g),
                 state["v"], grads)
    bc1 = 1 - torch.pow(b1, t)
    bc2 = 1 - torch.pow(b2, t)

    def upd(p, m_, v_):
        u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
        if weight_decay:
            u = u + weight_decay * p
        return p - lr * u

    return tree_map(upd, params, m, v), {"step": step, "m": m, "v": v}


def make_optimizer(name: str):
    if name == "sgd":
        return sgd_init, sgd_update
    if name == "adamw":
        return adamw_init, adamw_update
    raise ValueError(name)


def gate_step(step_on: torch.Tensor, new_tree, old_tree):
    """``new_tree`` where ``step_on`` (a 0-dim bool tensor on the trees'
    device) and ``old_tree`` otherwise, leafwise.  A select, not a host
    branch: it reads no value back, so a captured step can replay it,
    and a gated-off step returns the old leaves bit for bit (no parameter
    update, no step tick, no Adam moment decay)."""
    return tree_map(lambda a, b: torch.where(step_on, a, b), new_tree,
                    old_tree)


def make_update_for(cfg):
    """Bind a TrainConfig's optimizer hyper-parameters once:
    ``init(params) -> state``; ``update(params, grads, state, lr[,
    step_on])``.  ``step_on`` (a 0-dim bool tensor) gates the update
    through ``gate_step``; with ``None`` no gating op runs."""
    init, update = make_optimizer(cfg.optimizer)
    kw = {"momentum": cfg.momentum} if cfg.optimizer == "sgd" else {}

    def init_fn(params):
        return init(params, cfg.momentum) if cfg.optimizer == "sgd" \
            else init(params)

    def update_fn(params, grads, state, lr, step_on=None):
        new_p, new_s = update(params, grads, state, lr,
                              weight_decay=cfg.weight_decay, **kw)
        if step_on is None:
            return new_p, new_s
        return (gate_step(step_on, new_p, params),
                gate_step(step_on, new_s, state))

    return init_fn, update_fn


def commit_(dst, new) -> None:
    """Copy every leaf of ``new`` into the matching leaf of ``dst`` (trees
    of one structure), in place: ``dst``'s tensors keep their storage."""
    for d, n in zip(tree_leaves(dst), tree_leaves(new)):
        d.copy_(n)


def make_update_in_place(cfg):
    """``update_(params, grads, state, lr[, step_on]) -> (params,
    state)``: the update of ``make_update_for(cfg)`` written into
    ``params`` and ``state`` in place, which it returns.  Every optimizer here is leafwise, so it runs the
    functional update on one leaf at a time (with that leaf's moments and
    the shared step counter) and commits the result before the next leaf:
    the bits are the functional update's, the tensors keep their
    addresses, and at most one leaf's update exists twice at any moment.
    The step counter is committed last, after every leaf has read it."""
    _, update = make_update_for(cfg)

    def update_(params, grads, state, lr, step_on=None):
        slots = {k: tree_leaves(v) for k, v in state.items() if k != "step"}
        new_step = None
        for i, (p, g) in enumerate(zip(tree_leaves(params),
                                       tree_leaves(grads))):
            sub = {"step": state["step"],
                   **{k: leaves[i] for k, leaves in slots.items()}}
            new_p, new_s = update(p, g, sub, lr, step_on=step_on)
            p.copy_(new_p)
            for k, leaves in slots.items():
                leaves[i].copy_(new_s[k])
            new_step = new_s["step"]
        if new_step is not None:
            state["step"].copy_(new_step)
        return params, state

    return update_


# newbob scheduler (paper: lr 2.0, anneal 0.8 on rel. improvement < 0.0025)

@dataclasses.dataclass
class NewbobState:
    lr: float
    prev_loss: float = float("inf")

    def update(self, val_loss: float, anneal_factor: float = 0.8,
               improvement_threshold: float = 0.0025) -> "NewbobState":
        if self.prev_loss != float("inf"):
            rel = (self.prev_loss - val_loss) / max(abs(self.prev_loss), 1e-9)
            if rel < improvement_threshold:
                return NewbobState(self.lr * anneal_factor, val_loss)
        return NewbobState(self.lr, val_loss)
