"""Per-unit last-layer gradients for PGM stage A (the reference's
``core/lastlayer.py``): the RNN-T family and dense decoder LMs.

For RNN-T the last layer is the joint network's output head.  Its
gradient G = dL/dW_out is exactly the ``dw_out`` of the fused loss's
analytic backward (alpha/beta occupancies contracted against the
streamed joint), so no ``(B,T,U+1,V)`` logits, gradient or
``(B,T,U+1,J)`` activation is ever formed.  Under ``loss_impl="dense"``
the reference takes G from the dense oracle's factors instead (the
joint activations and the logits' gradient by autograd), and so does
the port.  The unit's representation is
G flattened (exact, paper-faithful) or its two-sided sketch R1^T G R2.
The per-unit scaling matches the training loss: per-example NLL over
``max(u_len, 1)``, mean over the unit's examples.

For a decoder LM the last layer is the (tied) LM head.  Its gradient is
``H^T E`` with E = diag(scale) (softmax(H W) - onehot(targets)) over the
unit's tokens, scale = mask / (max(sum mask, 1) * B) (the training loss's
per-example token mean, then the mean over examples).  The sketch
``(H R1)^T (E R2)`` goes through the fused ``grad_sketch`` kernel on the
card and through ``streamed_er2`` on the CPU; neither forms E or G.

For a sparse-expert (MoE) LM with ``PGMConfig.moe_router_term`` the
unit's vector is the head's followed by the per-unit gradient of the
total training loss (task + load-balance aux) with respect to every
``router`` leaf (``moe_router_grads``: one autograd backward through the
stack, where the router's signal flows through the top-k combine weights
and the aux, which the head gradient cannot see), each leaf sketched with
``r_h`` on its d_model axis, flattened and concatenated in the params'
flatten order; the exact variant concatenates the raw gradients.

``units_gradients`` takes the units one at a time (the host rounds'
oracle); ``units_gradients_batched`` takes them a chunk at a time, the
stage A of ``core/pgm.py:ResidentSelector`` (the LM's chunk one
``final_hidden`` call and one kernel launch, the RNN-T's one encoder
pass; a router-term MoE unit one forward and one backward of its own),
with each unit's vector the one it has alone.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.chunking import (chunk_vocab_axis, resolve_vocab_chunk,
                                       vocab_chunk_mask)
from repro_torch.core.rnnt_loss import (rnnt_loss_from_logits,
                                        rnnt_loss_fused)
from repro_torch.core.sketch import (Projections, exact_from_factors,
                                     make_projections, sketch_from_factors)
from repro_torch.models import rnnt as rnnt_mod
from repro_torch.models.common import tree_map
from repro_torch.sharding import fsdp


# ---------------------------------------------------------------------------
# decoder LMs
# ---------------------------------------------------------------------------

def lm_unit_factors(bundle, params, batch):
    """-> (h (N,d) fp32, targets (N,), scale (N,) fp32), N = B*(S-1)."""
    with torch.no_grad():
        h, targets, mask = bundle.final_hidden(params, batch, remat=False)
    B = h.shape[0]
    denom = torch.clamp(mask.sum(dim=-1, keepdim=True), min=1.0)
    scale = (mask / (denom * B)).to(torch.float32)
    d = h.shape[-1]
    return (h.reshape(-1, d).to(torch.float32), targets.reshape(-1),
            scale.reshape(-1))


def streamed_er2(h, w_head, targets, scale, r_v, chunk: int = 8192
                 ) -> torch.Tensor:
    """``E @ R2`` without materializing E, streaming vocab chunks with a
    flash-style online softmax (the accumulator is rescaled as the
    running max moves).  h (N,d) fp32; w_head (d,V); targets (N,);
    scale (N,); r_v (V,k2) -> (N,k2) fp32."""
    N = h.shape[0]
    V = w_head.shape[1]
    k2 = r_v.shape[1]
    chunk = resolve_vocab_chunk(V, chunk)
    w = chunk_vocab_axis(w_head.to(torch.float32), chunk, axis=1)
    rv = chunk_vocab_axis(r_v.to(torch.float32), chunk, axis=0)
    valid = vocab_chunk_mask(V, chunk, h.device)
    m = torch.full((N,), float("-inf"), device=h.device)
    s = torch.zeros((N,), device=h.device)
    acc = torch.zeros((N, k2), device=h.device)
    for wc, rc, vc in zip(w, rv, valid):
        lg = torch.where(vc, h @ wc, float("-inf"))             # (N, chunk)
        m_new = torch.maximum(m, lg.max(dim=-1).values)
        alpha = torch.exp(m - m_new)
        p = torch.exp(lg - m_new[:, None])
        s = s * alpha + p.sum(dim=-1)
        acc = acc * alpha[:, None] + p @ rc
        m = m_new
    er2 = acc / torch.clamp(s, min=1e-30)[:, None]
    er2 = er2 - r_v.to(torch.float32)[targets.long()]
    return er2 * scale[:, None]


def lm_unit_sketch(bundle, params, batch, proj: Projections,
                   kernel_impl: str = "auto",
                   head_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    # ops imports streamed_er2 from here for its CPU path
    from repro_torch.kernels.grad_sketch.ops import grad_sketch_op
    h, targets, scale = lm_unit_factors(bundle, params, batch)
    return grad_sketch_op(h, _head_cols(bundle, params, head_rows),
                          proj.r_h, proj.r_v, targets, scale,
                          impl=kernel_impl).reshape(-1)


def _head_cols(bundle, params, head_rows=None) -> torch.Tensor:
    """The (d, V) head as the kernel reads it, contiguous (V, d) rows: the
    tied embedding already is (no copy); an untied (d, V) head is copied,
    unless the caller holds that copy (``head_rows``)."""
    if head_rows is not None:
        return head_rows.t()
    return bundle.head_weight(params).detach().t().contiguous().t()


def lm_unit_exact(bundle, params, batch) -> torch.Tensor:
    """Paper-faithful: the full flattened LM-head gradient (small models
    only: it forms the (N, V) error)."""
    h, targets, scale = lm_unit_factors(bundle, params, batch)
    w = bundle.head_weight(params).detach().to(torch.float32)
    e = torch.softmax(h @ w, dim=-1)
    e[torch.arange(e.shape[0], device=e.device), targets.long()] -= 1.0
    return exact_from_factors(h, e * scale[:, None])


# ---------------------------------------------------------------------------
# sparse-expert (MoE) router term
# ---------------------------------------------------------------------------

def _router_paths(tree, path=()):
    """Paths to the ``router`` leaves in the params' flatten order (dict
    keys sorted, sequences in order: JAX's ``tree_flatten_with_path``
    order, which the reference's router term follows)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _router_paths(tree[k], path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [p for i, t in enumerate(tree)
                for p in _router_paths(t, path + (i,))]
    return [path] if "router" in path else []


def moe_router_grads(bundle, params, batch):
    """The unit's gradients of its total training loss (task + load-balance
    aux, ``bundle.loss_fn``) with respect to every ``router`` leaf, fp32
    tensors shaped like the leaves (a group's router keeps its layer
    axis), in the params' flatten order.  One autograd backward through
    the stack; no other leaf requires grad, so no other weight's gradient
    is formed.  Params without ``router`` leaves raise ``ValueError``."""
    paths = _router_paths(params)
    if not paths:
        raise ValueError(
            f"{bundle.cfg.name}: moe_router_term set but the params tree "
            f"has no 'router' leaves (family={bundle.cfg.family!r})")
    # a tree of new containers over the same leaves (a mesh's shards stay
    # the tensors its units gather); a router sits in an ``moe`` dict, so
    # it is swapped in place there, whole (``sharding/fsdp.py``)
    live = tree_map(lambda l: l, params)
    routers = []
    for path in paths:
        parent = live
        for k in path[:-1]:
            parent = parent[k]
        leaf = fsdp.gather(parent[path[-1]]).detach()
        r = leaf.to(torch.float32).requires_grad_(True)

        routers.append(r)
        parent[path[-1]] = r.to(leaf.dtype)
    with torch.enable_grad():
        total, _ = bundle.loss_fn(live, batch)
        return list(torch.autograd.grad(total, routers))


def moe_unit_sketch(bundle, params, batch, proj: Projections,
                    kernel_impl: str = "auto",
                    head_rows: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The head's sketch followed by each router gradient projected
    through ``r_h`` on its d_model axis (router leaves are (..., d, E)),
    flattened in C order; only the head block goes through the grad-sketch
    kernel."""
    head = lm_unit_sketch(bundle, params, batch, proj, kernel_impl, head_rows)
    rh = proj.r_h.to(torch.float32)
    parts = [torch.einsum("...de,dk->...ke", g, rh).reshape(-1)
             for g in moe_router_grads(bundle, params, batch)]
    return torch.cat([head] + parts)


def moe_unit_exact(bundle, params, batch) -> torch.Tensor:
    """The flattened head gradient followed by the raw router gradients."""
    head = lm_unit_exact(bundle, params, batch)
    parts = [g.reshape(-1) for g in moe_router_grads(bundle, params, batch)]
    return torch.cat([head] + parts)


# ---------------------------------------------------------------------------
# RNN-T
# ---------------------------------------------------------------------------

def rnnt_joint_grad(bundle, params, batch) -> torch.Tensor:
    """(J, V) joint-head gradient of the unit's training loss: ``dw_out``
    from the fused backward, with the encoder and prediction factors held
    constant."""
    with torch.no_grad():
        ze, zp = rnnt_mod.joint_factors(params, bundle.cfg, batch["feats"],
                                        batch["tokens"])
    return _joint_grad_of_factors(bundle, params, ze, zp, batch)


def _joint_grad_of_factors(bundle, params, ze, zp, batch) -> torch.Tensor:
    """``rnnt_joint_grad`` from the unit's joint factors ze (B,T',J) and
    zp (B,U+1,J): the fused loss's ``dw_out`` sums over its whole batch,
    so ``batch`` (and the factors) hold one unit's B examples."""
    cfg = bundle.cfg
    B = batch["token_lens"].shape[0]
    scale = 1.0 / (torch.clamp(batch["token_lens"].to(torch.float32),
                               min=1.0) * B)
    w_out = bundle.head_weight(params).detach().to(torch.float32)
    w_out.requires_grad_(True)
    with torch.enable_grad():
        per_ex = rnnt_loss_fused(ze, zp, w_out, batch["tokens"],
                                 bundle.t_lens(batch), batch["token_lens"],
                                 vocab_chunk=cfg.rnnt.loss_vocab_chunk)
        (g,) = torch.autograd.grad(torch.sum(per_ex * scale), w_out)
    return g


def rnnt_unit_factors(bundle, params, batch):
    """The dense oracle's factors (``loss_impl="dense"``): the joint
    activations z (N, J) and d(training loss)/d(logits) (N, V) from
    autograd through the materialized lattice, N = B*T'*(U+1)."""
    cfg = bundle.cfg
    with torch.no_grad():
        enc = rnnt_mod.encode(params, cfg, batch["feats"])
        pred = rnnt_mod.predict(params, cfg, batch["tokens"])
        z = rnnt_mod.joint_hidden(params, enc, pred)           # (B,T,U1,J)
        logits = rnnt_mod.joint_logits(params, z).to(torch.float32)
    logits.requires_grad_(True)
    with torch.enable_grad():
        per_ex = rnnt_loss_from_logits(logits, batch["tokens"],
                                       bundle.t_lens(batch),
                                       batch["token_lens"])
        per_ex = per_ex / torch.clamp(
            batch["token_lens"].to(torch.float32), min=1.0)
        (e,) = torch.autograd.grad(per_ex.mean(), logits)
    J = z.shape[-1]
    return z.reshape(-1, J).to(torch.float32), e.reshape(-1, e.shape[-1])


def rnnt_unit_sketch(bundle, params, batch, proj: Projections
                     ) -> torch.Tensor:
    if bundle.cfg.rnnt.loss_impl == "fused":
        g = rnnt_joint_grad(bundle, params, batch)
        return (proj.r_h.t() @ g @ proj.r_v).reshape(-1)
    return sketch_from_factors(*rnnt_unit_factors(bundle, params, batch),
                               proj)


def rnnt_unit_exact(bundle, params, batch) -> torch.Tensor:
    if bundle.cfg.rnnt.loss_impl == "fused":
        return rnnt_joint_grad(bundle, params, batch).reshape(-1)
    return exact_from_factors(*rnnt_unit_factors(bundle, params, batch))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def unit_gradient(bundle, params, batch, proj: Optional[Projections],
                  exact: bool = False, kernel_impl: str = "auto",
                  router_term: bool = False,
                  head_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One selection unit -> gradient representation vector.
    ``kernel_impl`` (``PGMConfig.kernel_impl``) routes the LM sketch;
    ``router_term`` (MoE family only) appends the router term."""
    if bundle.cfg.family == "rnnt":
        return (rnnt_unit_exact(bundle, params, batch) if exact
                else rnnt_unit_sketch(bundle, params, batch, proj))
    if router_term and bundle.cfg.family == "moe":
        return (moe_unit_exact(bundle, params, batch) if exact
                else moe_unit_sketch(bundle, params, batch, proj,
                                     kernel_impl, head_rows))
    return (lm_unit_exact(bundle, params, batch) if exact
            else lm_unit_sketch(bundle, params, batch, proj, kernel_impl,
                                head_rows))


def units_gradients(bundle, params, units, proj: Optional[Projections],
                    exact: bool = False, kernel_impl: str = "auto",
                    router_term: bool = False) -> torch.Tensor:
    """units: dict of tensors with a leading (n_units, ...) axis ->
    (n_units, D) fp32, one unit at a time (peak memory of one unit's
    forward, the paper's partition rationale)."""
    n_units = units["tokens"].shape[0]
    return torch.stack([unit_gradient(bundle, params, _unit(units, i), proj,
                                      exact, kernel_impl, router_term)
                        for i in range(n_units)])


def _chunk_size(U: int, chunk_units: Optional[int]) -> int:
    """Largest chunk size <= the requested one that divides U (by default
    U // 16, at least 1)."""
    cu = min(chunk_units or max(U // 16, 1), U)
    while U % cu:
        cu -= 1
    return cu


def _unit(units, i: int):
    return {k: v[i] for k, v in units.items()}


def _chunks(units, cu: int):
    """The corpus as consecutive chunks of ``cu`` units."""
    U = units["tokens"].shape[0]
    return [{k: v[c:c + cu] for k, v in units.items()}
            for c in range(0, U, cu)]


def _flat(chunk):
    """A chunk's (cu, b, ...) leaves as one batch of cu*b examples."""
    return {k: v.reshape((-1,) + v.shape[2:]) for k, v in chunk.items()}


def _chunk_gradients(bundle, params, chunk, proj, exact, kernel_impl="auto",
                     router_term=False, head_rows=None) -> torch.Tensor:
    """One chunk of units -> (cu, D).  The fused RNN-T path runs the
    encoder and prediction network once over the chunk's cu*b examples,
    then one fused loss and backward per unit on that unit's slice of the
    factors (its ``dw_out`` and its scale over its own b examples); every
    other case takes ``unit_gradient`` unit by unit."""
    cu, b = chunk["tokens"].shape[:2]
    if bundle.cfg.family != "rnnt" or bundle.cfg.rnnt.loss_impl != "fused":
        return torch.stack([unit_gradient(bundle, params, _unit(chunk, i),
                                          proj, exact, kernel_impl,
                                          router_term, head_rows)
                            for i in range(cu)])
    flat = _flat(chunk)
    with torch.no_grad():
        ze, zp = rnnt_mod.joint_factors(params, bundle.cfg, flat["feats"],
                                        flat["tokens"])
    out = []
    for i in range(cu):
        rows = slice(i * b, (i + 1) * b)
        g = _joint_grad_of_factors(bundle, params, ze[rows], zp[rows],
                                   _unit(chunk, i))
        out.append(g.reshape(-1) if exact
                   else (proj.r_h.t() @ g @ proj.r_v).reshape(-1))
    return torch.stack(out)


def units_gradients_scanned(bundle, params, units,
                            proj: Optional[Projections], exact: bool = False,
                            chunk_units: Optional[int] = None,
                            kernel_impl: str = "auto",
                            router_term: bool = False,
                            head_rows: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Batched stage A over chunks of ``chunk_units`` units (the
    reference's scan over chunks with a ``vmap`` within one): the RNN-T
    family, the exact path and the MoE router term (one autograd backward
    a unit).  -> (U, D) fp32, each unit's vector the one
    ``units_gradients`` gives it."""
    cu = _chunk_size(units["tokens"].shape[0], chunk_units)
    return torch.cat([_chunk_gradients(bundle, params, chunk, proj, exact,
                                       kernel_impl, router_term, head_rows)
                      for chunk in _chunks(units, cu)])


def units_gradients_batched(bundle, params, units,
                            proj: Optional[Projections] = None,
                            chunk_units: Optional[int] = None,
                            vocab_chunk: int = 8192,
                            exact: bool = False,
                            head_rows: Optional[torch.Tensor] = None,
                            kernel_impl: str = "auto",
                            router_term: bool = False) -> torch.Tensor:
    """Batched stage A of ``core/pgm.ResidentSelector``: (U, D) fp32.

    RNN-T, the exact path and the MoE router term (``router_term`` on an
    ``moe`` bundle: the flattened examples below cannot express a
    per-unit backward) go through ``units_gradients_scanned``.  A
    decoder LM's units are flattened to examples, ``chunk_units`` units
    (cu*b examples) a ``final_hidden`` call, and each chunk's sketches
    come from one ``grad_sketch_units_op`` call with U = cu.  The scale
    divides by b, the unit's example count, not by the chunk's cu*b, so
    each unit's sketch is the one it has alone.  ``vocab_chunk`` is the
    streaming width of the plain path (the kernel tiles the vocab its
    own way).  The kernel reads the LM head as contiguous (V, d) rows:
    the tied embedding is; an untied (d, V) head is copied once a call
    (671 MB at rwkv6-3b's width), unless the caller passes that copy as
    ``head_rows`` (the selector's graphs, whose body is one chunk, do)."""
    if bundle.cfg.family == "rnnt" or exact or \
            (router_term and bundle.cfg.family == "moe"):
        return units_gradients_scanned(bundle, params, units, proj,
                                       exact=exact, chunk_units=chunk_units,
                                       kernel_impl=kernel_impl,
                                       router_term=router_term,
                                       head_rows=head_rows)
    from repro_torch.kernels.grad_sketch.ops import grad_sketch_units_op
    U, b = units["tokens"].shape[:2]
    cu = _chunk_size(U, chunk_units)
    w = _head_cols(bundle, params, head_rows)
    out = []
    for chunk in _chunks(units, cu):
        with torch.no_grad():
            h, targets, mask = bundle.final_hidden(params, _flat(chunk),
                                                   remat=False)
        n, d = b * h.shape[1], h.shape[-1]
        denom = torch.clamp(mask.sum(dim=-1, keepdim=True), min=1.0)
        scale = (mask / (denom * b)).to(torch.float32)
        out.append(grad_sketch_units_op(
            h.to(torch.float32).reshape(cu, n, d).contiguous(), w,
            proj.r_h, proj.r_v, targets.reshape(cu, n),
            scale.reshape(cu, n).contiguous(),
            vocab_chunk=vocab_chunk, impl=kernel_impl).reshape(cu, -1))
    return torch.cat(out)


def make_proj_for(bundle, gen: torch.Generator, k1: int = 64, k2: int = 64,
                  device: torch.device = torch.device("cpu")) -> Projections:
    """Sketch projections over the family's last layer: (joint_dim, k1)
    and (rnnt vocab, k2) for RNN-T, (d_model, k1) and (vocab, k2) for an
    LM."""
    cfg = bundle.cfg
    if cfg.family == "rnnt":
        return make_projections(gen, cfg.rnnt.joint_dim, cfg.rnnt.vocab_size,
                                k1, k2, device)
    return make_projections(gen, cfg.d_model, cfg.vocab_size, k1, k2, device)
