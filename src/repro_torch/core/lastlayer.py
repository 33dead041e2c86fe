"""Per-unit last-layer gradients for PGM stage A, RNN-T family (the
reference's ``core/lastlayer.py``).

For RNN-T the last layer is the joint network's output head.  Its
gradient G = dL/dW_out is exactly the ``dw_out`` of the fused loss's
analytic backward (alpha/beta occupancies contracted against the
streamed joint), so no ``(B,T,U+1,V)`` logits, gradient or
``(B,T,U+1,J)`` activation is ever formed.  The unit's representation is
G flattened (exact, paper-faithful) or its two-sided sketch R1^T G R2.
The per-unit scaling matches the training loss: per-example NLL over
``max(u_len, 1)``, mean over the unit's examples.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.rnnt_loss import rnnt_loss_fused
from repro_torch.core.sketch import Projections, make_projections
from repro_torch.models import rnnt as rnnt_mod


def rnnt_joint_grad(bundle, params, batch) -> torch.Tensor:
    """(J, V) joint-head gradient of the unit's training loss: ``dw_out``
    from the fused backward, with the encoder and prediction factors held
    constant."""
    cfg = bundle.cfg
    with torch.no_grad():
        ze, zp = rnnt_mod.joint_factors(params, cfg, batch["feats"],
                                        batch["tokens"])
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


def rnnt_unit_sketch(bundle, params, batch, proj: Projections
                     ) -> torch.Tensor:
    g = rnnt_joint_grad(bundle, params, batch)
    return (proj.r_h.t() @ g @ proj.r_v).reshape(-1)


def rnnt_unit_exact(bundle, params, batch) -> torch.Tensor:
    return rnnt_joint_grad(bundle, params, batch).reshape(-1)


def unit_gradient(bundle, params, batch, proj: Optional[Projections],
                  exact: bool = False) -> torch.Tensor:
    """One selection unit -> gradient representation vector."""
    return (rnnt_unit_exact(bundle, params, batch) if exact
            else rnnt_unit_sketch(bundle, params, batch, proj))


def units_gradients(bundle, params, units, proj: Optional[Projections],
                    exact: bool = False) -> torch.Tensor:
    """units: dict of tensors with a leading (n_units, ...) axis ->
    (n_units, D) fp32, one unit at a time (peak memory of one unit's
    forward, the paper's partition rationale)."""
    n_units = units["tokens"].shape[0]
    return torch.stack([
        unit_gradient(bundle, params, {k: v[i] for k, v in units.items()},
                      proj, exact)
        for i in range(n_units)])


def make_proj_for(bundle, gen: torch.Generator, k1: int = 64, k2: int = 64,
                  device: torch.device = torch.device("cpu")) -> Projections:
    r = bundle.cfg.rnnt
    return make_projections(gen, r.joint_dim, r.vocab_size, k1, k2, device)
