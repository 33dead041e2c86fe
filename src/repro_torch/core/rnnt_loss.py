"""RNN-Transducer loss (Graves 2012) in PyTorch — dense oracle and fused path.

The port of the reference's ``core/rnnt_loss.py``.  The forward
algorithm runs over the (T, U+1) lattice in log space; the within-row
dependency is a first-order recurrence in the log semiring, combined as
(c1, b1).(c2, b2) = (c1+c2, logaddexp(b1+c2, b2)).

* ``rnnt_loss`` / ``rnnt_loss_from_logits`` — the **dense oracle**: takes
  the materialized ``(B, T, U+1, V)`` log-softmaxed joint and
  differentiates the lattice with autograd.  The opt-in
  ``loss_impl="dense"`` path of ``models/api.py``; no kernel runs in it.
* ``rnnt_loss_fused`` — the training path: a ``torch.autograd.Function``
  over the joint *factors* ``(ze, zp, w_out)``.  The forward streams the
  joint row by row over T and over vocab chunks with an online logsumexp
  (``_row_scores``), keeping only ``O(B·T·U)`` lattice scalars; the
  backward runs the beta lattice on (t, u)-flipped rows and contracts
  the closed-form ``d loss / d logits`` (occupancies minus the softmax
  correction) on the fly into ``(dze, dzp, dw_out)``.  No
  ``(B, T, U+1, V)`` tensor exists in either direction.

The alpha and beta lattices go through ``kernels/rnnt_lattice``: the
Hopper kernel for tensors on the card, its plain version on the CPU.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.chunking import resolve_vocab_chunk, vocab_chunks
from repro_torch.kernels.rnnt_lattice.ops import rnnt_lattice_op
from repro_torch.kernels.rnnt_lattice.ref import NEG, row_update


# ---------------------------------------------------------------------------
# Dense oracle
# ---------------------------------------------------------------------------

def rnnt_loss(log_probs: torch.Tensor, labels: torch.Tensor,
              t_lens: torch.Tensor, u_lens: torch.Tensor,
              blank: int = 0) -> torch.Tensor:
    """Per-example NLL (B,) from log-softmaxed joint outputs
    (B, T, U+1, V); differentiable by autograd."""
    B, T, U1, V = log_probs.shape
    lp = log_probs.to(torch.float32)
    dev = lp.device
    t_lens = t_lens.to(device=dev, dtype=torch.long)
    u_lens = u_lens.to(device=dev, dtype=torch.long)
    lp_blank = lp[..., blank]                                   # (B,T,U1)
    lab = F.pad(labels.to(device=dev, dtype=torch.long), (0, 1))
    lp_emit = torch.gather(
        lp, -1, lab[:, None, :, None].expand(B, T, U1, 1))[..., 0]
    emit_valid = torch.arange(U1, device=dev)[None, :] < u_lens[:, None]
    lp_emit = torch.where(emit_valid[:, None, :], lp_emit, NEG)

    base = torch.full((B, U1), NEG, device=dev)
    base[:, 0] = 0.0
    alphas = []
    for t in range(T):
        if t > 0:
            base = alphas[-1] + lp_blank[:, t - 1]
        emit_shift = F.pad(lp_emit[:, t, :-1], (1, 0), value=NEG)
        alphas.append(row_update(base, emit_shift))
    alphas = torch.stack(alphas)                                # (T,B,U1)

    bidx = torch.arange(B, device=dev)
    t_idx = torch.clamp(t_lens - 1, 0, T - 1)
    a_final = alphas[t_idx, bidx]                               # (B,U1)
    a_at_u = torch.gather(a_final, 1, u_lens[:, None])[:, 0]
    b_final = torch.gather(lp_blank[bidx, t_idx], 1, u_lens[:, None])[:, 0]
    return -(a_at_u + b_final)


def rnnt_loss_from_logits(logits, labels, t_lens, u_lens, blank: int = 0):
    return rnnt_loss(torch.log_softmax(logits.to(torch.float32), dim=-1),
                     labels, t_lens, u_lens, blank)


# ---------------------------------------------------------------------------
# Fused loss: autograd.Function over the joint factors, vocab-streamed
# ---------------------------------------------------------------------------

def _vocab_chunks(w_out: torch.Tensor, vocab_chunk: int):
    """The head as (n_chunks, J, C) plus its column-validity mask."""
    return vocab_chunks(w_out, resolve_vocab_chunk(w_out.shape[1],
                                                   vocab_chunk), axis=1)


def _row_scores(z, wp, valid, w_blank, w_lab, emit_valid):
    """One joint row: z (B,U1,J) -> (lpb, lpe, logz), each (B,U1).  The
    logsumexp streams over vocab chunks with an online max/sum; blank and
    label scores are direct contractions against single head columns."""
    B, U1, _ = z.shape
    m = torch.full((B, U1), NEG, device=z.device)
    s = torch.zeros((B, U1), device=z.device)
    for wc, vc in zip(wp, valid):
        lg = torch.where(vc[None, None, :], z @ wc, NEG)
        m_new = torch.maximum(m, lg.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(lg - m_new[..., None]).sum(-1)
        m = m_new
    logz = m + torch.log(torch.clamp(s, min=1e-37))
    lpb = z @ w_blank - logz
    lpe = torch.where(emit_valid, (z * w_lab).sum(-1) - logz, NEG)
    return lpb, lpe, logz


def _alpha_inputs(lpb, lpe):
    """(mult, add, emit) rows of the alpha lattice."""
    T, B, U1 = lpb.shape
    neg_row = torch.full((1, B, U1), NEG, device=lpb.device)
    mult = torch.cat([neg_row, lpb[:-1]], dim=0)
    add = torch.full((T, B, U1), NEG, device=lpb.device)
    add[0, :, 0] = 0.0
    emit = F.pad(lpe[:, :, :-1], (1, 0), value=NEG)
    return mult, add, emit


def _labels_padded(labels):
    return F.pad(labels.to(torch.long), (0, 1))                 # (B,U1)


def _fused_forward(blank, vocab_chunk, ze, zp, w_out, labels, t_lens,
                   u_lens):
    """Stream the joint over T rows -> (nll, (lpb, lpe, logz, alphas))."""
    B, T, J = ze.shape
    U1 = zp.shape[1]
    wp, valid = _vocab_chunks(w_out, vocab_chunk)
    w_blank = w_out[:, blank]
    w_lab = w_out.t()[_labels_padded(labels)]                   # (B,U1,J)
    emit_valid = torch.arange(U1, device=ze.device)[None, :] < u_lens[:, None]
    rows = [_row_scores(torch.tanh(ze[:, t, None, :] + zp), wp, valid,
                        w_blank, w_lab, emit_valid) for t in range(T)]
    lpb, lpe, logz = (torch.stack(x) for x in zip(*rows))       # (T,B,U1)

    alphas = rnnt_lattice_op(*_alpha_inputs(lpb, lpe))
    bidx = torch.arange(B, device=ze.device)
    t_idx = torch.clamp(t_lens - 1, 0, T - 1)
    a_at_u = torch.gather(alphas[t_idx, bidx], 1, u_lens[:, None])[:, 0]
    b_final = torch.gather(lpb[t_idx, bidx], 1, u_lens[:, None])[:, 0]
    nll = -(a_at_u + b_final)
    return nll, (lpb, lpe, logz, alphas)


def label_columns(lab: torch.Tensor, rows: torch.Tensor, V: int
                  ) -> torch.Tensor:
    """(J, V) sums of ``rows`` (B, U1, J) into the columns ``lab``
    (B, U1) names, as the product ``rows^T onehot(lab)``: one matrix
    product, whose sums run in the same order on every run.  A scatter
    with ``index_add_`` is an atomic, unordered sum on the card, so
    stage A's unit vector (this ``dw_out``) would not be a function of
    the seed alone."""
    onehot = torch.zeros((lab.numel(), V), dtype=rows.dtype,
                         device=rows.device).scatter_(
        1, lab.reshape(-1, 1), 1.0)          # one write a row: no conflict
    return rows.reshape(-1, rows.shape[-1]).t() @ onehot


def _fused_backward(blank, vocab_chunk, ze, zp, w_out, labels, t_lens,
                    u_lens, lpb, lpe, logz, alphas, nll, g):
    """Beta lattice + closed-form occupancy gradient, streamed over T rows
    and vocab chunks into (dze, dzp, dw_out)."""
    B, T, J = ze.shape
    U1 = zp.shape[1]
    V = w_out.shape[1]
    dev = ze.device

    # beta lattice: the same recurrence on (t, u)-flipped rows, with the
    # terminal blank injected through the additive term
    t_ids = torch.arange(T, device=dev)[:, None, None]
    u_ids = torch.arange(U1, device=dev)[None, None, :]
    terminal = ((t_ids == (t_lens - 1)[None, :, None])
                & (u_ids == u_lens[None, :, None]))             # (T,B,U1)
    term = torch.where(terminal, lpb, NEG)
    flip = lambda x: x.flip(0, 2)
    betas = flip(rnnt_lattice_op(flip(lpb), flip(term), flip(lpe)))

    # arc posteriors
    logp = -nll
    neg_row = torch.full((1, B, U1), NEG, device=dev)
    beta_next_t = torch.cat([betas[1:], neg_row], dim=0)
    beta_dest = torch.logaddexp(beta_next_t, torch.where(terminal, 0.0, NEG))
    occ_b = torch.exp(alphas + lpb + beta_dest - logp[None, :, None])
    beta_next_u = F.pad(betas[:, :, 1:], (0, 1), value=NEG)
    occ_e = torch.exp(alphas + lpe + beta_next_u - logp[None, :, None])
    gamma = occ_b + occ_e

    # stream d logits = p*gamma - occ_b*1_blank - occ_e*1_label into the
    # factor gradients, row by row (accumulators updated in place)
    wp, valid = _vocab_chunks(w_out, vocab_chunk)
    nc, _, chunk = wp.shape
    w_blank = w_out[:, blank]
    lab = _labels_padded(labels)
    w_lab = w_out.t()[lab]
    gB = g.to(torch.float32)
    dzp = torch.zeros_like(zp)
    dwo = torch.zeros((J, V), device=dev)
    dwlab = torch.zeros((B, U1, J), device=dev)
    dze = torch.empty_like(ze)
    for t in range(T):
        z = torch.tanh(ze[:, t, None, :] + zp)                  # (B,U1,J)
        coef = gamma[t] * gB[:, None]
        dz = torch.zeros((B, U1, J), device=dev)
        dwo_chunks = []
        for wc, vc in zip(wp, valid):
            p = torch.where(vc[None, None, :],
                            torch.exp(z @ wc - logz[t][..., None]), 0.0)
            pc = p * coef[..., None]                            # (B,U1,C)
            dwo_chunks.append(z.reshape(-1, J).t() @ pc.reshape(-1, chunk))
            dz += pc @ wc.t()
        dwo += torch.cat(dwo_chunks, dim=1)[:, :V]
        cb = occ_b[t] * gB[:, None]
        ce = occ_e[t] * gB[:, None]
        dz = dz - cb[..., None] * w_blank - ce[..., None] * w_lab
        dwo[:, blank] -= torch.einsum("bu,buj->j", cb, z)
        dwlab += ce[..., None] * z
        dpre = dz * (1.0 - z * z)                               # tanh'
        dzp += dpre
        dze[:, t] = dpre.sum(dim=1)
    # the accumulated -occ_e * z contributions at their label columns
    return dze, dzp, dwo - label_columns(lab, dwlab, V)


class _RNNTFused(torch.autograd.Function):
    """Analytic gradient of the fused transducer NLL w.r.t. the factors
    (ze, zp, w_out); labels and lengths are not differentiable."""

    @staticmethod
    def forward(ctx, ze, zp, w_out, labels, t_lens, u_lens, blank,
                vocab_chunk):
        nll, res = _fused_forward(blank, vocab_chunk, ze, zp, w_out,
                                  labels, t_lens, u_lens)
        ctx.save_for_backward(ze, zp, w_out, labels, t_lens, u_lens,
                              *res, nll)
        ctx.blank, ctx.vocab_chunk = blank, vocab_chunk
        return nll

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        dze, dzp, dwo = _fused_backward(ctx.blank, ctx.vocab_chunk,
                                        *ctx.saved_tensors, g)
        return dze, dzp, dwo, None, None, None, None, None


def rnnt_loss_fused(ze: torch.Tensor, zp: torch.Tensor, w_out: torch.Tensor,
                    labels: torch.Tensor, t_lens: torch.Tensor,
                    u_lens: torch.Tensor, blank: int = 0,
                    vocab_chunk: int = 0) -> torch.Tensor:
    """Per-example RNN-T NLL (B,) from the joint factors: ze (B,T,J),
    zp (B,U+1,J), w_out (J,V) — the memory-lean equivalent of
    ``rnnt_loss_from_logits(tanh(ze[:,:,None]+zp[:,None]) @ w_out, ...)``.
    ``vocab_chunk`` bounds the live logits row at ``O(B·U·vocab_chunk)``
    (``<= 0``: one chunk of the whole vocab)."""
    dev = ze.device
    return _RNNTFused.apply(
        ze.to(torch.float32), zp.to(torch.float32), w_out.to(torch.float32),
        labels.to(device=dev, dtype=torch.long),
        t_lens.to(device=dev, dtype=torch.long),
        u_lens.to(device=dev, dtype=torch.long),
        int(blank), int(vocab_chunk))
