"""RG-LRU recurrent block of the port (Griffin / RecurrentGemma)
[arXiv:2402.19427], the reference's ``models/rglru.py``.

Block: x -> (linear -> causal depthwise conv(width 4) -> RG-LRU) gated by a
parallel GeLU branch -> output projection.

RG-LRU:  r_t = sigmoid(W_a x_t + b_a)   (recurrence gate)
         i_t = sigmoid(W_x x_t + b_x)   (input gate)
         log a_t = -c * softplus(Lambda) * r_t          (c = 8)
         h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference runs the recurrence as a ``jax.lax.associative_scan`` in
XLA (no Pallas kernel), so plain PyTorch ops carry it here too: a
Hillis-Steele scan over the (a, b) pairs, ceil(log2 S) steps of whole-
tensor ops (13 at S 8,192), not a loop over S.  Its backward is the same
scan run in reverse (``_LinearScan``), which saves a and h only, where
autograd through the doubling steps would keep two tensors a step.  A
carried state ``h0`` enters as the reference folds it in, a virtual step
at t = -1 with a = 1.  The orders of the combines differ from the
reference's only in fp32 rounding.  The scan runs in the profiler ranges
``rglru.scan`` and ``rglru.scan_bwd``, which name its device time.

Numerics are the reference's (ROADMAP hazards RG1-RG4): the conv sums
``xp[:, i:i+S] * w[cw-1-i]`` (taps in reverse order) in the compute dtype
and its state holds the last ``cw - 1`` inputs, fp32 between decode steps;
the gates are computed from fp32 ``u`` with the (rounded, at bf16)
weights widened; ``softplus(lam)`` is ``logaddexp(lam, 0)`` in lam's
dtype, then promoted; ``sqrt(max(-expm1(2 log a), 0))`` in fp32; h is
carried in fp32 and cast to the compute dtype before the gate; the GeLU
branch is ``jax.nn.gelu``'s tanh form op by op (F4).

With ``lengths`` (B,) (a right-padded prefill, pads at position -1) the
pad steps take a = 1 and an input of 0, so h carries through them, and
the conv state is the ``cw - 1`` inputs that end at each row's length:
the state is the one of an unpadded prefill of the live prefix (the
reference's bucketed prefill runs the recurrence over its pads, S10).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.common import _gelu_tanh, dense_init, sigmoid

RGLRU_C = 8.0


def init_rglru_params(gen: torch.Generator, d_model: int, width: int,
                      conv_width: int, device: torch.device) -> Dict:
    """The reference's leaves and shapes, drawn from ``gen`` in its order
    (``w_in``, ``w_gate_branch``, ``conv_w``, ``wa``, ``wx``,
    ``w_out``)."""
    w_in = dense_init(gen, d_model, width, device)
    w_gate = dense_init(gen, d_model, width, device)
    conv_w = (torch.randn((conv_width, width), generator=gen,
                          device=gen.device) * 0.1).to(device)
    wa = dense_init(gen, width, width, device)
    wx = dense_init(gen, width, width, device)
    w_out = dense_init(gen, width, d_model, device)

    def zeros():
        return torch.zeros((width,), device=device)

    return {"w_in": w_in, "w_gate_branch": w_gate, "conv_w": conv_w,
            "conv_b": zeros(), "wa": wa, "ba": zeros(), "wx": wx,
            "bx": zeros(),
            "lam": torch.linspace(0.3, 1.7, width, device=device),
            "w_out": w_out}


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None,
                 lengths: Optional[torch.Tensor] = None):
    """Depthwise causal conv by shifted adds (RG1).  x (B,S,w) in the
    compute dtype; state (B,cw-1,w), the trailing inputs of the previous
    segment (decode), or zeros -> (out (B,S,w), the cw - 1 inputs that end
    at each row's length, or at S)."""
    cw = w.shape[0]
    B, S, _ = x.shape
    if state is None:
        pad = torch.zeros((B, cw - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                     # (B, S+cw-1, w)
    out = xp[:, 0:S] * w[cw - 1].to(x.dtype)
    for i in range(1, cw):
        out = out + xp[:, i:i + S] * w[cw - 1 - i].to(x.dtype)
    if lengths is None:
        new_state = xp[:, S:]
    else:
        # rows n .. n + cw - 2 of xp: inputs n - cw + 1 .. n - 1
        idx = lengths.long()[:, None] + torch.arange(cw - 1, device=x.device)
        new_state = torch.gather(
            xp, 1, idx[:, :, None].expand(B, cw - 1, xp.shape[2]))
    return out + b.to(x.dtype), new_state


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of h_t = a_t h_{t-1} + b_t over dim 1 (h_{-1} = 0)
    by Hillis-Steele doubling: step d combines each element with the one
    d before it, ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)``."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


class _LinearScan(torch.autograd.Function):
    """h_t = a_t h_{t-1} + b_t over dim 1 (h_{-1} = 0).  The gradient:
    g_t = dh_t + a_{t+1} g_{t+1}, a reverse scan of the same form; db = g
    and da_t = g_t h_{t-1}."""

    @staticmethod
    def forward(ctx, a, b):
        with torch.profiler.record_function("rglru.scan"):
            h = _scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        with torch.profiler.record_function("rglru.scan_bwd"):
            a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
            g = _scan(a_next.flip(1), dh.flip(1)).flip(1)
            h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
            return g * h_prev, g


def _rg_lru(x, r, i, lam, h0: Optional[torch.Tensor],
            valid: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, r, i (B,S,w) fp32; lam (w,) in the block's dtype; h0 (B,w) or
    None; valid (B,S) bool or None -> (h (B,S,w), h at the last step)."""
    sp = torch.logaddexp(lam, torch.zeros_like(lam))   # softplus, lam's dtype
    log_a = (-RGLRU_C * sp) * r                         # <= 0, fp32 (RG2)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(-torch.expm1(2.0 * log_a), min=0.0)) \
        * (i * x)                                       # RG4
    if valid is not None:
        v = valid[:, :, None]
        a = torch.where(v, a, torch.ones((), dtype=a.dtype, device=a.device))
        gated = torch.where(v, gated, torch.zeros((), dtype=gated.dtype,
                                                  device=gated.device))
    if h0 is not None:
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        gated = torch.cat([h0[:, None].to(gated.dtype), gated], dim=1)
    hh = _LinearScan.apply(a, gated)
    if h0 is not None:
        hh = hh[:, 1:]
    return hh, hh[:, -1]


def rglru_forward(p, cfg, x: torch.Tensor, state: Optional[Dict] = None,
                  lengths: Optional[torch.Tensor] = None):
    """x (B,S,d) in the compute dtype; state {"h": (B,w), "conv":
    (B,cw-1,w)} or None; lengths (B,) or None (every row holds S) ->
    (out (B,S,d), the new state in fp32)."""
    dt = x.dtype
    f32 = torch.float32
    u = x @ p["w_in"].to(dt)
    gate = _gelu_tanh(x @ p["w_gate_branch"].to(dt))   # RG3
    conv_state = None if state is None else state["conv"]
    u, new_conv = _causal_conv(u, p["conv_w"], p["conv_b"], conv_state,
                               lengths)
    u32 = u.to(f32)
    r = sigmoid(u32 @ p["wa"].to(f32) + p["ba"])
    i = sigmoid(u32 @ p["wx"].to(f32) + p["bx"])
    valid = None
    if lengths is not None:
        S = x.shape[1]
        valid = torch.arange(S, device=x.device)[None, :] \
            < lengths.to(x.device)[:, None]
    h0 = None if state is None else state["h"]
    h, h_last = _rg_lru(u32, r, i, p["lam"], h0, valid)
    out = (h.to(dt) * gate) @ p["w_out"].to(dt)
    # the recurrent state is carried in fp32 across decode steps
    return out, {"h": h_last.to(f32), "conv": new_conv.to(f32)}


def init_rglru_state(batch: int, width: int, conv_width: int,
                     device=torch.device("cpu")) -> Dict:
    return {"h": torch.zeros((batch, width), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, conv_width - 1, width),
                                dtype=torch.float32, device=device)}
