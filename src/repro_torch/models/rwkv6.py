"""RWKV6 "Finch" time-mix and channel-mix of the port [arXiv:2404.05892]
(the reference's ``models/rwkv6.py``): the training and prefill forward,
which returns the final WKV state and the last token-shift row for the
decode cache, and the one-token decode update from a carried state and
previous row.

Time-mix: data-dependent token-shift (ddlerp via a small LoRA MLP),
data-dependent per-channel decay w_t, bonus u, and the WKV linear
recurrence  S_t = diag(w_t) S_{t-1} + k_t^T v_t,
            y_t = r_t (S_{t-1} + diag(u) k_t^T v_t).

The branch rule is the reference's: a sequence with S % 64 == 0 and
S >= 128 takes the chunk-parallel WKV, through ``rwkv6_wkv_op`` (the
Hopper kernels on the card, the plain chunk algebra on the CPU); any
other takes the sequential ``wkv_scan``, which the reference computes
outside any Pallas kernel, so it stays plain PyTorch on the card too.
A decode step (a carried state) is the reference's sequential one-token
update (``chunked=False``).

With ``lengths`` (B,) (a right-padded prefill, pads at position -1) the
pad steps take k = 0 and a log-decay of 0 (a decay of 1), so the WKV
state carries through them unchanged, in the kernel's chunk algebra as
in the scan, and the shift rows are taken at each row's length - 1: the
cache of an unpadded prefill of the live prefix (the reference runs its
pads through the recurrence, ROADMAP S10).

The gates use ``sigmoid`` (``models/common.py``), the logistic as the
reference's JAX evaluates it (R9).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan.ops import rwkv6_wkv_op
from repro_torch.kernels.rwkv6_scan.ref import CHUNK, log_decay, wkv_scan
from repro_torch.models.common import dense_init, sigmoid

TM_EXTRA = 32     # ddlerp lora dim
TD_EXTRA = 64     # decay lora dim


def init_tmix_params(gen: torch.Generator, d: int, n_heads: int,
                     head_dim: int, device: torch.device) -> Dict:
    hn = n_heads * head_dim

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    return {
        "mu_x": zeros(d), "mu_w": zeros(d), "mu_k": zeros(d),
        "mu_v": zeros(d), "mu_r": zeros(d), "mu_g": zeros(d),
        "ddlerp_w1": dense_init(gen, d, 5 * TM_EXTRA, device, scale=0.1),
        "ddlerp_w2": (torch.randn((5, TM_EXTRA, d), generator=gen,
                                  device=gen.device) * 0.01).to(device),
        "decay_base": torch.full((n_heads, head_dim), -1.0, device=device),
        "decay_w1": dense_init(gen, d, TD_EXTRA, device, scale=0.1),
        "decay_w2": dense_init(gen, TD_EXTRA, hn, device, scale=0.1),
        "bonus": torch.full((n_heads, head_dim), 0.5, device=device),
        "wr": dense_init(gen, d, hn, device),
        "wk": dense_init(gen, d, hn, device),
        "wv": dense_init(gen, d, hn, device),
        "wg": dense_init(gen, d, hn, device),
        "wo": dense_init(gen, hn, d, device),
        "ln_g": torch.ones((hn,), device=device),
        "ln_b": zeros(hn),
    }


def init_cmix_params(gen: torch.Generator, d: int, d_ff: int,
                     device: torch.device) -> Dict:
    return {
        "mu_k": torch.zeros((d,), device=device),
        "mu_r": torch.zeros((d,), device=device),
        "wk": dense_init(gen, d, d_ff, device),
        "wv": dense_init(gen, d_ff, d, device),
        "wr": dense_init(gen, d, d, device),
    }


def _token_shift(x: torch.Tensor,
                 x_prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B,S,d) -> the previous token's row: one zero row (or the
    carried row ``x_prev`` (B,d), cast to x's dtype) in front and the
    last row dropped (not a roll, R1)."""
    if x_prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([x_prev.to(x.dtype)[:, None], x[:, :-1]], dim=1)


def _last_row(x: torch.Tensor, lengths: Optional[torch.Tensor]):
    """The row at each row's length - 1 (B,d), or the last one."""
    if lengths is None:
        return x[:, -1]
    last = torch.clamp(lengths.long() - 1, min=0)
    return x[torch.arange(x.shape[0], device=x.device), last]


def tmix_forward(p, cfg, x: torch.Tensor, state0=None, x_prev=None,
                 lengths=None):
    """x (B,S,d) in the compute dtype; state0 (B,H,N,N) fp32 and x_prev
    (B,d) carried from a previous segment (decode) or None; lengths (B,)
    or None -> (y (B,S,d), (the final WKV state (B,H,N,N) fp32, the
    shift row (B,d) in x's dtype))."""
    B, S, d = x.shape
    H, N = cfg.n_heads, cfg.rwkv_head_dim
    dt = x.dtype
    f32 = torch.float32
    sx = _token_shift(x, x_prev) - x
    xxx = x + sx * p["mu_x"].to(dt)
    lora = torch.tanh(xxx @ p["ddlerp_w1"].to(dt))           # (B,S,5*E)
    lora = lora.reshape(B, S, 5, TM_EXTRA)
    adj = torch.einsum("bste,ted->bstd", lora, p["ddlerp_w2"].to(dt))
    mus = torch.stack([p["mu_w"], p["mu_k"], p["mu_v"], p["mu_r"],
                       p["mu_g"]]).to(dt)
    xw, xk, xv, xr, xg = [x + sx * (mus[i] + adj[:, :, i]) for i in range(5)]

    r = (xr @ p["wr"].to(dt)).reshape(B, S, H, N)
    k = (xk @ p["wk"].to(dt)).reshape(B, S, H, N)
    v = (xv @ p["wv"].to(dt)).reshape(B, S, H, N)
    xg = xg @ p["wg"].to(dt)
    g = xg * sigmoid(xg)                                     # jax.nn.silu

    dd = torch.tanh(xw @ p["decay_w1"].to(dt)) @ p["decay_w2"].to(dt)
    logit = p["decay_base"].reshape(-1).to(f32) + dd.to(f32)
    w = torch.exp(-torch.exp(logit)).reshape(B, S, H, N)      # (0,1)
    u = p["bonus"].to(f32)
    r, k, v = r.to(f32), k.to(f32), v.to(f32)
    valid = None
    if lengths is not None:
        valid = (torch.arange(S, device=x.device)[None, :]
                 < lengths.to(x.device)[:, None])[:, :, None, None]
        k = torch.where(valid, k, torch.zeros((), dtype=f32,
                                              device=x.device))

    if state0 is None and S % CHUNK == 0 and S >= 2 * CHUNK:
        lw = log_decay(w)
        if valid is not None:
            lw = torch.where(valid, lw, torch.zeros((), dtype=f32,
                                                    device=x.device))
        y, state = rwkv6_wkv_op(r, k, v, lw, u, CHUNK)
    else:
        if valid is not None:
            w = torch.where(valid, w, torch.ones((), dtype=f32,
                                                 device=x.device))
        s0 = (torch.zeros((B, H, N, N), dtype=f32, device=x.device)
              if state0 is None else state0.to(f32))
        y, state = wkv_scan(r, k, v, w, u, s0)
    # per-head group norm, fp32, population variance
    yh = y.reshape(B, S, H, N).to(f32)
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, unbiased=False)
    yh = (yh - mu) * torch.rsqrt(var + 64e-5)
    y = yh.reshape(B, S, H * N) * p["ln_g"] + p["ln_b"]       # -> fp32
    y = y.to(dt) * g
    return y @ p["wo"].to(dt), (state, _last_row(x, lengths))


def cmix_forward(p, x: torch.Tensor, x_prev=None, lengths=None):
    """-> (out (B,S,d), the shift row (B,d) in x's dtype)."""
    dt = x.dtype
    sx = _token_shift(x, x_prev) - x
    xk = x + sx * p["mu_k"].to(dt)
    xr = x + sx * p["mu_r"].to(dt)
    k = torch.square(F.relu(xk @ p["wk"].to(dt)))
    kv = k @ p["wv"].to(dt)
    return sigmoid(xr @ p["wr"].to(dt)) * kv, _last_row(x, lengths)
