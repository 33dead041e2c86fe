"""Attention of the port, training path (the reference's
``models/attention.py``): GQA/MQA/MHA with full-causal or sliding-window
masks over materialized scores.

Numerics are the reference's: q/k/v projections in the compute dtype,
scores accumulated in fp32 and scaled by an fp32 ``1/sqrt(hd)``, masked
scores set to ``NEG_INF = -1e30`` (not -inf), the softmax in fp32 and its
output cast to the compute dtype before ``p @ v``.  Where the reference
dispatches to its band-gather (``_mha_band``, a local layer with
``S > window + Q_BLOCK``) or its kv-block online-softmax scan
(``_mha_flash``, ``Sq * Sk > FLASH_THRESHOLD**2``), the port raises
``NotImplementedError``: those are a later slice.  KV caches and decode
belong to the serving slice.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.models.common import apply_rope, dense_init, rms_norm

NEG_INF = -1e30
FLASH_THRESHOLD = 4096      # Sq*avg_Sk above which the reference scans kv blocks
Q_BLOCK = 1024

MaskFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_LATER = ("is not ported yet (ROADMAP.md queue 1, the rest of the "
          "decoder-LM path)")


def causal_mask(q_pos, kv_pos):
    return q_pos[..., :, None] >= kv_pos[..., None, :]


def window_mask(window: int) -> MaskFn:
    def fn(q_pos, kv_pos):
        d = q_pos[..., :, None] - kv_pos[..., None, :]
        return (d >= 0) & (d < window)
    return fn


def _valid(kv_pos):
    return kv_pos >= 0


def init_attn_params(gen: torch.Generator, cfg, device: torch.device) -> Dict:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {"wq": dense_init(gen, d, qd, device),
         "wk": dense_init(gen, d, kvd, device),
         "wv": dense_init(gen, d, kvd, device),
         "wo": dense_init(gen, qd, d, device)}
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((cfg.head_dim,), device=device)
        p["k_norm"] = torch.zeros((cfg.head_dim,), device=device)
    return p


def _project_qkv(params, cfg, x, q_pos, kv_pos):
    """-> q (B,Sq,KV,G,hd), k, v (B,Sk,KV,hd)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    q = (x @ params["wq"].to(dt)).reshape(B, S, H, hd)
    k = (x @ params["wk"].to(dt)).reshape(B, S, KV, hd)
    v = (x @ params["wv"].to(dt)).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, q_pos, cfg.rope_theta)
    k = apply_rope(k, kv_pos, cfg.rope_theta)
    return q.reshape(B, S, KV, H // KV, hd), k, v


def _mha_full(q, k, v, mask, scale):
    """q (B,Sq,KV,G,hd), k/v (B,Sk,KV,hd), mask (B,Sq,Sk) bool ->
    (B,Sq,KV,G,hd).  Scores in fp32 whatever the compute dtype (the
    products of two bf16 values are exact in fp32)."""
    qf = q.to(torch.float32).permute(0, 2, 3, 1, 4)        # (B,KV,G,Sq,hd)
    kf = k.to(torch.float32).permute(0, 2, 3, 1)[:, :, None]  # (B,KV,1,hd,Sk)
    scores = (qf @ kf) * scale                              # (B,KV,G,Sq,Sk)
    scores = torch.where(mask[:, None, None], scores,
                         torch.tensor(NEG_INF, dtype=torch.float32,
                                      device=scores.device))
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = p @ v.permute(0, 2, 1, 3)[:, :, None]            # (B,KV,G,Sq,hd)
    return out.permute(0, 3, 1, 2, 4)


def attn_forward(params, cfg, x: torch.Tensor, *,
                 kind: str = "attn") -> torch.Tensor:
    """Self-attention of a training forward at positions 0..S-1: x (B,S,d)
    -> (B,S,d); ``kind`` is ``attn``, ``local`` or ``global``."""
    B, S, _ = x.shape
    local = kind == "local" and cfg.window
    if local and S > cfg.window + Q_BLOCK:
        raise NotImplementedError(
            f"{cfg.name}: the band-gather sliding-window attention "
            f"(S={S} > window {cfg.window} + {Q_BLOCK}) {_LATER}")
    if S * S > FLASH_THRESHOLD ** 2:
        raise NotImplementedError(
            f"{cfg.name}: the kv-block online-softmax attention "
            f"(S={S} > {FLASH_THRESHOLD}) {_LATER}")
    pos = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(params, cfg, x, pos, pos)
    scale = 1.0 / torch.sqrt(torch.tensor(float(cfg.head_dim),
                                          dtype=torch.float32,
                                          device=x.device))
    mask_fn = window_mask(cfg.window) if local else causal_mask
    mask = mask_fn(pos, pos) & _valid(pos)[..., None, :]
    out = _mha_full(q, k, v, mask, scale).reshape(B, S, cfg.q_dim)
    return out @ params["wo"].to(x.dtype)
