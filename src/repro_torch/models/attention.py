"""Attention of the port (the reference's ``models/attention.py``):
GQA/MQA/MHA with full-causal, sliding-window, prefix-LM (a VLM's patch
prefix) or bidirectional masks, self- or cross-attention (an encoder's
``bidir`` layers, a decoder's ``cross`` layers over the encoder output),
for training and prefill forwards and for one-token decode against full
or ring KV caches.

Numerics are the reference's: q/k/v projections in the compute dtype,
scores accumulated in fp32 and scaled by an fp32 ``1/sqrt(hd)``, masked
scores set to ``NEG_INF = -1e30`` (not -inf), the softmax in fp32 and its
output cast to the compute dtype before ``p @ v``.

A forward dispatches as the reference does (``attn_forward``):

- band: a local layer with ``S > window + Q_BLOCK`` goes through the
  sliding-window kernels (``kernels/swa_attn``), O(S (W + C)) memory,
  any S (the reference's band gather raises unless S % 1024 == 0), in
  training as in a prefill: the forward saves each row's logsumexp and
  the backward kernel (the plain backward on the CPU) gives dq, dk and
  dv.  The kernels keep p in fp32 for ``p @ v`` where the reference's
  band gather casts it to the compute dtype first: the same function,
  and so the same gradient, at fp32 compute, within bf16 rounding at
  bf16 (ROADMAP B1);
- flash: otherwise, where ``S * S > FLASH_THRESHOLD**2``, an online
  softmax over kv blocks of ``KV_BLOCK`` in plain PyTorch
  (``_mha_flash``);
- full: materialized scores (``_mha_full``).

Caches carry an explicit per-slot position vector (-1 = empty), so full
and ring caches share one masking rule.  Every cache leaf has the batch
first, and ``t`` (the next position) is per row, so a batch of serving
slots at different positions decodes in one call.  A decode step writes
its row into the cache in place, and leaves the rows of slots that are
not live untouched: no copy of the cache is made per step.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.swa_attn.ops import softmax_scale, swa_attn_op
from repro_torch.models.common import apply_rope, dense_init, rms_norm

NEG_INF = -1e30
FLASH_THRESHOLD = 4096      # Sq*Sk above which kv blocks are scanned
KV_BLOCK = 512
Q_BLOCK = 1024

MaskFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def causal_mask(q_pos, kv_pos):
    return q_pos[..., :, None] >= kv_pos[..., None, :]


def window_mask(window: int) -> MaskFn:
    def fn(q_pos, kv_pos):
        d = q_pos[..., :, None] - kv_pos[..., None, :]
        return (d >= 0) & (d < window)
    return fn


def prefix_lm_mask(n_prefix: int) -> MaskFn:
    """Bidirectional within the first ``n_prefix`` positions, causal
    after (V2)."""
    def fn(q_pos, kv_pos):
        causal = q_pos[..., :, None] >= kv_pos[..., None, :]
        return causal | (kv_pos[..., None, :] < n_prefix)
    return fn


def bidir_mask(q_pos, kv_pos):
    return torch.ones(q_pos.shape + kv_pos.shape[-1:], dtype=torch.bool,
                      device=q_pos.device)


def _valid(kv_pos):
    return kv_pos >= 0


def _scale(hd: int) -> float:
    """The fp32 ``1/sqrt(hd)`` as a Python float (exact, so a product
    with it is the product with the fp32 tensor), read from no tensor."""
    return softmax_scale(hd)


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


def _project_qkv(params, cfg, x, q_pos, kv_pos, kv_x=None,
                 rope: bool = True):
    """-> q (B,Sq,KV,G,hd), k, v (B,Sk,KV,hd); k and v from ``kv_x``
    (B,Sk,d) (default ``x``), RoPE on q and k unless ``rope`` is False
    (cross-attention, ED2)."""
    B, S, _ = x.shape
    kv_x = x if kv_x is None else kv_x
    Sk = kv_x.shape[1]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    q = (x @ params["wq"].to(dt)).reshape(B, S, H, hd)
    k = (kv_x @ params["wk"].to(dt)).reshape(B, Sk, KV, hd)
    v = (kv_x @ params["wv"].to(dt)).reshape(B, Sk, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    if rope:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, kv_pos, cfg.rope_theta)
    return q.reshape(B, S, KV, H // KV, hd), k, v


def _mha_full(q, k, v, mask, scale):
    """q (B,Sq,KV,G,hd), k/v (B,Sk,KV,hd), mask (B,Sq,Sk) bool ->
    (B,Sq,KV,G,hd).  Scores in fp32 whatever the compute dtype (the
    products of two bf16 values are exact in fp32).  The G query heads of
    a KV head are rows of one product, so k and v are read once, not
    broadcast over the group."""
    B, Sq, KV, G, hd = q.shape
    qf = q.to(torch.float32).permute(0, 2, 3, 1, 4).reshape(B, KV, G * Sq, hd)
    kf = k.to(torch.float32).permute(0, 2, 3, 1)           # (B,KV,hd,Sk)
    scores = ((qf @ kf) * scale).reshape(B, KV, G, Sq, -1)  # (B,KV,G,Sq,Sk)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(q.dtype).reshape(B, KV, G * Sq, -1)
    out = (p @ v.permute(0, 2, 1, 3)).reshape(B, KV, G, Sq, hd)
    return out.permute(0, 3, 1, 2, 4)


def _mha_flash(q, k, v, q_pos, kv_pos, mask_fn: MaskFn, scale,
               block: int = KV_BLOCK):
    """Online softmax over kv blocks of ``block`` (the reference's
    ``_mha_flash``): fp32 scores, p cast to the compute dtype before an
    fp32-accumulated ``p @ v``; the last block is short instead of
    padded with invalid positions (the same sums)."""
    B, Sq, KV, G, hd = q.shape
    dev = q.device
    qf = q.to(torch.float32).permute(0, 2, 3, 1, 4)        # (B,KV,G,Sq,hd)
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32, device=dev)
    for j0 in range(0, k.shape[1], block):
        kc = k[:, j0:j0 + block].to(torch.float32)
        vc = v[:, j0:j0 + block]
        pc = kv_pos[:, j0:j0 + block]
        s = (qf @ kc.permute(0, 2, 3, 1)[:, :, None]) * scale
        mask = mask_fn(q_pos, pc) & _valid(pc)[..., None, :]   # (B,Sq,blk)
        s = torch.where(mask[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = (p.to(q.dtype).to(torch.float32)
              @ vc.to(torch.float32).permute(0, 2, 1, 3)[:, :, None])
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)             # (B,Sq,KV,G,hd)


def band_lengths(pos: torch.Tensor) -> torch.Tensor:
    """Per-row valid lengths (B,) int32 of positions (B,S) that are
    ``arange(S)`` below the length and -1 from it on (what a prefill
    makes); raises on any other form, which the band kernel cannot
    express.  A dry run's fake positions hold no values to check."""
    S = pos.shape[1]
    n = (pos >= 0).sum(dim=1).to(torch.int32)
    if backend.shape_only(pos):
        return n
    ar = torch.arange(S, device=pos.device)
    want = torch.where(ar[None, :] < n[:, None], ar[None, :], -1)
    if not torch.equal(pos.to(want.dtype), want):
        raise ValueError("band attention takes positions 0..n-1 followed "
                         "by -1 in every row")
    return n


def _mha_band(q, k, v, positions: Optional[torch.Tensor], window: int):
    """Sliding-window attention of a local layer through the band kernel
    (``kernels/swa_attn``): per-row lengths from the positions."""
    lengths = None if positions is None else band_lengths(positions)
    return swa_attn_op(q.contiguous(), k.contiguous(), v.contiguous(),
                       window=window, lengths=lengths)


# each kind's mask (a local layer's is its window's when it has one)
_KIND_MASKS = {"attn": causal_mask, "global": causal_mask,
               "local": causal_mask, "cross": bidir_mask,
               "bidir": bidir_mask}


def attn_forward(params, cfg, x: torch.Tensor, *, kind: str = "attn",
                 mask_fn: Optional[MaskFn] = None,
                 kv_x: Optional[torch.Tensor] = None,
                 q_positions: Optional[torch.Tensor] = None,
                 kv_positions: Optional[torch.Tensor] = None):
    """Attention of a training or prefill forward: x (B,S,d) -> (out
    (B,S,d), (k, v, kv positions)), the last what a prefill writes into
    the layer's cache; ``kind`` is ``attn``, ``local``, ``global``,
    ``bidir`` (an encoder layer) or ``cross`` (k and v from ``kv_x``
    (B,Sk,d), no RoPE); ``mask_fn`` overrides the kind's mask (the VLM's
    prefix-LM mask) outside the band.  Positions default to ``arange``
    of each side's length (-1 marks an invalid token)."""
    B, S, _ = x.shape
    Sk = S if kv_x is None else kv_x.shape[1]
    q_pos = (torch.arange(S, device=x.device).expand(B, S)
             if q_positions is None else q_positions)
    kv_pos = (torch.arange(Sk, device=x.device).expand(B, Sk)
              if kv_positions is None else kv_positions)
    q, k, v = _project_qkv(params, cfg, x, q_pos, kv_pos, kv_x,
                           rope=kind != "cross")
    scale = _scale(cfg.head_dim)
    local = kind == "local" and cfg.window
    if mask_fn is None:
        mask_fn = window_mask(cfg.window) if local else _KIND_MASKS[kind]
    if local and S == Sk and S > cfg.window + Q_BLOCK:
        out = _mha_band(q, k, v, q_positions, cfg.window)
    elif S * Sk > FLASH_THRESHOLD ** 2:
        out = _mha_flash(q, k, v, q_pos, kv_pos, mask_fn, scale)
    else:
        mask = mask_fn(q_pos, kv_pos) & _valid(kv_pos)[..., None, :]
        out = _mha_full(q, k, v, mask, scale)
    out = out.reshape(B, S, cfg.q_dim) @ params["wo"].to(x.dtype)
    return out, (k, v, kv_pos)


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, length: int, window: bool, dtype,
                  device) -> Dict[str, torch.Tensor]:
    """``length`` = full context for global/full layers; a local layer's
    ring holds ``min(length, window)``.  ``pos`` holds the absolute
    position in each slot (-1 = empty), ``t`` each row's next position."""
    L = min(length, cfg.window) if (window and cfg.window) else length
    shape = (batch, L, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((batch, L), -1, dtype=torch.int32,
                              device=device),
            "t": torch.zeros((batch,), dtype=torch.int32, device=device)}


def cache_write(cache, k_new, v_new, pos_new, live=None) -> None:
    """Write one step (Sq = 1) of every row at its slot ``t % L``, in
    place, and advance its ``t``.  Rows where ``live`` (B,) is False are
    left bit-exactly as they were."""
    B, L = cache["pos"].shape
    rows = torch.arange(B, device=k_new.device)
    slot = (cache["t"] % L).long()
    new = {"k": k_new[:, 0], "v": v_new[:, 0], "pos": pos_new[:, 0]}
    for name, val in new.items():
        buf = cache[name]
        val = val.to(buf.dtype)
        if live is not None:
            keep = live.reshape((B,) + (1,) * (val.dim() - 1))
            val = torch.where(keep, val, buf[rows, slot])
        buf[rows, slot] = val
    cache["t"] += 1 if live is None else live.to(torch.int32)


def cache_prefill(cache, k_all, v_all, pos_all):
    """Bulk fill after a prefill: keeps the last L positions.  Each row's
    ``t`` is its largest position + 1, so a right-padded prompt (pads at
    position -1) resumes decode at its true length and overwrites the
    pad slots first.  With S >= L the last L positions sit at their
    natural ring slots (position p at slot p % L), so later writes evict
    the oldest first."""
    L = cache["k"].shape[1]
    S = k_all.shape[1]
    t_next = (pos_all.max(dim=1).values + 1).to(torch.int32)
    dt = cache["k"].dtype
    if S >= L:
        shift = (S - L) % L

        def sl(a):
            return torch.roll(a[:, S - L:], shift, dims=1)
        return {"k": sl(k_all).to(dt), "v": sl(v_all).to(dt),
                "pos": sl(pos_all).to(torch.int32), "t": t_next}
    cache["k"][:, :S] = k_all.to(dt)
    cache["v"][:, :S] = v_all.to(dt)
    cache["pos"][:, :S] = pos_all.to(torch.int32)
    cache["t"] = t_next
    return cache


def attn_decode(params, cfg, x_t: torch.Tensor, cache, *,
                kind: str = "attn", mask_fn: Optional[MaskFn] = None,
                live=None) -> torch.Tensor:
    """One decode step.  x_t: (B,1,d), each row at its own position
    ``cache['t']``; the cache is updated in place (rows where ``live`` is
    False are not written); ``mask_fn`` overrides the kind's mask.
    Returns out (B,1,d)."""
    B = x_t.shape[0]
    q_pos = cache["t"][:, None].clone()         # the write advances t
    q, k_new, v_new = _project_qkv(params, cfg, x_t, q_pos, q_pos)
    cache_write(cache, k_new, v_new, q_pos, live)
    kv_pos = cache["pos"]
    if mask_fn is None:
        mask_fn = (window_mask(cfg.window)
                   if (kind == "local" and cfg.window) else causal_mask)
    mask = mask_fn(q_pos, kv_pos) & _valid(kv_pos)[..., None, :]
    out = _mha_full(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), mask,
                    _scale(cfg.head_dim))
    out = out.reshape(B, 1, cfg.q_dim)
    return out @ params["wo"].to(x_t.dtype)
