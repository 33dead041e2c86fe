"""Encoder-decoder backbone of the port (the reference's
``models/encdec.py``, the ``seamless-m4t-medium`` cell).

Encoder: bidirectional attention (RoPE on q and k) over precomputed
frame embeddings, the speech frontend being a stub as in the reference.
Decoder: causal self-attention, cross-attention over the encoder output
(no RoPE, ED2) and the FFN.  The params tree is the reference's:
``encoder`` and ``decoder`` dicts of leaves stacked on a leading layer
axis, ``enc_norm``, ``final_norm`` and ``embed.w`` (and ``lm_head.w``
for an untied head).  The reference scans each stack; the port walks the
layer axis with a Python loop (``transformer._unstack``).  Both remat
each layer in training (``remat=True``, the default of ``encode`` and
``decode_train``), the port with ``torch.utils.checkpoint``.

Numerics follow the reference as written, including where its paths
differ (ROADMAP ED1-ED4):

- ``encode`` and ``decode_train`` cast each layer's fp32 params to the
  compute dtype (``cast_block_params``), norm gammas included;
  ``decode_step`` does not: its norms scale by ``1 + fp32(gamma)``
  (ED1).  So the serving weights (``serving_params``) keep every
  decoder gamma in fp32;
- ``frames`` are cast to the compute dtype, unscaled; ``enc_norm``
  follows the encoder and is never cast (ED3);
- a decode step's cross-attention reads every row of ``ck``/``cv``
  under an all-true mask (ED2).

The decode cache is ``{"self": KV cache, "ck", "cv"}`` with the batch
first in every leaf: ``self`` leaves (B, L, ...) and ``t`` (B, L),
``ck``/``cv`` (B, L, T_src, KV, hd), where the reference stacks the
layer axis first.  A decode step writes the self cache in place.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import (compute_dtype, dense_init, embed_init,
                                       rms_norm, tree_leaves, tree_map)
from repro_torch.models.transformer import (_cast_fp32, _stack, _unstack,
                                            cast_block_params, embed_tokens)

# the norm gammas a decode step reads in fp32 (ED1); attention's QK-norm
# gammas sit in each attention dict
_DECODE_NORMS = ("ln1", "lnx", "ln2", "q_norm", "k_norm")


def _init_enc_layer(gen, cfg, device) -> Dict:
    d = cfg.d_model
    return {"ln1": torch.zeros((d,), device=device),
            "attn": attn.init_attn_params(gen, cfg, device),
            "ln2": torch.zeros((d,), device=device),
            "mlp": ffn_mod.init_ffn_params(gen, d, cfg.d_ff, cfg.ffn_type,
                                           device)}


def _init_dec_layer(gen, cfg, device) -> Dict:
    d = cfg.d_model
    return {"ln1": torch.zeros((d,), device=device),
            "self": attn.init_attn_params(gen, cfg, device),
            "lnx": torch.zeros((d,), device=device),
            "cross": attn.init_attn_params(gen, cfg, device),
            "ln2": torch.zeros((d,), device=device),
            "mlp": ffn_mod.init_ffn_params(gen, d, cfg.d_ff, cfg.ffn_type,
                                           device)}


def _serving_cast(tree, dt: torch.dtype, keep=()):
    """``tree`` with its fp32 leaves cast to ``dt``, but for the leaves
    under a key in ``keep``."""
    if isinstance(tree, dict):
        return {k: v if k in keep else _serving_cast(v, dt, keep)
                for k, v in tree.items()}
    return _cast_fp32(tree, dt)


def _decoder_keep(dt: torch.dtype):
    """What the serving weights of a decoder layer keep in fp32: every
    norm gamma when the compute dtype is not fp32 (ED1)."""
    return _DECODE_NORMS if dt != torch.float32 else ()


def init_params(cfg, gen: torch.Generator, device: torch.device,
                dtype: Optional[torch.dtype] = None) -> Dict:
    """The reference's tree and shapes, drawn from ``gen`` in its order
    (the encoder layers, the decoder layers, ``embed.w``, ``lm_head.w``).
    ``dtype`` (default fp32, the training masters) gives the serving
    weights: each layer drawn in fp32 and cast at once as
    ``serving_params`` casts it, into stacked leaves allocated with the
    first layer."""
    store = torch.float32 if dtype is None else dtype

    def stack(n, draw, keep):
        buf = None
        for i in range(n):
            layer = _serving_cast(draw(gen, cfg, device), store, keep)
            if buf is None:
                buf = tree_map(lambda l: torch.empty(
                    (n,) + l.shape, dtype=l.dtype, device=l.device), layer)
            for b, leaf in zip(tree_leaves(buf), tree_leaves(layer)):
                b[i].copy_(leaf)
        return buf

    params = {
        "encoder": stack(cfg.n_enc_layers, _init_enc_layer, ()),
        "decoder": stack(cfg.n_layers, _init_dec_layer,
                         _decoder_keep(store)),
        "embed": {"w": _cast_fp32(embed_init(gen, cfg.vocab_size,
                                             cfg.d_model, device), store)},
        "enc_norm": torch.zeros((cfg.d_model,), device=device),
        "final_norm": torch.zeros((cfg.d_model,), device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": _cast_fp32(dense_init(
            gen, cfg.d_model, cfg.vocab_size, device), store)}
    return params


def serving_params(params, cfg) -> Dict:
    """fp32 masters -> the serving weights: the encoder layers,
    ``embed.w`` and ``lm_head.w`` cast to the compute dtype (the forward
    casts them), the decoder layers but for their norm gammas, which a
    decode step reads in fp32 (ED1; a prefill casts them, which is the
    same from either), ``enc_norm`` and ``final_norm`` left fp32."""
    dt = compute_dtype(cfg)
    out = dict(params)
    out["encoder"] = _serving_cast(params["encoder"], dt)
    out["decoder"] = _serving_cast(params["decoder"], dt, _decoder_keep(dt))
    out["embed"] = _serving_cast(params["embed"], dt)
    if "lm_head" in params:
        out["lm_head"] = _serving_cast(params["lm_head"], dt)
    return out


def _maybe_remat(fn, remat: bool):
    """``fn`` (a layer: x, its params -> x) checkpointed when ``remat``
    and autograd records (the reference's ``jax.checkpoint`` of each
    layer body): the layer's forward runs again in the backward,
    bitwise; no generator state is stashed (no layer draws random
    numbers)."""
    if not (remat and torch.is_grad_enabled()):
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                    preserve_rng_state=False)


def encode(params, cfg, frames: torch.Tensor,
           remat: bool = True) -> torch.Tensor:
    """frames (B,T,d), the stub frontend's embeddings -> the encoder
    output (B,T,d) in the compute dtype (ED3); ``remat`` checkpoints each
    layer in training."""
    x = frames.to(compute_dtype(cfg))

    def layer(x, lp):
        lp = cast_block_params(lp, cfg)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + attn.attn_forward(lp["attn"], cfg, h, kind="bidir")[0]
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + ffn_mod.ffn_forward(lp["mlp"], h2, cfg.ffn_type)

    run = _maybe_remat(layer, remat)
    for lp in _unstack(params["encoder"], cfg.n_enc_layers):
        x = run(x, lp)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def decode_train(params, cfg, tokens: torch.Tensor, enc_out: torch.Tensor,
                 *, remat: bool = True, collect_cache: bool = False,
                 cache_len: int = 0):
    """Teacher-forced decoder pass: tokens (B,U) -> (the final-normed
    hidden (B,U,d), the decode cache when ``collect_cache``, else None):
    each layer's self K/V in a cache of ``cache_len`` and its cross
    ``ck``/``cv`` projected from the encoder output without RoPE (ED4),
    the forward's own values.  ``remat`` checkpoints each layer in
    training (never with ``collect_cache``)."""
    x = embed_tokens(params, cfg, tokens)
    B, U, _ = x.shape
    pos = torch.arange(U, device=x.device).expand(B, U)
    entries = []

    def layer(x, lp):
        lp = cast_block_params(lp, cfg)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, kv = attn.attn_forward(lp["self"], cfg, h, kind="attn",
                                  q_positions=pos, kv_positions=pos)
        x = x + y
        hx = rms_norm(x, lp["lnx"], cfg.norm_eps)
        yc, (ck, cv, _) = attn.attn_forward(lp["cross"], cfg, hx,
                                            kind="cross", kv_x=enc_out)
        x = x + yc
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + ffn_mod.ffn_forward(lp["mlp"], h2, cfg.ffn_type)
        if collect_cache:
            cache = attn.init_kv_cache(cfg, B, cache_len, False,
                                       compute_dtype(cfg), x.device)
            entries.append({"self": attn.cache_prefill(cache, *kv),
                            "ck": ck, "cv": cv})
        return x

    run = _maybe_remat(layer, remat and not collect_cache)
    for lp in _unstack(params["decoder"], cfg.n_layers):
        x = run(x, lp)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, (_stack(entries) if collect_cache else None)


def decode_step(params, cfg, x_t: torch.Tensor, cache, live=None
                ) -> torch.Tensor:
    """One decoder token: x_t (B,1,d) -> the final-normed hidden (B,1,d).
    The layers' params are read as they are stored (no cast, ED1); each
    self cache is written in place (rows where ``live`` is False are
    not); cross-attention reads all of ``ck``/``cv`` (ED2)."""
    scale = attn._scale(cfg.head_dim)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    L = cfg.n_layers
    selfs = _unstack(cache["self"], L, dim=1)
    cks = torch.unbind(cache["ck"], 1)
    cvs = torch.unbind(cache["cv"], 1)
    x = x_t
    for i, lp in enumerate(_unstack(params["decoder"], L)):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + attn.attn_decode(lp["self"], cfg, h, selfs[i], kind="attn",
                                 live=live)
        hx = rms_norm(x, lp["lnx"], cfg.norm_eps)
        B = hx.shape[0]
        q = (hx @ lp["cross"]["wq"].to(hx.dtype)).reshape(B, 1, H, hd)
        if cfg.qk_norm:
            q = rms_norm(q, lp["cross"]["q_norm"], cfg.norm_eps)
        q = q.reshape(B, 1, KV, H // KV, hd)
        mask = torch.ones((B, 1, cks[i].shape[1]), dtype=torch.bool,
                          device=x.device)
        y = attn._mha_full(q, cks[i].to(q.dtype), cvs[i].to(q.dtype), mask,
                           scale)
        x = x + y.reshape(B, 1, cfg.q_dim) @ lp["cross"]["wo"].to(hx.dtype)
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + ffn_mod.ffn_forward(lp["mlp"], h2, cfg.ffn_type)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def init_cache(cfg, batch: int, cache_len: int, dtype=None,
               src_len: Optional[int] = None,
               device=torch.device("cpu")) -> Dict:
    """Empty decode cache: a self KV cache of ``cache_len`` and cross
    ``ck``/``cv`` of ``src_len`` (default ``cache_len``) rows a layer, in
    ``dtype`` (default the compute dtype)."""
    dtype = compute_dtype(cfg) if dtype is None else dtype
    L = cfg.n_layers
    src_len = src_len or cache_len
    one = attn.init_kv_cache(cfg, batch, cache_len, False, dtype, device)
    shape = (batch, L, src_len, cfg.n_kv_heads, cfg.head_dim)
    return {"self": _stack([one] * L),
            "ck": torch.zeros(shape, dtype=dtype, device=device),
            "cv": torch.zeros(shape, dtype=dtype, device=device)}
