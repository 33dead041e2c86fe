"""Decoder stack of the port for dense attention LMs and RWKV6 stacks
(the reference's ``models/transformer.py``, training/prefill forward).

The params tree is the reference's: ``stack.groups`` is a tuple with one
dict per position of the config's ``pattern``, each leaf stacked over a
leading ``n_layers // len(pattern)`` axis, and ``stack.tail`` a tuple of
per-layer dicts for the remainder layers.  The reference scans the groups
with ``lax.scan`` (and remat); the port walks the layer axis with a
Python loop, which computes the same numbers.  The stacked leaves are
unbound once per forward (``torch.unbind``), so their backward stacks
the per-layer gradients in one copy instead of scattering each layer's
into a zero tensor of the whole stack.

Attention blocks with a dense feed-forward, and RWKV6 blocks (time-mix
and channel-mix, no attention and no MLP): the bundle
(``models/api.py:LMBundle``) refuses configs with other block kinds or
MoE layers.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.configs.base import BLOCK_RWKV
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.common import (compute_dtype, dense_init, embed_init,
                                       rms_norm, tree_map)


def _init_block(gen: torch.Generator, cfg, kind: str,
                device: torch.device) -> Dict:
    d = cfg.d_model
    p = {"ln1": torch.zeros((d,), device=device),
         "ln2": torch.zeros((d,), device=device)}
    if kind == BLOCK_RWKV:
        p["tmix"] = rwkv_mod.init_tmix_params(
            gen, d, cfg.n_heads, cfg.rwkv_head_dim, device)
        p["cmix"] = rwkv_mod.init_cmix_params(gen, d, cfg.d_ff, device)
    else:
        p["attn"] = attn.init_attn_params(gen, cfg, device)
        p["mlp"] = ffn_mod.init_ffn_params(gen, d, cfg.d_ff, cfg.ffn_type,
                                           device)
    return p


def init_params(cfg, gen: torch.Generator, device: torch.device) -> Dict:
    """The reference's tree and shapes, drawn from ``gen`` layer by layer
    (each layer's draws moved to ``device`` before the next is drawn)."""
    P = len(cfg.pattern)
    n_groups = cfg.n_layers // P
    per_layer = [_init_block(gen, cfg, kind, device)
                 for kind in cfg.layer_kinds()]
    groups = tuple(
        tree_map(lambda *xs: torch.stack(xs),
                 *[per_layer[g * P + pos] for g in range(n_groups)])
        for pos in range(P)) if n_groups else tuple()
    tail = tuple(per_layer[n_groups * P:])
    del per_layer
    params = {
        "embed": {"w": embed_init(gen, cfg.vocab_size, cfg.d_model, device)},
        "stack": {"groups": groups, "tail": tail},
        "final_norm": torch.zeros((cfg.d_model,), device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": dense_init(gen, cfg.d_model,
                                             cfg.vocab_size, device)}
    return params


def cast_block_params(bp, cfg):
    """The block's fp32 master params cast to the compute dtype once, as
    the reference does (the norms' gammas included, so a block norm scales
    by ``1 + bf16(gamma)``; and an RWKV block's ``decay_base``, ``bonus``,
    ``mu_*`` and ``ln_g``/``ln_b``, which the time-mix widens back to
    fp32 or mixes with fp32 values); no-op for fp32 compute."""
    dt = compute_dtype(cfg)
    if dt == torch.float32:
        return bp
    return tree_map(lambda l: l.to(dt) if l.dtype == torch.float32 else l,
                    bp)


def block_forward(bp, cfg, kind: str, x: torch.Tensor) -> torch.Tensor:
    bp = cast_block_params(bp, cfg)
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    if kind == BLOCK_RWKV:
        x = x + rwkv_mod.tmix_forward(bp["tmix"], cfg, h)
        h2 = rms_norm(x, bp["ln2"], cfg.norm_eps)
        return x + rwkv_mod.cmix_forward(bp["cmix"], h2)
    x = x + attn.attn_forward(bp["attn"], cfg, h, kind=kind)
    h2 = rms_norm(x, bp["ln2"], cfg.norm_eps)
    return x + ffn_mod.ffn_forward(bp["mlp"], h2, cfg.ffn_type)


def embed_tokens(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"]["w"][tokens.long()].to(compute_dtype(cfg))
    if cfg.embed_scale:
        x = x * torch.sqrt(torch.tensor(float(cfg.d_model))).to(x.dtype)
    return x


def head_weight(params, cfg) -> torch.Tensor:
    """(d, V) LM head; a tied head is ``embed.w`` viewed transposed."""
    return (params["embed"]["w"].t() if cfg.tie_embeddings
            else params["lm_head"]["w"])


def unembed(params, cfg, x: torch.Tensor) -> torch.Tensor:
    return x @ head_weight(params, cfg).to(x.dtype)


def _unstack(tree: Any, n: int) -> List[Any]:
    """A dict of leaves stacked on a leading axis of ``n`` -> ``n``
    per-layer dicts of views (``unbind``)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def forward_hidden(params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Runs the stack on embedded input ``x`` (B,S,d) -> the final-normed
    hidden states (B,S,d)."""
    pattern = cfg.pattern
    n_groups = cfg.n_layers // len(pattern)
    if n_groups:
        layers = [_unstack(gp, n_groups) for gp in params["stack"]["groups"]]
        for g in range(n_groups):
            for pos, kind in enumerate(pattern):
                x = block_forward(layers[pos][g], cfg, kind, x)
    kinds = cfg.layer_kinds()
    for i, bp in enumerate(params["stack"]["tail"]):
        x = block_forward(bp, cfg, kinds[n_groups * len(pattern) + i], x)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)
