"""Decoder stack of the port for dense and MoE attention LMs (and the
VLM's text backbone, under its prefix-LM mask), RWKV6 stacks and the
RG-LRU hybrid (the reference's ``models/transformer.py``):
the training/prefill forward with the stack's MoE load-balance aux, the
prefill cache and the one-token decode of every block kind.

The params tree is the reference's: ``stack.groups`` is a tuple with one
dict per position of the config's ``pattern``, each leaf stacked over a
leading ``n_layers // len(pattern)`` axis, and ``stack.tail`` a tuple of
per-layer dicts for the remainder layers.  The reference scans the groups
with ``lax.scan``; the port walks the layer axis with a Python loop,
which computes the same numbers.  Both remat each group in training
(``forward_hidden(remat=True)``, the default): the port with
``torch.utils.checkpoint``.  The stacked leaves are
unbound once per forward (``torch.unbind``), so their backward stacks
the per-layer gradients in one copy instead of scattering each layer's
into a zero tensor of the whole stack.

Training holds fp32 master weights and casts each block to the compute
dtype at every call, as the reference does; serving holds them once in
the compute dtype (``init_params(dtype=...)``, ``serving_params``), on
which the same casts are no-ops, so the logits are bitwise the same.

The decode cache has the reference's tree (``groups``/``tail``, one
entry per layer: a KV cache for an attention layer, the recurrent state
``{"h", "conv"}`` for an RG-LRU layer, ``{"S", "x_tmix", "x_cmix"}`` for
an RWKV6 layer) with the batch first in every leaf: a group leaf is (B,
n_groups, ...), where the reference stacks the layer axis first.  So a
serving slot is index 0 of every leaf.  A decode step writes every
entry in place and leaves the rows that are not ``live`` bit-exactly as
they were; a recurrent entry's update is cast to the entry's dtype (the
slot pool's state is fp32, a prefill's shift rows come in the compute
dtype, ROADMAP RG5).

Attention blocks with a dense or MoE feed-forward (``models/moe.py``:
a prefill or training forward routes at the training capacity, a decode
step at the no-drop capacity, as the reference's), RG-LRU blocks
(``models/rglru.py``) with the dense feed-forward, and RWKV6 blocks
(time-mix and channel-mix, no attention and no MLP).  A prefill with
padded rows (positions -1 from each row's length on) hands the
recurrent blocks each row's length, so their state is taken at it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import BLOCK_REC, BLOCK_RWKV
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.common import (compute_dtype, dense_init, embed_init,
                                       rms_norm, tree_leaves, tree_map)
from repro_torch.sharding import fsdp


def _init_block(gen: torch.Generator, cfg, kind: str, device: torch.device,
                store: torch.dtype = torch.float32) -> Dict:
    """One layer's params in fp32, but for the MoE experts, drawn in
    ``store`` (each stack cast as soon as it is drawn)."""
    d = cfg.d_model
    p = {"ln1": torch.zeros((d,), device=device),
         "ln2": torch.zeros((d,), device=device)}
    if kind == BLOCK_RWKV:
        p["tmix"] = rwkv_mod.init_tmix_params(
            gen, d, cfg.n_heads, cfg.rwkv_head_dim, device)
        p["cmix"] = rwkv_mod.init_cmix_params(gen, d, cfg.d_ff, device)
        return p
    if kind == BLOCK_REC:
        p["rec"] = rglru_mod.init_rglru_params(
            gen, d, cfg.lru_width or d, cfg.conv_width, device)
        p["mlp"] = ffn_mod.init_ffn_params(gen, d, cfg.d_ff, cfg.ffn_type,
                                           device)
        return p
    p["attn"] = attn.init_attn_params(gen, cfg, device)
    if cfg.moe is not None:
        p["moe"] = moe_mod.init_moe_params(gen, d, cfg.moe, cfg.ffn_type,
                                           device, store)
    else:
        p["mlp"] = ffn_mod.init_ffn_params(gen, d, cfg.d_ff, cfg.ffn_type,
                                           device)
    return p


def _cast_fp32(tree, dt: torch.dtype):
    """``tree`` (or one leaf) with its fp32 leaves cast to ``dt``, the
    others kept."""
    return tree_map(lambda l: l.to(dt) if l.dtype == torch.float32 else l,
                    tree)


def init_params(cfg, gen: torch.Generator, device: torch.device,
                dtype: Optional[torch.dtype] = None) -> Dict:
    """The reference's tree and shapes, drawn from ``gen`` layer by layer
    in the reference's order (the layers, ``embed.w``, ``lm_head.w``).

    ``dtype`` (default fp32, the training masters) is the storage dtype
    of every leaf the forward casts to the compute dtype: each block's
    leaves, ``embed.w`` and ``lm_head.w``; ``final_norm`` stays fp32, as
    the forward reads it.  Each layer is drawn in fp32, cast at once and
    written into its group's leaves, which are allocated when the first
    group is drawn, so no stacked copy is made: the peak is the tree plus
    one layer's fp32 draws (an MoE layer's expert stacks are cast as each
    is drawn, so one stack's) and ``embed.w``'s, which are drawn whole.
    The compute dtype gives the serving weights, bitwise
    ``serving_params`` of the fp32 tree from the same generator."""
    store = torch.float32 if dtype is None else dtype
    P = len(cfg.pattern)
    n_groups = cfg.n_layers // P
    groups: List[Any] = [None] * P
    tail = []
    for i, kind in enumerate(cfg.layer_kinds()):
        layer = _cast_fp32(_init_block(gen, cfg, kind, device, store), store)
        g, pos = divmod(i, P)
        if g >= n_groups:
            tail.append(layer)
            continue
        if groups[pos] is None:
            groups[pos] = tree_map(
                lambda l: torch.empty((n_groups,) + l.shape, dtype=l.dtype,
                                      device=l.device), layer)
        for buf, leaf in zip(tree_leaves(groups[pos]), tree_leaves(layer)):
            buf[g].copy_(leaf)
        del layer
    params = {
        "embed": {"w": _cast_fp32(embed_init(gen, cfg.vocab_size,
                                             cfg.d_model, device), store)},
        "stack": {"groups": tuple(groups) if n_groups else tuple(),
                  "tail": tuple(tail)},
        "final_norm": torch.zeros((cfg.d_model,), device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": _cast_fp32(dense_init(
            gen, cfg.d_model, cfg.vocab_size, device), store)}
    return params


def serving_params(params, cfg) -> Dict:
    """fp32 masters -> the serving weights: every leaf the forward casts
    to the compute dtype cast once (each block's fp32 leaves, the norms'
    gammas included, ``embed.w`` and ``lm_head.w``), ``final_norm`` left
    fp32; leaves already in the compute dtype are kept, not copied.  The
    forward casts only fp32 leaves, so its logits from these are bitwise
    its logits from the masters."""
    dt = compute_dtype(cfg)
    return {k: v if k == "final_norm" else _cast_fp32(v, dt)
            for k, v in params.items()}


def cast_block_params(bp, cfg):
    """The block's fp32 master params cast to the compute dtype once, as
    the reference does (the norms' gammas included, so a block norm scales
    by ``1 + bf16(gamma)``; and an RWKV block's ``decay_base``, ``bonus``,
    ``mu_*`` and ``ln_g``/``ln_b``, which the time-mix widens back to
    fp32 or mixes with fp32 values); no-op for fp32 compute."""
    dt = compute_dtype(cfg)
    if dt == torch.float32:
        return bp
    return _cast_fp32(bp, dt)


def block_forward(bp, cfg, kind: str, x: torch.Tensor, *,
                  positions=None, lengths=None, mask_fn=None,
                  collect_cache: bool = False, cache_len: int = 0):
    """-> (x, the layer's MoE aux (None for a layer without experts), the
    layer's prefill cache entry when ``collect_cache``, else None).
    ``lengths`` (B,) (with ``positions``, -1 on pads) are the rows' live
    lengths a recurrent block takes its state at; None: every row is
    live.  ``mask_fn`` overrides an attention layer's mask (the VLM's
    prefix-LM mask)."""
    bp = cast_block_params(bp, cfg)
    aux = None
    entry = None
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    if kind == BLOCK_RWKV:
        y, (S_, x_tmix) = rwkv_mod.tmix_forward(bp["tmix"], cfg, h,
                                                lengths=lengths)
        x = x + y
        h2 = rms_norm(x, bp["ln2"], cfg.norm_eps)
        y2, x_cmix = rwkv_mod.cmix_forward(bp["cmix"], h2, lengths=lengths)
        if collect_cache:
            entry = {"S": S_, "x_tmix": x_tmix, "x_cmix": x_cmix}
        return x + y2, aux, entry
    if kind == BLOCK_REC:
        y, state = rglru_mod.rglru_forward(bp["rec"], cfg, h,
                                           lengths=lengths)
        if collect_cache:
            entry = state
    else:
        y, kv = attn.attn_forward(bp["attn"], cfg, h, kind=kind,
                                  mask_fn=mask_fn, q_positions=positions,
                                  kv_positions=positions)
        if collect_cache:
            # the forward's own k/v: the values the reference recomputes
            cache = attn.init_kv_cache(cfg, x.shape[0], cache_len,
                                       kind == "local", compute_dtype(cfg),
                                       x.device)
            entry = attn.cache_prefill(cache, *kv)
    x = x + y
    h2 = rms_norm(x, bp["ln2"], cfg.norm_eps)
    if "moe" in bp:
        y2, aux = moe_mod.moe_forward(bp["moe"], cfg, h2)
    else:
        y2 = ffn_mod.ffn_forward(bp["mlp"], h2, cfg.ffn_type)
    return x + y2, aux, entry


def _write(entry: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
           live=None) -> None:
    """Write a recurrent entry's update in place, cast to each leaf's
    dtype; rows where ``live`` (B,) is False keep their bits."""
    for name, val in new.items():
        buf = entry[name]
        val = val.to(buf.dtype)
        if live is not None:
            keep = live.reshape((-1,) + (1,) * (val.dim() - 1))
            val = torch.where(keep, val, buf)
        buf.copy_(val)


def block_decode(bp, cfg, kind: str, x_t: torch.Tensor, entry, live=None,
                 mask_fn=None):
    """One token through a block -> x_t; the layer's cache ``entry`` is
    written in place (rows where ``live`` is False are not); ``mask_fn``
    overrides an attention layer's mask."""
    bp = cast_block_params(bp, cfg)
    h = rms_norm(x_t, bp["ln1"], cfg.norm_eps)
    if kind == BLOCK_RWKV:
        y, (S_, x_tmix) = rwkv_mod.tmix_forward(
            bp["tmix"], cfg, h, state0=entry["S"], x_prev=entry["x_tmix"])
        x_t = x_t + y
        h2 = rms_norm(x_t, bp["ln2"], cfg.norm_eps)
        y2, x_cmix = rwkv_mod.cmix_forward(bp["cmix"], h2,
                                           x_prev=entry["x_cmix"])
        _write(entry, {"S": S_, "x_tmix": x_tmix, "x_cmix": x_cmix}, live)
        return x_t + y2
    if kind == BLOCK_REC:
        y, state = rglru_mod.rglru_forward(bp["rec"], cfg, h, state=entry)
        _write(entry, state, live)
    else:
        y = attn.attn_decode(bp["attn"], cfg, h, entry, kind=kind,
                             mask_fn=mask_fn, live=live)
    x_t = x_t + y
    h2 = rms_norm(x_t, bp["ln2"], cfg.norm_eps)
    if "moe" in bp:
        # the no-drop capacity: a decode step drops no token (M4)
        return x_t + moe_mod.moe_forward(bp["moe"], cfg, h2, decode=True)[0]
    return x_t + ffn_mod.ffn_forward(bp["mlp"], h2, cfg.ffn_type)


def embed_tokens(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """The token rows of ``embed.w``, gathered by ``F.embedding``: its
    backward sums a token's rows in a fixed order on the CPU whatever the
    intra-op threads, where indexing's backward (``index_put_``) does not
    (F5).  A unit of its own on a mesh (``sharding/fsdp.py``)."""
    x = fsdp.run_unit(lambda e, t: F.embedding(t.long(), e["w"]),
                      params["embed"], tokens).to(compute_dtype(cfg))
    if cfg.embed_scale:
        x = x * torch.sqrt(torch.tensor(float(cfg.d_model))).to(x.dtype)
    return x


def head_weight(params, cfg) -> torch.Tensor:
    """(d, V) LM head; a tied head is ``embed.w`` viewed transposed.
    Gathered whole from a mesh's shards (``sharding/fsdp.py``)."""
    return (fsdp.gather(params["embed"]["w"]).t() if cfg.tie_embeddings
            else fsdp.gather(params["lm_head"]["w"]))


def unembed(params, cfg, x: torch.Tensor) -> torch.Tensor:
    """The logits; the head is a unit of its own on a mesh."""
    head = ({"embed": params["embed"]} if cfg.tie_embeddings
            else {"lm_head": params["lm_head"]})
    return fsdp.run_unit(lambda p, h: h @ head_weight(p, cfg).to(h.dtype),
                         head, x)


def _unstack(tree: Any, n: int, dim: int = 0) -> List[Any]:
    """A dict of leaves stacked on axis ``dim`` of size ``n`` -> ``n``
    per-layer dicts of views (``unbind``): writes into a view land in
    the stacked leaf."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n, dim) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return fsdp.unbind(tree, dim)


def _stack(entries: List[Any]) -> Any:
    """Per-layer cache entries -> one entry stacked on axis 1 (after the
    batch)."""
    return tree_map(lambda *xs: torch.stack(xs, dim=1), *entries)


def forward_hidden(params, cfg, x: torch.Tensor, *, positions=None,
                   mask_fn=None, remat: bool = True,
                   collect_cache: bool = False, cache_len: int = 0):
    """Runs the stack on embedded input ``x`` (B,S,d) -> (the final-normed
    hidden states (B,S,d), the MoE aux summed over the layers (an fp32
    scalar; zero without MoE layers), the decode cache when
    ``collect_cache``, else None).  ``positions`` (B,S) default to
    ``arange(S)``; given, each row's live length (its positions >= 0) is
    where the recurrent blocks take their state.  ``mask_fn`` overrides
    the attention layers' masks (the VLM's prefix-LM mask).

    ``remat`` (the reference's default) checkpoints each group of
    ``pattern`` layers when autograd records the forward: only the
    group's input is kept, and the backward runs the group's forward
    again (``torch.utils.checkpoint``, non-reentrant) before its
    backward.  No block draws random numbers, so no generator state is
    stashed (a stash would read it inside a CUDA-graph capture), and the
    recompute is bitwise the first forward: loss and gradients are
    bitwise those without remat.  The tail layers are not checkpointed,
    as in the reference; a prefill (``collect_cache``) or a forward
    without grad runs plain.

    On a mesh's shards (``sharding/fsdp.py``) each group and each tail
    layer is a unit: its weights are gathered inside its region, so the
    recompute gathers them again and one group is whole at a time; with
    autograd recording every unit is then a checkpoint region."""
    pattern = cfg.pattern
    n_groups = cfg.n_layers // len(pattern)
    lengths = None if positions is None else (positions >= 0).sum(dim=1)
    kw = dict(positions=positions, lengths=lengths, mask_fn=mask_fn,
              collect_cache=collect_cache, cache_len=cache_len)
    remat = remat and not collect_cache and torch.is_grad_enabled()
    entries = [[] for _ in pattern]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def run_group(x, group):
        """One group's layers -> (x, the group's aux sum or None, each
        layer's cache entry)."""
        auxes, ces = [], []
        for bp, kind in zip(group, pattern):
            x, aux, ce = block_forward(bp, cfg, kind, x, **kw)
            auxes.append(aux)
            ces.append(ce)
        aux_g = torch.stack(auxes).sum() if cfg.moe is not None else None
        return x, aux_g, ces

    if n_groups:
        layers = [_unstack(gp, n_groups) for gp in params["stack"]["groups"]]
        # the reference sums each group's auxes, then the groups' sums
        group_aux = []
        for g in range(n_groups):
            group = [layers[pos][g] for pos in range(len(pattern))]
            x, aux_g, ces = fsdp.run_unit(lambda gr, xx: run_group(xx, gr),
                                          group, x, remat=remat)
            for pos, ce in enumerate(ces):
                entries[pos].append(ce)
            if aux_g is not None:
                group_aux.append(aux_g)
        if group_aux:
            aux_total = aux_total + torch.stack(group_aux).sum()
    kinds = cfg.layer_kinds()
    tail = []
    for i, bp in enumerate(params["stack"]["tail"]):
        kind = kinds[n_groups * len(pattern) + i]
        x, aux, ce = fsdp.run_unit(
            lambda p, xx, k=kind: block_forward(p, cfg, k, xx, **kw), bp, x)

        if aux is not None:
            aux_total = aux_total + aux
        tail.append(ce)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if not collect_cache:
        return h, aux_total, None
    groups = tuple(_stack(e) for e in entries) if n_groups else tuple()
    return h, aux_total, {"groups": groups, "tail": tuple(tail)}


def init_cache(cfg, batch: int, cache_len: int, dtype=None,
               device=torch.device("cpu")):
    """Empty decode cache of ``forward_hidden``'s structure: KV caches in
    ``dtype`` (default the compute dtype), recurrent state in fp32."""
    dtype = compute_dtype(cfg) if dtype is None else dtype
    pattern = cfg.pattern
    n_groups = cfg.n_layers // len(pattern)
    kinds = cfg.layer_kinds()

    def one(kind):
        if kind == BLOCK_REC:
            return rglru_mod.init_rglru_state(
                batch, cfg.lru_width or cfg.d_model, cfg.conv_width, device)
        if kind == BLOCK_RWKV:
            f32 = dict(dtype=torch.float32, device=device)
            H, N = cfg.n_heads, cfg.rwkv_head_dim
            return {"S": torch.zeros((batch, H, N, N), **f32),
                    "x_tmix": torch.zeros((batch, cfg.d_model), **f32),
                    "x_cmix": torch.zeros((batch, cfg.d_model), **f32)}
        return attn.init_kv_cache(cfg, batch, cache_len, kind == "local",
                                  dtype, device)

    groups = tuple(_stack([one(kind)] * n_groups)
                   for kind in pattern) if n_groups else tuple()
    tail = tuple(one(kinds[n_groups * len(pattern) + i])
                 for i in range(cfg.n_layers - n_groups * len(pattern)))
    return {"groups": groups, "tail": tail}


def decode_step(params, cfg, x_t: torch.Tensor, cache, live=None,
                mask_fn=None):
    """x_t: (B,1,d) embedded tokens, row b at position ``t[b]`` -> the
    final-normed hidden (B,1,d).  Every layer's cache is written in place
    (a group leaf through its per-layer views); rows where ``live`` (B,)
    is False keep their cache bit-exactly; ``mask_fn`` overrides the
    attention layers' masks."""
    pattern = cfg.pattern
    n_groups = cfg.n_layers // len(pattern)
    kinds = cfg.layer_kinds()
    if n_groups:
        layers = [_unstack(gp, n_groups) for gp in params["stack"]["groups"]]
        caches = [_unstack(gc, n_groups, dim=1) for gc in cache["groups"]]
        for g in range(n_groups):
            for pos, kind in enumerate(pattern):
                x_t = block_decode(layers[pos][g], cfg, kind, x_t,
                                   caches[pos][g], live, mask_fn)
    for i, bp in enumerate(params["stack"]["tail"]):
        kind = kinds[n_groups * len(pattern) + i]
        x_t = block_decode(bp, cfg, kind, x_t, cache["tail"][i], live,
                           mask_fn)
    return rms_norm(x_t, params["final_norm"], cfg.norm_eps)
