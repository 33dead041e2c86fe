"""Top-k Mixture-of-Experts with GShard-style capacity dispatch (the
reference's ``models/moe.py``).

Tokens are taken in groups of ``g = min(group_size, B*S)`` consecutive
tokens in row-major (B, S) order (ROADMAP MoE hazard M1: an example's
routing depends on the other examples of its group); per group, each
expert accepts up to ``capacity = max(1, int(cf * g * top_k / E))``
tokens.  Dispatch, the experts and the combine are the reference's
one-hot einsums, as plain products: a token's slot is selected by a
one-hot row, which is exact, and nothing scatters or accumulates
atomically (the one-hots are comparisons with an ``arange``, a token's
gate is picked by a one-hot product, not a gather whose backward would
scatter), so two runs of one input agree bit for bit on the card.

Router: softmax over every expert in fp32, then ``top_k`` rounds of
argmax over the gates not yet taken (a tie takes the first index), with
the experts' fill carried across rounds in int32 (M2), then the combine
renormalized over the experts that kept the token (M3).  The
load-balance aux is the Switch Transformer's [arXiv:2101.03961] (M5).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.models.common import dense_init, ffn_act
from repro_torch.models.ffn import is_gated

DEFAULT_GROUP = 2048


def _stacked_init(gen: torch.Generator, n: int, d_in: int, d_out: int,
                  device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``n`` ``dense_init`` draws stacked, (n, d_in, d_out), cast to
    ``dtype`` as soon as drawn."""
    w = torch.randn((n, d_in, d_out), generator=gen, device=gen.device)
    return w.mul_(1.0 / math.sqrt(d_in)).to(device=device, dtype=dtype)


def init_moe_params(gen: torch.Generator, d_model: int, moe_cfg,
                    ffn_type: str, device: torch.device,
                    dtype: torch.dtype = torch.float32) -> Dict:
    """The reference's leaves and shapes: ``router`` (d, E), ``w_in``
    and ``w_gate`` (E, d, d_ff_expert), ``w_out`` (E, d_ff_expert, d),
    drawn as ``router``, ``w_in``, ``w_out``, ``w_gate`` (the dense
    FFN's order after the router).  ``dtype`` is the storage
    of the expert weights, each cast as soon as it is drawn (the peak is
    one fp32 expert stack, not the layer)."""
    E, dff = moe_cfg.n_experts, moe_cfg.d_ff_expert
    p = {"router": dense_init(gen, d_model, E, device).to(dtype),
         "w_in": _stacked_init(gen, E, d_model, dff, device, dtype),
         "w_out": _stacked_init(gen, E, dff, d_model, device, dtype)}
    if is_gated(ffn_type):
        p["w_gate"] = _stacked_init(gen, E, d_model, dff, device, dtype)
    return p


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _topk_dispatch(gates: torch.Tensor, top_k: int, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """gates (G, S, E) softmax probabilities -> (dispatch (G, S, E, C) in
    gates' dtype, combine (G, S, E, C) weights in gates' dtype).

    Each of ``top_k`` rounds takes every token's largest remaining gate
    (the first index on a tie, as ``jnp.argmax``); its position in the
    expert is the expert's fill from earlier rounds plus an int32 cumsum
    over the group (M2: a float cumsum in bf16 loses exactness past 256
    tokens).  A token whose position overflows the capacity is dropped
    from that expert and its combine weights renormalize over the
    experts that kept it, in fp32, cast back at the end (M3).

    The reference adds each round's (G, S, E, C) one-hot (and its gate
    times it) into the result.  A token takes an expert in one round at
    most, so each (token, expert) has one slot or none: here the rounds
    carry that slot and the kept gate, (G, S, E) each, and the (G, S, E,
    C) tensors are formed once.  Every entry is the same value (a sum
    with one non-zero term), with one saved (G, S, E, C) tensor for the
    backward instead of one a round.  This holds while a token has
    ``top_k`` gates above zero; only a softmax that underflows (logits
    ~100 apart in fp32) would let argmax pick a taken expert again, where
    the reference gives it a second, zero-weight slot."""
    G, S, E = gates.shape
    dt, dev = gates.dtype, gates.device
    remaining = gates.to(torch.float32)
    counts = torch.zeros((G, E), dtype=torch.int32, device=dev)
    slot = torch.full((G, S, E), capacity, dtype=torch.int32, device=dev)
    kept_gate = torch.zeros((G, S, E), dtype=torch.float32, device=dev)
    topk_sum = torch.zeros((G, S), dtype=torch.float32, device=dev)
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)                     # (G,S)
        onehot_i = _one_hot(idx, E, torch.int32)                  # (G,S,E)
        onehot_f = onehot_i.to(torch.float32)
        # the chosen gate: one non-zero term, so the sum is exact
        w = torch.sum(remaining * onehot_f, dim=-1)
        pos = (counts[:, None, :] + torch.cumsum(onehot_i, dim=1,
                                                 dtype=torch.int32) - 1)
        pos_in_e = torch.sum(pos * onehot_i, dim=-1, dtype=torch.int32)
        keep = pos_in_e < capacity
        # a dropped token keeps the out-of-range slot `capacity`, whose
        # one-hot row is all zeros: no slot
        slot = torch.where((onehot_i > 0) & keep[..., None],
                           pos_in_e[..., None], slot)
        kept_f = keep.to(torch.float32)
        kept_gate = kept_gate + onehot_f * (w * kept_f)[..., None]
        topk_sum = topk_sum + w * kept_f
        counts = counts + torch.sum(onehot_i * keep[..., None].to(
            torch.int32), dim=1, dtype=torch.int32)
        remaining = remaining * (1.0 - onehot_f)
    dispatch = _one_hot(slot, capacity, dt)                       # (G,S,E,C)
    # renormalize the combine weights over the kept assignments
    combine = (dispatch.to(torch.float32) * kept_gate[..., None]) \
        / torch.clamp(topk_sum, min=1e-9)[..., None, None]
    return dispatch, combine.to(dt)


def moe_forward(params, cfg, x: torch.Tensor, group_size: int = DEFAULT_GROUP,
                decode: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), the load-balance aux times
    ``router_aux_coef``, an fp32 scalar).  ``decode`` uses the no-drop
    capacity g (the group), where a prefill or a training step drops at
    the training capacity (M4)."""
    moe = cfg.moe
    B, S, d = x.shape
    dt = x.dtype
    tokens = B * S
    g = min(group_size, tokens)
    n_groups = tokens // g
    if n_groups * g != tokens:
        raise ValueError(
            f"MoE groups (ROADMAP MoE hazard M1): {tokens} tokens (B {B} x "
            f"S {S}) do not split into groups of {g}; the reference "
            f"asserts the same")
    xg = x.reshape(n_groups, g, d)
    logits = (xg @ params["router"].to(dt)).to(torch.float32)
    gates = torch.softmax(logits, dim=-1)                         # (G,S,E)
    capacity = (g if decode else
                max(1, int(moe.capacity_factor * g * moe.top_k
                           / moe.n_experts)))
    dispatch, combine = _topk_dispatch(gates.to(dt), moe.top_k, capacity)

    expert_in = torch.einsum("gsec,gsd->egcd", dispatch, xg)
    h = torch.einsum("egcd,edf->egcf", expert_in, params["w_in"].to(dt))
    act = ffn_act(cfg.ffn_type)
    if "w_gate" in params:
        gt = torch.einsum("egcd,edf->egcf", expert_in,
                          params["w_gate"].to(dt))
        h = act(gt) * h
    else:
        h = act(h)
    out_e = torch.einsum("egcf,efd->egcd", h, params["w_out"].to(dt))
    out = torch.einsum("gsec,egcd->gsd", combine, out_e)

    # Switch-style load balancing (M5): the fraction of each group's
    # tokens kept by each expert (the reference's bf16-rounded mean of a
    # bf16 dispatch, summed in fp32) against the mean fp32 gate
    density = dispatch.sum(dim=-1).to(torch.float32).mean(dim=1).to(dt)
    router_prob = gates.mean(dim=1)                               # (G,E)
    aux = moe.n_experts * torch.mean(
        torch.sum(density.to(torch.float32) * router_prob, dim=-1))
    return out.reshape(B, S, d), aux * moe.router_aux_coef
