"""Initializers, shared numerics and params-tree helpers of the port.

``dense_init``/``embed_init`` are the reference's (``models/common.py``)
with a ``torch.Generator`` in place of a ``jax.random`` key.  Draws
happen on the generator's device and the result is moved to the target
device: a CPU generator gives the same parameters on the CPU and on the
card, a card generator draws on the card (another stream of numbers,
and no host work for a model of billions of parameters).
Params are trees of tensors (dicts, and tuples for the LM stack) with the
reference's key layout and (in, out) weight layout.  A leaf's key is its
path as ``jax.tree_util.keystr`` prints it (:func:`keystr`), and trees
flatten in JAX's order (dict keys sorted).

``rms_norm``, ``rope_freqs``, ``apply_rope``, ``ffn_act`` and
``sigmoid`` repeat the reference's numerics: the norm in fp32 with a ``(1 + gamma)`` scale, cast
back; half-split (not interleaved) RoPE with fp32 frequencies (exactly
rounded, as the reference's jitted code folds them) and fp32 positions;
GELU in its tanh form, which is ``jax.nn.gelu``'s default (torch's
default is the erf form), written op by op as JAX writes it; and the
logistic as JAX evaluates it.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Tuple

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               device: torch.device, scale: float = 1.0) -> torch.Tensor:
    std = scale / math.sqrt(d_in)
    return (torch.randn((d_in, d_out), generator=gen, device=gen.device)
            * std).to(device)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               device: torch.device) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen,
                       device=gen.device).to(device)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a tree of dicts, tuples and lists in JAX's flatten order
    (dict keys sorted, sequences in order)."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [l for t in tree for l in tree_leaves(t)]
    return [tree]


def tree_unflatten(template, leaves):
    """A tree of ``template``'s structure whose leaves are ``leaves``, in
    ``tree_leaves`` order (dict keys sorted; each dict keeps its keys'
    order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            done = {k: build(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(template)


def keystr(path: Tuple) -> str:
    """A leaf's key: ``[{key!r}]`` for a dict key, ``[i]`` for a sequence
    index, as ``jax.tree_util.keystr`` writes them."""
    return "".join(f"[{k!r}]" for k in path)


def flatten_with_path(tree, path: Tuple = ()) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs of a tree of dicts, tuples and lists, in JAX's
    flatten order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, t in enumerate(tree)
                for kv in flatten_with_path(t, path + (i,))]
    return [(keystr(path), tree)]


def map_with_path(fn: Callable[[str, Any], Any], tree, path: Tuple = ()):
    """``tree`` with each leaf replaced by ``fn(key, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(keystr(path), tree)


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + gamma.to(torch.float32))).to(dt)


def rope_freqs(head_dim: int, theta: float,
               device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """``1 / theta**(2i/hd)`` rounded once to fp32, as the reference's
    compiled code has them (XLA folds the constant exactly rounded; an
    fp32 ``pow`` is an ulp off in about a third of the entries, which
    moves a rotation by ~1e-4 at positions in the thousands)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float64,  # repro_torch: noqa[dtype-widen] -- S9: the RoPE frequencies rounded once to fp32, as XLA folds them
                        device=device) / head_dim
    return (1.0 / (float(theta) ** exps)).to(torch.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S)."""
    dt = x.dtype
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    sin = torch.sin(angles)[..., None, :]                    # (..., S, 1, hd/2)
    cos = torch.cos(angles)[..., None, :]
    x32 = x.to(torch.float32)
    x1, x2 = x32[..., : hd // 2], x32[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s tanh form as the reference computes it: op by op
    in x's dtype, its constants rounded to that dtype.  At bf16 each op
    rounds, where torch's fused ``F.gelu`` rounds once: that differed
    from the reference in ~40% of bf16 outputs (queue 3, F4).  The
    constants are filled on x's device (no host copy, which a captured
    CUDA graph cannot hold)."""
    c = torch.full((), math.sqrt(2.0 / math.pi), dtype=x.dtype,
                   device=x.device)
    k = torch.full((), 0.044715, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * x ** 3))))


def ffn_act(ffn_type: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {"swiglu": F.silu, "geglu": _gelu_tanh, "gelu": _gelu_tanh,
            "sq_relu": lambda x: torch.square(F.relu(x))}[ffn_type]


class _Sigmoid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1 - s))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` with its rounding in x's dtype: ``1 / (1 +
    exp(-x))`` rounded after each op, with the gradient ``g * (s * (1 -
    s))``.  In bf16, ``torch.sigmoid`` (one rounding) differs from it by
    one ulp in about a third of the entries; in fp32 the two agree to
    within an ulp."""
    return _Sigmoid.apply(x)


def compute_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)
