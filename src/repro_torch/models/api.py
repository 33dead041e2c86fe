"""Model bundles of the port: the RNN-T family (the reference's
``models/api.py:_build_rnnt``), decoder LMs (``_build_lm``: dense and
MoE attention stacks, RWKV6 stacks, the RG-LRU hybrid, and the VLM, an
attention stack behind a prefix of patch embeddings under the prefix-LM
mask) and the encoder-decoder (``_build_encdec``).

A bundle is the surface the trainer and the PGM core build on:
``init_params``, the per-example loss, the weighted training loss and the
last-layer head; the LM bundle also has ``final_hidden``, the hook of LM
stage A.  An MoE stack's load-balance aux joins the training loss
(``loss_fn``: the weighted task loss plus the aux, not weighted), as the
reference's does; ``per_example_loss`` and ``final_hidden`` drop it.
Both carry the serving hooks (``prefill``, ``decode``, ``init_cache``)
the engines of ``serve/engine.py`` drive: for an LM, a
prompt prefill into per-layer caches (KV caches, and the recurrent state
of RG-LRU and RWKV6 layers) and one-token decode; for the
RNN-T, streaming greedy transducer search (the encoder runs once at
prefill, a decode is one joint step).  Batches are dicts of tensors on
the params' device with the reference's keys (RNN-T: ``feats``,
``feat_lens``, ``tokens``, ``token_lens``, ``weights``; LM: ``tokens``,
``loss_mask``, ``weights``, and for a VLM ``patches`` (B, P, d); the
encoder-decoder: ``frames`` (B, T_src, d), ``tokens``, ``loss_mask``,
``weights``).  The LM and encoder-decoder bundles' ``make_batch`` draws
one batch of the reference's keys, shapes and dtypes from a
``torch.Generator``.

The VLM (V1, V2): patches are cast to the compute dtype, unscaled, and
put before the embedded text; positions run on from the patches into
the text; every attention layer takes ``prefix_lm_mask(P)``; the text's
hidden states are ``h[:, P:P+S-1]``.  The encoder-decoder (ED1-ED4,
``models/encdec.py``): the decoder reads ``tokens[:, :-1]`` against
``tokens[:, 1:]`` and cross-attends to the encoded ``frames``; its
loss has no aux.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import (ATTN_KINDS, BLOCK_ATTN, BLOCK_GLOBAL,
                                      BLOCK_LOCAL, BLOCK_REC, BLOCK_RWKV,
                                      ModelConfig)
from repro_torch.core.rnnt_loss import (rnnt_loss_from_logits,
                                        rnnt_loss_fused)
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import rnnt as rnnt_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import prefix_lm_mask

Batch = Dict[str, torch.Tensor]


def _weighted(per_ex: torch.Tensor, batch: Batch, aux=None
              ) -> Tuple[torch.Tensor, Dict]:
    """Weighted mean of the per-example losses plus ``aux`` (the MoE
    load-balance aux, unweighted; zero when None); a batch without
    ``weights`` counts every example once."""
    w = batch.get("weights")
    w = (torch.ones_like(per_ex) if w is None else w.to(torch.float32))
    loss = torch.sum(per_ex * w) / torch.clamp(torch.sum(w), min=1e-9)
    if aux is None:
        aux = torch.zeros((), device=per_ex.device)
    total = loss + aux
    return total, {"loss": loss, "aux_loss": aux, "total_loss": total}


@dataclasses.dataclass(frozen=True)
class RNNTBundle:
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.family != "rnnt" or self.cfg.rnnt is None:
            raise ValueError(f"{self.cfg.name}: the port carries the rnnt "
                             f"family only")
        if self.cfg.rnnt.loss_impl not in ("fused", "dense"):
            raise ValueError(f"rnnt.loss_impl must be 'fused' or 'dense', "
                             f"got {self.cfg.rnnt.loss_impl!r}")

    def init_params(self, gen: torch.Generator, device: torch.device):
        return rnnt_mod.init_params(self.cfg, gen, device)

    def t_lens(self, batch: Batch) -> torch.Tensor:
        """Encoder frames per example: ``max(feat_lens // 4, 1)``."""
        return torch.clamp(batch["feat_lens"].long()
                           // self.cfg.rnnt.time_reduction, min=1)

    def per_example_nll(self, params, batch: Batch) -> torch.Tensor:
        """Per-example transducer NLL by ``rnnt.loss_impl``: ``fused``
        runs the lattice kernels over the joint factors with an analytic
        backward; ``dense`` materializes the (B,T',U+1,V) logits and
        differentiates the dense oracle by autograd (no kernel, as in the
        reference)."""
        if self.cfg.rnnt.loss_impl == "fused":
            ze, zp = rnnt_mod.joint_factors(params, self.cfg, batch["feats"],
                                            batch["tokens"])
            return rnnt_loss_fused(ze, zp, params["joint"]["w_out"],
                                   batch["tokens"], self.t_lens(batch),
                                   batch["token_lens"],
                                   vocab_chunk=self.cfg.rnnt.loss_vocab_chunk)
        logits = rnnt_mod.forward(params, self.cfg, batch["feats"],
                                  batch["tokens"])
        return rnnt_loss_from_logits(logits, batch["tokens"],
                                     self.t_lens(batch), batch["token_lens"])

    def per_example_loss(self, params, batch: Batch) -> torch.Tensor:
        return self.per_example_nll(params, batch) / torch.clamp(
            batch["token_lens"].to(torch.float32), min=1.0)

    def loss_fn(self, params, batch: Batch) -> Tuple[torch.Tensor, Dict]:
        return _weighted(self.per_example_loss(params, batch), batch)

    def head_weight(self, params) -> torch.Tensor:
        return params["joint"]["w_out"]

    def serving_params(self, params):
        """The RNN-T computes in fp32 from its masters: served as they
        are."""
        return params

    # -- streaming greedy transducer search (the reference's rnnt serve
    # hooks): the cache is one utterance's decode state -- the encoder
    # output, the frame cursor and limit, the prediction-net state and
    # the symbols emitted at the current frame.  A blank advances the
    # frame; once ``max_syms`` symbols were emitted at a frame the logits
    # are forced to blank, where the non-streaming search breaks its loop.

    def prefill(self, params, batch: Batch, cache_len=None,
                max_symbols: int = 8):
        """Encode ``feats`` (B,T,F) once -> (the joint logits at frame 0
        from the blank-start state (B,V), the decode cache)."""
        enc = rnnt_mod.encode(params, self.cfg, batch["feats"])
        B, T_enc, _ = enc.shape
        dev = enc.device
        t_len = torch.clamp(self.t_lens(batch), max=T_enc).to(torch.int32)
        g, h = rnnt_mod.pred_start(params, self.cfg, B, enc.dtype, dev)
        logits = rnnt_mod.joint_step(params, enc[:, 0], g)
        cache = {"enc": enc,
                 "t": torch.zeros((B,), dtype=torch.int32, device=dev),
                 "t_len": t_len, "g": g, "h": h,
                 "syms": torch.zeros((B,), dtype=torch.int32, device=dev),
                 "max_syms": torch.full((B,), max_symbols,
                                        dtype=torch.int32, device=dev)}
        return logits, cache

    def decode(self, params, cache, tokens: torch.Tensor, live=None):
        """One joint step: tokens (B,) the symbols sampled from the last
        logits -> (next logits (B,V), new cache).  Rows where ``live``
        (B,) is False keep their state bit-exactly (the encoder buffer is
        shared, not copied)."""
        blank = tokens == rnnt_mod.BLANK_ID
        g_new, h_new = rnnt_mod.pred_step(params, self.cfg, tokens,
                                          cache["h"])
        state = {"g": torch.where(blank[:, None], cache["g"], g_new),
                 "h": torch.where(blank[:, None], cache["h"], h_new),
                 "t": cache["t"] + blank.to(torch.int32),
                 "syms": torch.where(blank, torch.zeros_like(cache["syms"]),
                                     cache["syms"] + 1)}
        if live is not None:
            state = {k: torch.where(live.reshape((-1,) + (1,) * (x.dim() - 1)),
                                    x, cache[k]) for k, x in state.items()}
        t, g, syms = state["t"], state["g"], state["syms"]
        T_enc = cache["enc"].shape[1]
        t_idx = torch.clamp(t, 0, T_enc - 1).long()
        enc_t = cache["enc"][torch.arange(t.shape[0], device=t.device),
                             t_idx]
        logits = rnnt_mod.joint_step(params, enc_t, g)
        forced = torch.full_like(logits, -1e30)
        forced[:, rnnt_mod.BLANK_ID] = 0.0
        logits = torch.where((syms >= cache["max_syms"])[:, None], forced,
                             logits)
        return logits, dict(cache, **state)

    def init_cache(self, batch_size: int, cache_len: int, dtype=None,
                   max_symbols: int = 8, device=torch.device("cpu")):
        """Empty decode state; ``cache_len`` is the encoder-frame
        capacity (audio frames // time_reduction)."""
        r = self.cfg.rnnt
        dtype = torch.float32 if dtype is None else dtype
        z = dict(dtype=torch.int32, device=device)
        return {"enc": torch.zeros((batch_size, cache_len, r.dnn_dim),
                                   dtype=dtype, device=device),
                "t": torch.zeros((batch_size,), **z),
                "t_len": torch.zeros((batch_size,), **z),
                "g": torch.zeros((batch_size, r.pred_hidden), dtype=dtype,
                                 device=device),
                "h": torch.zeros((batch_size, r.pred_hidden), dtype=dtype,
                                 device=device),
                "syms": torch.zeros((batch_size,), **z),
                "max_syms": torch.full((batch_size,), max_symbols, **z)}


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Per-example mean cross-entropy in fp32: logits (B,S,V), targets
    (B,S), mask (B,S) -> (B,).  The gold logit is gathered; the
    reference contracts a one-hot, which selects the same value."""
    lv = logits.to(torch.float32)
    logz = torch.logsumexp(lv, dim=-1)
    gold = torch.gather(lv, -1, targets.long()[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum(dim=-1) / torch.clamp(mask.sum(dim=-1), min=1.0)


def _refuse_unported(cfg: ModelConfig) -> None:
    why = _unported(cfg)
    if why:
        raise NotImplementedError(
            f"{cfg.name}: {why} is not ported (ROADMAP.md queue 1, item 9: "
            f"the block kinds each family carries)")


def _tokens_batch(gen: torch.Generator, B: int, S: int, vocab: int):
    """The reference's text keys: tokens (B,S) int32 uniform over the
    vocab, an all-ones loss mask (B,S) and weights (B,), fp32."""
    dev = gen.device
    return {"tokens": torch.randint(0, vocab, (B, S), generator=gen,
                                    device=dev, dtype=torch.int32),
            "loss_mask": torch.ones((B, S), dtype=torch.float32,
                                    device=dev),
            "weights": torch.ones((B,), dtype=torch.float32, device=dev)}


@dataclasses.dataclass(frozen=True)
class LMBundle:
    """Decoder LM (dense or MoE attention stack, RWKV6 stack, the RG-LRU
    hybrid, or a VLM's text stack behind its patch prefix): text position
    i predicts token i+1."""

    cfg: ModelConfig

    def __post_init__(self):
        _refuse_unported(self.cfg)
        if self.cfg.family == "vlm" and self.cfg.n_prefix < 1:
            raise ValueError(f"{self.cfg.name}: the 'vlm' family needs "
                             f"cfg.n_prefix >= 1")

    @property
    def n_prefix(self) -> int:
        """Frontend positions before the text (a VLM's patches), else 0."""
        return self.cfg.n_prefix if self.cfg.family == "vlm" else 0

    @property
    def mask_fn(self):
        """The VLM's prefix-LM mask (V2); None: each layer's own."""
        return prefix_lm_mask(self.n_prefix) if self.n_prefix else None

    def init_params(self, gen: torch.Generator, device: torch.device,
                    dtype=None):
        """fp32 masters, or with ``dtype`` the compute dtype the serving
        weights (``transformer.init_params``)."""
        return tfm.init_params(self.cfg, gen, device, dtype)

    def serving_params(self, params):
        """The serving weights of fp32 masters: each leaf the forward
        casts, cast once (``transformer.serving_params``); training
        refuses them."""
        return tfm.serving_params(params, self.cfg)

    def embed(self, params, batch: Batch) -> torch.Tensor:
        """The stack's input: the embedded tokens, behind a VLM's patches
        cast to the compute dtype (V1) -> (B, P+S, d)."""
        x = tfm.embed_tokens(params, self.cfg, batch["tokens"])
        if self.n_prefix:
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        return x

    def assemble(self, params, batch: Batch):
        """-> (the stack's input (B,P+S,d), targets (B,S-1), mask
        (B,S-1))."""
        tokens = batch["tokens"]
        x = self.embed(params, batch)
        targets = tokens[:, 1:]
        mask = batch.get("loss_mask")
        mask = (torch.ones(targets.shape, dtype=torch.float32,
                           device=tokens.device) if mask is None
                else mask[:, 1:].to(torch.float32))
        return x, targets, mask

    def _hidden(self, params, batch: Batch, remat: bool = True):
        """-> (hidden states aligned with the next-token targets, targets,
        mask, the stack's MoE aux); ``remat`` as ``forward_hidden``'s."""
        x, targets, mask = self.assemble(params, batch)
        h, aux, _ = tfm.forward_hidden(params, self.cfg, x,
                                       mask_fn=self.mask_fn, remat=remat)
        P, S = self.n_prefix, batch["tokens"].shape[1]
        return h[:, P:P + S - 1], targets, mask, aux

    def final_hidden(self, params, batch: Batch, remat: bool = True):
        """-> (hidden states aligned with the next-token targets
        (B,S-1,d) in the compute dtype, targets, mask); the MoE aux is
        dropped."""
        return self._hidden(params, batch, remat)[:3]

    def per_example_loss(self, params, batch: Batch,
                         remat: bool = True) -> torch.Tensor:
        h, targets, mask = self.final_hidden(params, batch, remat)
        return softmax_xent(tfm.unembed(params, self.cfg, h), targets, mask)

    def loss_fn(self, params, batch: Batch,
                remat: bool = True) -> Tuple[torch.Tensor, Dict]:
        """(weighted task loss + the stack's MoE aux, metrics ``loss``,
        ``aux_loss``, ``total_loss``); ``remat`` (the reference's
        default) checkpoints each layer group when autograd records."""
        h, targets, mask, aux = self._hidden(params, batch, remat)
        per_ex = softmax_xent(tfm.unembed(params, self.cfg, h), targets, mask)
        return _weighted(per_ex, batch, aux)

    def head_weight(self, params) -> torch.Tensor:
        return tfm.head_weight(params, self.cfg)

    def prefill(self, params, batch: Batch, cache_len=None,
                prompt_lens=None):
        """Prefill the decode cache from ``tokens`` (B,S) (behind a VLM's
        ``patches``) -> (last-token logits (B,V), cache).  A VLM's cache
        holds its P + S positions, so ``cache_len`` must count the prefix
        (S11).  With ``prompt_lens`` (B,) each row is a
        prompt right-padded to S: positions from the length on are -1,
        invalid under every mask, the logits are taken at each row's last
        valid token, and the recurrent blocks' state at each row's length
        (the cache of an unpadded prefill of the live prefix, S10); a VLM
        refuses it, as the reference does."""
        tokens = batch["tokens"]
        if prompt_lens is not None and self.n_prefix:
            raise NotImplementedError(
                "bucketed (prompt_lens) prefill is text-LM only; VLM "
                "prompts carry a fixed patch prefix")
        x = self.embed(params, batch)
        B, S = x.shape[:2]
        lens = (torch.full((B,), S, device=tokens.device)
                if prompt_lens is None else prompt_lens.to(tokens.device))
        pos = torch.arange(S, device=tokens.device).expand(B, S)
        pos = torch.where(pos < lens[:, None], pos, -1)
        h, _, cache = tfm.forward_hidden(params, self.cfg, x, positions=pos,
                                         mask_fn=self.mask_fn,
                                         collect_cache=True,
                                         cache_len=cache_len or S)
        last = torch.clamp(lens.long() - 1, 0, S - 1)
        h_last = h[torch.arange(B, device=h.device), last][:, None]
        return tfm.unembed(params, self.cfg, h_last)[:, 0], cache

    def decode(self, params, cache, tokens: torch.Tensor, live=None):
        """tokens (B,): each row's next input -> (logits (B,V), cache).
        The cache is written in place and returned; rows where ``live``
        (B,) is False keep theirs bit-exactly."""
        x_t = tfm.embed_tokens(params, self.cfg, tokens[:, None])
        h = tfm.decode_step(params, self.cfg, x_t, cache, live,
                            mask_fn=self.mask_fn)
        return tfm.unembed(params, self.cfg, h)[:, 0], cache

    def init_cache(self, batch_size: int, cache_len: int, dtype=None,
                   device=torch.device("cpu")):
        """Empty decode cache: KV caches in ``dtype`` (default the
        compute dtype), recurrent state in fp32."""
        return tfm.init_cache(self.cfg, batch_size, cache_len, dtype, device)

    def make_batch(self, gen: torch.Generator, B: int, S: int) -> Batch:
        """One batch of the reference's ``make_batch``: tokens, loss mask
        and weights of S - P text tokens, and a VLM's ``patches`` (B, P,
        d) fp32 standard normal; on ``gen``'s device."""
        P = self.n_prefix
        batch = _tokens_batch(gen, B, S - P, self.cfg.vocab_size)
        if P:
            batch["patches"] = torch.randn((B, P, self.cfg.d_model),
                                           generator=gen, device=gen.device)
        return batch


@dataclasses.dataclass(frozen=True)
class EncDecBundle:
    """Encoder-decoder (``seamless-m4t-medium``): the encoder reads the
    stub frontend's ``frames``, the decoder predicts ``tokens[:, 1:]``
    from ``tokens[:, :-1]`` (ED3)."""

    cfg: ModelConfig

    def __post_init__(self):
        _refuse_unported(self.cfg)
        if self.cfg.n_enc_layers < 1:
            raise ValueError(f"{self.cfg.name}: the 'encdec' family needs "
                             f"cfg.n_enc_layers >= 1")

    def init_params(self, gen: torch.Generator, device: torch.device,
                    dtype=None):
        """fp32 masters, or with ``dtype`` the compute dtype the serving
        weights (``encdec.init_params``)."""
        return encdec_mod.init_params(self.cfg, gen, device, dtype)

    def serving_params(self, params):
        """The serving weights of fp32 masters (``encdec.serving_params``:
        the decoder's norm gammas stay fp32, ED1); training refuses
        them."""
        return encdec_mod.serving_params(params, self.cfg)

    def final_hidden(self, params, batch: Batch, remat: bool = True):
        """-> (decoder hidden states (B,U-1,d) in the compute dtype,
        targets (B,U-1), mask (B,U-1)); ``remat`` checkpoints each encoder
        and decoder layer when autograd records (the reference's
        default)."""
        enc = encdec_mod.encode(params, self.cfg, batch["frames"],
                                remat=remat)
        tokens = batch["tokens"]
        targets = tokens[:, 1:]
        mask = batch.get("loss_mask")
        mask = (torch.ones(targets.shape, dtype=torch.float32,
                           device=tokens.device) if mask is None
                else mask[:, 1:].to(torch.float32))
        h, _ = encdec_mod.decode_train(params, self.cfg, tokens[:, :-1],
                                       enc, remat=remat)
        return h, targets, mask

    def per_example_loss(self, params, batch: Batch,
                         remat: bool = True) -> torch.Tensor:
        h, targets, mask = self.final_hidden(params, batch, remat)
        return softmax_xent(tfm.unembed(params, self.cfg, h), targets, mask)

    def loss_fn(self, params, batch: Batch,
                remat: bool = True) -> Tuple[torch.Tensor, Dict]:
        """(weighted loss, metrics ``loss``, ``aux_loss`` (0),
        ``total_loss``)."""
        return _weighted(self.per_example_loss(params, batch, remat), batch)

    def head_weight(self, params) -> torch.Tensor:
        return tfm.head_weight(params, self.cfg)

    def prefill(self, params, batch: Batch, cache_len=None):
        """Encode ``frames`` and run the decoder over ``tokens`` (B,U) ->
        (last-token logits (B,V), cache: self K/V in a cache of
        ``cache_len`` (default U), ``ck``/``cv`` of the T_src frames)."""
        enc = encdec_mod.encode(params, self.cfg, batch["frames"],
                                remat=False)
        tokens = batch["tokens"]
        h, cache = encdec_mod.decode_train(
            params, self.cfg, tokens, enc, remat=False, collect_cache=True,
            cache_len=cache_len or tokens.shape[1])
        return tfm.unembed(params, self.cfg, h[:, -1:])[:, 0], cache

    def decode(self, params, cache, tokens: torch.Tensor, live=None):
        """tokens (B,): each row's next input -> (logits (B,V), cache);
        the self cache is written in place (rows where ``live`` is False
        keep theirs)."""
        x_t = tfm.embed_tokens(params, self.cfg, tokens[:, None])
        h = encdec_mod.decode_step(params, self.cfg, x_t, cache, live)
        return tfm.unembed(params, self.cfg, h)[:, 0], cache

    def init_cache(self, batch_size: int, cache_len: int, dtype=None,
                   src_len=None, device=torch.device("cpu")):
        return encdec_mod.init_cache(self.cfg, batch_size, cache_len, dtype,
                                     src_len, device)

    def make_batch(self, gen: torch.Generator, B: int, S: int) -> Batch:
        """One batch of the reference's ``make_batch``: ``frames`` (B,
        T_src, d) fp32 standard normal and U text tokens, T_src = U =
        max(S // 2, 4); on ``gen``'s device."""
        T = U = max(S // 2, 4)
        frames = torch.randn((B, T, self.cfg.d_model), generator=gen,
                             device=gen.device)
        return dict(frames=frames,
                    **_tokens_batch(gen, B, U, self.cfg.vocab_size))


def _unported(cfg: ModelConfig) -> str:
    """What of ``cfg`` the port does not carry ('' when nothing): the
    ``dense`` and ``moe`` families with attention blocks, the ``ssm``
    family with RWKV6 blocks, the ``hybrid`` family with RG-LRU and
    local attention blocks, the ``vlm`` family with full attention
    blocks (its prefix mask replaces each layer's) and the ``encdec``
    family with ``attn`` blocks are ported; blocks of another kind in
    these are not."""
    allowed = {"dense": set(ATTN_KINDS), "moe": set(ATTN_KINDS),
               "ssm": {BLOCK_RWKV}, "hybrid": {BLOCK_REC, BLOCK_LOCAL},
               "vlm": {BLOCK_ATTN, BLOCK_GLOBAL}, "encdec": {BLOCK_ATTN}}
    if cfg.family not in allowed:
        return f"the {cfg.family!r} family"
    odd = sorted(set(cfg.layer_kinds()) - allowed[cfg.family])
    return f"{odd} blocks in the {cfg.family!r} family" if odd else ""


def build_model(cfg: ModelConfig):
    """The bundle of ``cfg.family``: ``rnnt``, ``encdec``, or an LM
    (``dense``, ``moe``, ``ssm`` (RWKV6 stacks), ``hybrid`` (RG-LRU) or
    ``vlm``); blocks a family does not carry raise
    ``NotImplementedError``; an ``moe`` config without ``moe`` settings,
    a ``vlm`` one without a prefix or an ``encdec`` one without encoder
    layers ``ValueError``."""
    if cfg.family == "rnnt":
        return RNNTBundle(cfg)
    if cfg.family == "encdec":
        return EncDecBundle(cfg)
    if cfg.family == "moe" and cfg.moe is None:
        raise ValueError(f"{cfg.name}: the 'moe' family needs cfg.moe "
                         f"(n_experts, top_k, d_ff_expert)")
    return LMBundle(cfg)
