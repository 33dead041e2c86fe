"""Serving engines of the port (the reference's ``serve/engine.py``).

Two surfaces:

* :func:`generate` -- one-shot batched prefill + decode for LM, VLM and
  encoder-decoder bundles (``extra_inputs``: a VLM's ``patches``, an
  encoder-decoder's ``frames``), the static-batching baseline and the
  slot engine's parity oracle.  A VLM's cache holds its patch prefix
  too: it is sized ``n_prefix + Sp + new``, where the reference's
  ``Sp + new`` keeps the last positions as a ring and drops the first
  patches (ROADMAP S11).
  ``ServeStats`` counts *live* (pre-eos) decode tokens, with the token
  sampled from the prefill logits attributed to prefill; ``done`` is
  seeded from that first token; the host checks termination every
  ``sync_every`` steps, and finished rows are pinned to ``eos_id``.

* :class:`SlotEngine` -- continuous batching.  A host request queue
  feeds a fixed pool of ``n_slots`` decode slots.  One scan advances
  every slot ``sync_every`` micro-steps, each one batched decode call
  over all slots at their own positions and ring slots, which writes
  the live slots' rows into the cache pool in place and leaves the
  others bit-exactly as they were.  Between scans the host reads
  the live flags and emission counts in one fetch, evicts finished or
  expired requests and admits queued ones into the freed slots (a B = 1
  prefill written into the pool in place: a slot's KV caches and its
  recurrent state -- RG-LRU ``h``/``conv``, RWKV6 ``S`` and shift rows,
  fp32 in the pool -- are overwritten whole).  Windowed models prefill
  exact-length prompts (bucket padding would push real keys out of a
  full ring); others right-pad to power-of-two buckets with position -1,
  and a recurrent layer takes its state at the prompt's length, so a
  padded prompt's slot holds the state of the unpadded prompt (the
  reference's carries its pads through the recurrence, ROADMAP S10).
  An MoE model routes a bucket's pad rows with its prompt (they take
  expert capacity after the prompt's first choices, as the reference's
  do), and a prompt must split into MoE groups of 2,048 tokens, as the
  reference asserts (ROADMAP hazards M4, M1).

The slot engine serves decoder LMs (KV caches and recurrent state, eos
termination; not the VLM and encoder-decoder families, which it refuses
as the reference's does) and the
paper's RNN-T CRDNN (encoder buffer + prediction state; a micro-step is
one joint step, blanks advance the frame cursor and are never emitted):
streaming greedy transducer search, token for token the textbook loop of
:func:`rnnt_greedy_reference`.

Both hold the weights in the compute dtype (``bundle.serving_params``:
fp32 masters are cast once a call or engine, weights built in the
compute dtype are taken as they are); the logits are bitwise those of
the masters, since the forward casts exactly those leaves.

``jit``, ``lax.scan`` and ``vmap`` of the reference become eager calls,
a Python loop and a batch dimension.  Temperature sampling draws from a
``torch.Generator`` (not ``jax.random``), so sampled tokens differ from
the reference's; greedy decoding is held token for token.  Host timings
synchronize the card before they read the clock.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import rnnt as rnnt_mod
from repro_torch.models.common import tree_leaves, tree_map


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_of(params) -> torch.device:
    return tree_leaves(params)[0].device


# ===========================================================================
# One-shot generate (static batching)
# ===========================================================================

@dataclasses.dataclass
class ServeStats:
    """Timing and throughput of one :func:`generate` call.
    ``decode_tokens`` counts only live tokens (sampled for a row that had
    not emitted eos); the token sampled from the prefill logits counts
    in ``prefill_tokens``."""

    prefill_s: float
    decode_s: float
    prompt_tokens: int        # prompt tokens processed by prefill (B * Sp)
    prefill_tokens: int       # tokens sampled from prefill logits (B)
    decode_tokens: int        # live (pre-eos) tokens emitted by decode steps
    decode_steps: int         # decode calls actually made

    @property
    def tokens_per_s(self) -> float:
        """Decode-phase throughput over live decode tokens only."""
        return self.decode_tokens / max(self.decode_s, 1e-9)

    @property
    def prefill_tokens_per_s(self) -> float:
        return (self.prompt_tokens + self.prefill_tokens) \
            / max(self.prefill_s, 1e-9)


def sample_token(logits: torch.Tensor, generator=None,
                 temperature: float = 0.0) -> torch.Tensor:
    """(B,V) -> (B,) int32: argmax (the first index on a tie) or a draw
    from ``softmax(logits / temperature)``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


@torch.no_grad()
def generate(bundle, params, prompts: torch.Tensor, max_new_tokens: int, *,
             temperature: float = 0.0, eos_id: Optional[int] = None,
             generator: Optional[torch.Generator] = None,
             extra_inputs: Optional[Dict[str, torch.Tensor]] = None,
             sync_every: int = 8):
    """Greedy or temperature batched generation: prompts (B, Sp) on the
    params' device, with ``extra_inputs`` beside them in the prefill's
    batch (``patches`` (B, P, d) of a VLM, ``frames`` (B, T, d) of an
    encoder-decoder) -> (tokens (B, T_new) int32, stats).  Up to
    ``sync_every - 1`` trailing all-eos columns may follow the point
    where every row finished."""
    if bundle.cfg.family == "rnnt":
        raise ValueError(
            "generate() is the LM one-shot path; RNN-T uses streaming "
            "greedy transducer search -- SlotEngine or "
            "rnnt_greedy_reference")
    dev = prompts.device
    B, Sp = prompts.shape
    params = bundle.serving_params(params)
    # a VLM's cache holds the patch prefix before the prompt (S11)
    prefix = bundle.cfg.n_prefix if bundle.cfg.family == "vlm" else 0
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = bundle.prefill(params,
                                   dict(extra_inputs or {}, tokens=prompts),
                                   cache_len=prefix + Sp + max_new_tokens)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tok = sample_token(logits, generator, temperature)
    out = [tok]
    # the token sampled from the prefill logits can already be eos
    done = (tok == eos_id) if eos_id is not None else None
    n_live = torch.zeros((), dtype=torch.int64, device=dev)
    steps = 0
    t0 = time.perf_counter()
    for i in range(max_new_tokens - 1):
        # one device->host sync per `sync_every` steps, not per token
        if done is not None and i % sync_every == 0 and bool(done.all()):  # repro_torch: noqa[host-sync-loop] -- the early-exit probe, once every sync_every steps
            break
        logits, cache = bundle.decode(params, cache, tok)
        tok = sample_token(logits, generator, temperature)
        if done is not None:
            n_live = n_live + torch.sum(~done)      # live before this step
            done = done | (tok == eos_id)
            tok = torch.where(done, torch.full_like(tok, eos_id), tok)
        else:
            n_live = n_live + B
        out.append(tok)
        steps += 1
    _sync(dev)
    t_decode = time.perf_counter() - t0
    stats = ServeStats(t_prefill, t_decode, prompt_tokens=B * Sp,
                       prefill_tokens=B, decode_tokens=int(n_live),
                       decode_steps=steps)
    return torch.stack(out, dim=1), stats


# ===========================================================================
# Continuous batching: requests, completions, slot engine
# ===========================================================================

@dataclasses.dataclass
class Request:
    """One serving request.  ``inputs`` holds host arrays: ``tokens``
    (Lp,) int32 for LMs, ``feats`` (T, F) float32 for the RNN-T.
    ``arrival_s`` is the arrival time after ``SlotEngine.run`` starts (0 =
    already queued); ``deadline_s`` (seconds after arrival, None = none)
    bounds the total latency: a request still queued or decoding past it
    ends with ``status="expired"``."""

    uid: int
    inputs: Dict[str, np.ndarray]
    max_new_tokens: int
    arrival_s: float = 0.0
    deadline_s: Optional[float] = None


@dataclasses.dataclass
class Completion:
    """Terminal record of one request: ``status`` is ``"ok"`` (decoded
    to eos or budget), ``"rejected"`` (host queue full, never held a
    slot) or ``"expired"`` (deadline passed in the queue or mid-decode;
    ``tokens`` holds what was emitted)."""

    uid: int
    tokens: List[int]
    arrival_s: float
    admit_s: float
    done_s: float
    status: str = "ok"

    @property
    def latency_s(self) -> float:
        """Queue wait + decode: arrival to completion."""
        return self.done_s - self.arrival_s


class SlotEngine:
    """Continuous-batching engine over a model bundle.

    1. **admit**: a queued request is prefilled (B = 1; its prompt
       right-padded to its bucket, or exact-length for windowed models)
       and written into a free slot of the state: the cache pool, the
       last-token vector, the live mask, the output buffer and budget.
    2. **decode**: one scan advances every slot ``sync_every``
       micro-steps; slots that are not live are left bit-exactly as
       they were.  The host reads ``live`` and ``n_out`` once a scan.
    3. **evict**: finished slots (eos, frame cursor exhausted, budget,
       deadline) are read out and freed for the next admission.
    """

    def __init__(self, bundle, params, *, n_slots: int = 8,
                 max_new_tokens: int = 32, max_prompt_len: int = 64,
                 temperature: float = 0.0, eos_id: Optional[int] = None,
                 sync_every: int = 4, max_symbols: int = 8,
                 bucket_min: int = 8, seed: int = 0,
                 max_queue: Optional[int] = None, clock=time.time):
        cfg = bundle.cfg
        if cfg.family in ("vlm", "encdec"):
            raise ValueError(f"SlotEngine serves LM and RNN-T families, "
                             f"not {cfg.family!r}")
        self.bundle = bundle
        # the weights in the compute dtype, cast once here (a no-op for
        # weights built in it) instead of once a block call
        self.params = bundle.serving_params(params)
        self.cfg = cfg
        self.device = _device_of(params)
        self.n_slots = int(n_slots)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self.sync_every = int(sync_every)
        self.max_symbols = int(max_symbols)
        self.bucket_min = int(bucket_min)
        self.is_rnnt = cfg.family == "rnnt"
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # None = unbounded; a bound turns overflow into an immediate
        # rejection instead of unbounded host memory growth
        self.max_queue = None if max_queue is None else int(max_queue)
        self._clock = clock             # injectable; must be monotonic
        self.n_decode_dispatches = 0
        self.n_admits = 0
        self.n_rejected = 0
        self.n_expired = 0

        if self.is_rnnt:
            red = cfg.rnnt.time_reduction
            # feats buckets stay multiples of the conv reduction, so the
            # encoder frame count of a bucket is exact
            self.bucket_min = max(self.bucket_min, red)
            self.max_prompt_len = self._bucket_of(int(max_prompt_len))
            self.cache_capacity = self.max_prompt_len // red
            pool = bundle.init_cache(self.n_slots, self.cache_capacity,
                                     max_symbols=self.max_symbols,
                                     device=self.device)
        else:
            # ring caches evict oldest-first by buffer order, so bucket
            # padding would push real keys out of a full window:
            # windowed models take exact-length prompts
            self.exact_lengths = bool(
                cfg.window and "local" in cfg.layer_kinds())
            self.max_prompt_len = (int(max_prompt_len) if self.exact_lengths
                                   else self._bucket_of(int(max_prompt_len)))
            self.cache_capacity = self.max_prompt_len + self.max_new_tokens
            pool = bundle.init_cache(self.n_slots, self.cache_capacity,
                                     device=self.device)
        n, dev = self.n_slots, self.device
        self._fill = int(eos_id) if eos_id is not None else 0
        i32 = dict(dtype=torch.int32, device=dev)
        self._state = {
            "cache": pool,
            "tok": torch.zeros((n,), **i32),
            "live": torch.zeros((n,), dtype=torch.bool, device=dev),
            "n_out": torch.zeros((n,), **i32),
            "budget": torch.ones((n,), **i32),
            "out": torch.full((n, self.max_new_tokens), self._fill, **i32),
        }

    # -- buckets --------------------------------------------------------
    def _bucket_of(self, length: int) -> int:
        """Smallest power-of-two bucket >= length (>= bucket_min)."""
        b = self.bucket_min
        while b < length:
            b *= 2
        return b

    def bucket_for(self, request: Request) -> int:
        key = "feats" if self.is_rnnt else "tokens"
        L = int(np.shape(request.inputs[key])[0])
        if L > self.max_prompt_len:
            raise ValueError(f"request {request.uid}: prompt length {L} "
                             f"exceeds max_prompt_len={self.max_prompt_len}")
        if not self.is_rnnt and self.exact_lengths:
            return L
        return self._bucket_of(L)

    # -- family hooks ---------------------------------------------------
    def _prefill_one(self, inputs: torch.Tensor, length: int):
        """B = 1 prefill of one padded request -> (logits (1,V), cache)."""
        lens = torch.tensor([length], dtype=torch.int32, device=self.device)
        if self.is_rnnt:
            logits, cache = self.bundle.prefill(
                self.params, {"feats": inputs[None], "feat_lens": lens},
                max_symbols=self.max_symbols)
            pad = self.cache_capacity - cache["enc"].shape[1]
            if pad:
                cache = dict(cache, enc=F.pad(cache["enc"], (0, 0, 0, pad)))
            return logits, cache
        return self.bundle.prefill(self.params, {"tokens": inputs[None]},
                                   cache_len=self.cache_capacity,
                                   prompt_lens=lens)

    def _emit_and_done(self, tok: torch.Tensor, cache):
        """Per-slot emission and termination masks for sampled ``tok``
        given the post-step cache."""
        if self.is_rnnt:
            exhausted = cache["t"] >= cache["t_len"]
            return (tok != rnnt_mod.BLANK_ID) & ~exhausted, exhausted
        emit = torch.ones_like(tok, dtype=torch.bool)
        done = (tok == self.eos_id) if self.eos_id is not None \
            else torch.zeros_like(tok, dtype=torch.bool)
        return emit, done

    # -- device work ----------------------------------------------------
    def _pad_inputs(self, request: Request, bucket: int):
        key, dt = (("feats", np.float32) if self.is_rnnt
                   else ("tokens", np.int32))
        x = np.asarray(request.inputs[key], dt)
        padded = np.zeros((bucket,) + x.shape[1:], dt)
        padded[: x.shape[0]] = x
        return torch.from_numpy(padded).to(self.device), x.shape[0]

    @torch.no_grad()
    def _admit(self, slot: int, request: Request):
        inputs, L = self._pad_inputs(request, self.bucket_for(request))
        budget = min(int(request.max_new_tokens), self.max_new_tokens)
        logits, cache1 = self._prefill_one(inputs, L)
        tok0 = sample_token(logits, self._gen, self.temperature)[0]
        if self.is_rnnt:
            emit0 = tok0 != rnnt_mod.BLANK_ID
            done0 = torch.zeros_like(emit0)     # frame 0 is always valid
        else:
            emit0 = torch.ones_like(tok0, dtype=torch.bool)
            done0 = (tok0 == self.eos_id) if self.eos_id is not None \
                else torch.zeros_like(emit0)
        st = self._state
        # the pool is updated in place: slot `slot` of every leaf
        tree_map(lambda pool, leaf: pool.__setitem__(slot, leaf[0]),
                 st["cache"], cache1)
        n_out0 = emit0.to(torch.int32)
        st["tok"][slot] = tok0
        st["live"][slot] = ~done0 & (n_out0 < budget)
        st["n_out"][slot] = n_out0
        st["budget"][slot] = budget
        st["out"][slot] = self._fill
        st["out"][slot, 0] = torch.where(emit0, tok0,
                                         torch.full_like(tok0, self._fill))
        self.n_admits += 1

    @torch.no_grad()
    def _decode_scan(self):
        """``sync_every`` micro-steps of every slot, on the card."""
        st = self._state
        rows = torch.arange(self.n_slots, device=self.device)
        for _ in range(self.sync_every):
            live = st["live"]
            # slots that are not live are bit-exact no-ops: the decode
            # leaves their state as it was (an LM pool is written in place)
            logits, cache = self.bundle.decode(self.params, st["cache"],
                                               st["tok"], live=live)
            tok = sample_token(logits, self._gen, self.temperature)
            emit, done_now = self._emit_and_done(tok, cache)
            emit = emit & live
            idx = torch.clamp(st["n_out"], 0, self.max_new_tokens - 1).long()
            cur = st["out"][rows, idx]
            st["out"][rows, idx] = torch.where(emit, tok, cur)
            n_out = st["n_out"] + emit.to(torch.int32)
            finished = live & (done_now | (n_out >= st["budget"]))
            st = dict(st, cache=cache, tok=torch.where(live, tok, st["tok"]),
                      live=live & ~finished, n_out=n_out)
        self._state = st

    # -- host-side admit/evict loop --------------------------------------
    def _expired(self, req: Request, now: float) -> bool:
        return (req.deadline_s is not None
                and now > req.arrival_s + req.deadline_s)

    def run(self, requests: Sequence[Request]) -> List[Completion]:
        """Serve ``requests`` (offered load via ``arrival_s``) to
        completion.  Arrivals land in a host queue bounded by
        ``max_queue`` (overflow -> ``"rejected"``); a request whose
        deadline passes in the queue is dropped without taking a slot,
        and one that expires mid-decode is evicted with its partial
        tokens (``"expired"``)."""
        clock = self._clock
        schedule = collections.deque(
            sorted(requests, key=lambda r: (r.arrival_s, r.uid)))
        queue: "collections.deque[Request]" = collections.deque()
        active: Dict[int, Tuple[Request, float]] = {}
        free = list(range(self.n_slots))
        completions: List[Completion] = []
        t0 = clock()
        while schedule or queue or active:
            now = clock() - t0
            while schedule and schedule[0].arrival_s <= now:
                req = schedule.popleft()
                if (self.max_queue is not None
                        and len(queue) >= self.max_queue):
                    self.n_rejected += 1
                    completions.append(Completion(
                        uid=req.uid, tokens=[], arrival_s=req.arrival_s,
                        admit_s=float("nan"), done_s=clock() - t0,
                        status="rejected"))
                    continue
                queue.append(req)
            now = clock() - t0
            kept: "collections.deque[Request]" = collections.deque()
            for req in queue:
                if self._expired(req, now):
                    self.n_expired += 1
                    completions.append(Completion(
                        uid=req.uid, tokens=[], arrival_s=req.arrival_s,
                        admit_s=float("nan"), done_s=clock() - t0,
                        status="expired"))
                else:
                    kept.append(req)
            queue = kept
            while free and queue:
                req = queue.popleft()
                slot = free.pop()
                self._admit(slot, req)
                active[slot] = (req, clock() - t0)
            if not active:
                if schedule:
                    # idle: nothing decoding, next arrival in the future
                    time.sleep(min(max(schedule[0].arrival_s - now, 0.0),
                                   0.005))
                continue
            self._decode_scan()
            self.n_decode_dispatches += 1
            # ONE host fetch per scan: live flags and emission counts
            flags = torch.stack([self._state["live"].to(torch.int32),  # repro_torch: noqa[host-sync-loop] -- the one host read a decode scan (live flags and counts)
                                 self._state["n_out"]]).cpu().numpy()
            live, n_out = flags[0].astype(bool), flags[1]
            now = clock() - t0
            kill = np.zeros(self.n_slots, bool)
            for slot, (req, _) in active.items():
                if live[slot] and self._expired(req, now):
                    kill[slot] = True
            if kill.any():
                self._state["live"] = self._state["live"] & ~torch.from_numpy(
                    kill).to(self.device)
                live = live & ~kill
            finished = [s for s in list(active) if not live[s]]
            if finished:
                # one fetch of the whole output pool for the sweep
                out_pool = self._state["out"].cpu().numpy()  # repro_torch: noqa[host-sync-loop] -- one pool read, on sweeps that finish a slot
            for slot in finished:
                req, admit_s = active.pop(slot)
                toks = out_pool[slot][: int(n_out[slot])]
                if kill[slot]:
                    self.n_expired += 1
                completions.append(Completion(
                    uid=req.uid, tokens=[int(t) for t in toks],
                    arrival_s=req.arrival_s, admit_s=admit_s,
                    done_s=clock() - t0,
                    status="expired" if kill[slot] else "ok"))
                free.append(slot)
        return completions


# ===========================================================================
# RNN-T greedy decode: non-streaming reference
# ===========================================================================

@torch.no_grad()
def rnnt_greedy_reference(bundle, params, feats, feat_lens,
                          max_symbols: int = 8) -> List[List[int]]:
    """Greedy transducer search as the textbook host loop (Graves 2012):
    at each frame, emit argmax symbols until blank (or ``max_symbols``
    emissions), then advance.  ``feats`` (B,T,F) and ``feat_lens`` (B,)
    are host arrays; the model runs on the params' device.  The oracle
    the streaming SlotEngine must match token for token."""
    cfg = bundle.cfg
    dev = _device_of(params)
    enc = rnnt_mod.encode(params, cfg,
                          torch.as_tensor(np.asarray(feats, np.float32),
                                          device=dev))
    red = cfg.rnnt.time_reduction
    t_lens = np.minimum(np.maximum(np.asarray(feat_lens) // red, 1),
                        enc.shape[1])
    results: List[List[int]] = []
    for b in range(enc.shape[0]):
        g, h = rnnt_mod.pred_start(params, cfg, 1, enc.dtype, dev)
        toks: List[int] = []
        for t in range(int(t_lens[b])):
            for _ in range(max_symbols):
                logits = rnnt_mod.joint_step(params, enc[b: b + 1, t], g)
                k = int(torch.argmax(logits[0]))  # repro_torch: noqa[host-sync-loop] -- the host-loop oracle; a read a symbol is its definition
                if k == rnnt_mod.BLANK_ID:
                    break
                toks.append(k)
                g, h = rnnt_mod.pred_step(
                    params, cfg, torch.tensor([k], device=dev), h)
        results.append(toks)
    return results
