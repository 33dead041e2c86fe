"""Serving launcher of the port (the reference's ``repro.launch.serve``).

One-shot static batching (LMs, and the VLM with patch embeddings drawn
beside the prompts):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \
      --batch 2 --prompt-len 8192 --new 32 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b \
      --batch 4 --prompt-len 512 --new 32 [--device cpu]

The encoder-decoder is refused with a ``ValueError`` (ROADMAP S12: the
reference's one-shot path draws no ``frames`` and dies with a
``KeyError``); serve it through ``generate(..., extra_inputs={"frames":
...})``.  The slot engine refuses both families, as the reference's does.

The recurrent families serve the same way (``--arch recurrentgemma-9b``,
``--arch rwkv6-3b``, and their ``-smoke`` variants), their decode cache
the layers' recurrent state beside any local KV rings.

Continuous batching (LMs and the paper's RNN-T CRDNN, which always
routes here):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \
      --engine slots --requests 8 --n-slots 4 --prompt-len 8192 --new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rnnt-crdnn-smoke \
      --requests 8 --prompt-len 48 --device cpu

Runs on the card unless ``--device cpu`` is given, and prints the
reference's summary line.  Weights come from the port's ``init_params``
with a ``torch.Generator`` on the device seeded by ``--seed``, drawn
in the compute dtype (an LM's serving weights: ``--arch gemma3-27b``
builds its 54 GB of bf16 on one card), so they (and the one-shot
prompts) differ from the reference launcher's; the slot engine's
requests are drawn with numpy exactly as the reference draws them.
"""
from __future__ import annotations

import argparse
import time
from typing import List

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.backend import fp32_numerics, resolve_device
from repro_torch.models.api import build_model
from repro_torch.models.common import compute_dtype
from repro_torch.serve.engine import Request, SlotEngine, generate


def make_requests(cfg, n: int, prompt_len: int, max_new: int,
                  seed: int) -> List[Request]:
    """``n`` requests with lengths in [prompt_len // 2, prompt_len]: token
    prompts for an LM, feature frames for the RNN-T (the reference
    launcher's draws)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        L = int(rng.integers(prompt_len // 2, prompt_len + 1))
        if cfg.family == "rnnt":
            inputs = {"feats": rng.normal(
                size=(L, cfg.rnnt.n_feats)).astype(np.float32)}
        else:
            inputs = {"tokens": rng.integers(
                0, cfg.vocab_size, (L,)).astype(np.int32)}
        reqs.append(Request(uid=i, inputs=inputs, max_new_tokens=max_new))
    return reqs


def _oneshot(args, cfg, bundle, params, dev):
    if cfg.family == "encdec":
        raise ValueError(
            f"{cfg.name}: the one-shot launcher draws no frames for the "
            f"'encdec' family (ROADMAP S12: the reference's dies with a "
            f"KeyError); call generate(..., extra_inputs={{'frames': ...}})")
    gen = torch.Generator().manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, dtype=torch.int32).to(dev)
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = torch.randn(
            (args.batch, cfg.n_prefix, cfg.d_model),
            generator=torch.Generator().manual_seed(args.seed + 2)).to(dev)
    toks, stats = generate(
        bundle, params, prompts, args.new, temperature=args.temperature,
        eos_id=args.eos_id,
        generator=torch.Generator(device=dev).manual_seed(args.seed),
        extra_inputs=extra)
    print(f"{cfg.name}: {tuple(toks.shape)} tokens — prefill "
          f"{stats.prefill_s*1e3:.1f} ms "
          f"({stats.prompt_tokens}+{stats.prefill_tokens} tok), decode "
          f"{stats.decode_s*1e3:.1f} ms / {stats.decode_steps} steps "
          f"({stats.decode_tokens} live tok, {stats.tokens_per_s:.1f} tok/s)")
    return toks, stats


def _slots(args, cfg, bundle, params, dev):
    reqs = make_requests(cfg, args.requests, args.prompt_len, args.new,
                         args.seed)
    eng = SlotEngine(bundle, params, n_slots=args.n_slots,
                     max_new_tokens=args.new, max_prompt_len=args.prompt_len,
                     temperature=args.temperature, eos_id=args.eos_id,
                     sync_every=args.sync_every, seed=args.seed)
    t0 = time.time()
    comps = eng.run(reqs)
    wall = time.time() - t0
    lat = sorted(c.latency_s for c in comps)
    n_tok = sum(len(c.tokens) for c in comps)
    print(f"{cfg.name}: {len(comps)} requests / {eng.n_slots} slots — "
          f"{wall*1e3:.0f} ms wall, {len(comps)/wall:.1f} req/s, "
          f"{n_tok} tokens, p50 latency {lat[len(lat)//2]*1e3:.0f} ms, "
          f"{eng.n_decode_dispatches} decode dispatches")
    return comps, eng


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--engine", choices=("oneshot", "slots"),
                    default="oneshot")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--sync-every", type=int, default=4)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    fp32_numerics()
    cfg = get_config(args.arch)
    bundle = build_model(cfg)
    if cfg.family == "rnnt":
        params = bundle.init_params(
            torch.Generator().manual_seed(args.seed), dev)
    else:
        # an LM's serving weights, drawn on the device in the compute
        # dtype layer by layer (no fp32 masters: gemma3-27b's 108 GB
        # would not fit one card)
        params = bundle.init_params(
            torch.Generator(device=dev).manual_seed(args.seed), dev,
            dtype=compute_dtype(cfg))
    if args.engine == "slots" or cfg.family == "rnnt":
        return _slots(args, cfg, bundle, params, dev)
    return _oneshot(args, cfg, bundle, params, dev)


if __name__ == "__main__":
    main()
