"""Serving demo of the port, the twin of the reference's
``examples/serve_lm.py``: one-shot batched decode, then the
continuous-batching slot engine (per-slot KV caches, admit/evict between
decode scans).

  PYTHONPATH=src python -m repro_torch.examples.serve_lm
      --arch gemma3-27b-smoke [--batch 4] [--prompt-len 16] [--new 24]
      [--temperature 0.7] [--device cpu]

Runs on the card unless ``--device cpu`` is given, and prints the
reference's lines.  The weights are the serving weights, drawn on the
device in the compute dtype (``init_params(dtype=...)``), and weights
and prompts come from ``torch.Generator``s seeded 0 and 1 (the
reference draws from ``jax.random``), so the tokens differ from the
reference example's unless its draws are handed in (``serve(params=...,
prompts=...)``); the slot engine's requests are drawn with numpy as the
reference draws them.  A VLM (``--arch paligemma-3b-smoke``) is served
with patch embeddings drawn beside the prompts (a generator seeded 2),
and, as in the reference example, not through the slot engine.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.backend import fp32_numerics, resolve_device
from repro_torch.models.api import build_model
from repro_torch.models.common import compute_dtype
from repro_torch.serve.engine import Request, SlotEngine, generate


def serve(*, arch: str = "gemma3-27b-smoke", batch: int = 4,
          prompt_len: int = 16, new: int = 24, temperature: float = 0.0,
          device: Optional[str] = None, params=None, prompts=None,
          log_fn: Callable[[str], None] = print):
    """The reference example's two runs.  ``params``/``prompts``:
    optional weights (any float dtype; served in the compute dtype) and
    (batch, prompt_len) prompts (a parity test hands in the
    reference's).  -> (generate's tokens, its stats, the slot engine's
    completions, None for a VLM)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    bundle = build_model(cfg)
    if params is None:
        params = bundle.init_params(
            torch.Generator(device=dev).manual_seed(0), dev,
            dtype=compute_dtype(cfg))
    params = bundle.serving_params(params)
    if prompts is None:
        prompts = torch.randint(
            0, cfg.vocab_size, (batch, prompt_len), dtype=torch.int32,
            generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    if not isinstance(prompts, torch.Tensor):
        prompts = torch.tensor(np.asarray(prompts))
    prompts = prompts.to(dev)
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = torch.randn(
            (batch, cfg.n_prefix, cfg.d_model), device=dev,
            generator=torch.Generator(device=dev).manual_seed(2))
    toks, stats = generate(
        bundle, params, prompts, new, temperature=temperature,
        generator=torch.Generator(device=dev).manual_seed(0),
        extra_inputs=extra)
    log_fn(f"arch={cfg.name}: generated {tuple(toks.shape)} tokens")
    log_fn(f"prefill {stats.prefill_s*1e3:.1f} ms "
           f"({stats.prompt_tokens}+{stats.prefill_tokens} tok), decode "
           f"{stats.decode_s*1e3:.1f} ms over {stats.decode_steps} steps — "
           f"{stats.decode_tokens} live tokens, {stats.tokens_per_s:.1f} "
           f"tok/s (on {dev.type})")
    log_fn(f"sample: {toks[0][:12].tolist()}")
    if cfg.family == "vlm":
        return toks, stats, None    # the slot engine serves text LMs

    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    inputs={"tokens": rng.integers(
                        0, cfg.vocab_size,
                        (int(rng.integers(4, prompt_len + 1)),)
                    ).astype(np.int32)},
                    max_new_tokens=new)
            for i in range(2 * batch)]
    eng = SlotEngine(bundle, params, n_slots=batch, max_new_tokens=new,
                     max_prompt_len=prompt_len, temperature=temperature)
    t0 = time.time()
    comps = eng.run(reqs)
    wall = time.time() - t0
    log_fn(f"slot engine: {len(comps)} requests over {eng.n_slots} slots in "
           f"{wall*1e3:.0f} ms ({eng.n_decode_dispatches} decode dispatches)")
    return toks, stats, comps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-27b-smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)
    fp32_numerics()
    return serve(arch=args.arch, batch=args.batch,
                 prompt_len=args.prompt_len, new=args.new,
                 temperature=args.temperature, device=args.device)


if __name__ == "__main__":
    main()
