"""End-to-end example of the port, the twin of the reference's
``examples/train_asr_pgm.py``: train a CRDNN RNN-Transducer on synthetic
speech with PGM subset selection, noisy-robust validation matching,
newbob annealing and checkpoints, then report the token error rate of a
greedy decode.

  PYTHONPATH=src python -m repro_torch.examples.train_asr_pgm
      [--method pgm|random|full] [--noise 0.2] [--snr-db 10]
      [--subset 0.3] [--epochs 8] [--n 64] [--engine scan|host]
      [--epoch-chunk N] [--ckpt DIR] [--device cpu]

Runs on the card unless ``--device cpu`` is given.  ``--noise F``
corrupts a fraction F of the training utterances with additive feature
noise at ``--snr-db`` dB; validation stays clean and PGM matches against
its gradient.  ``--engine`` defaults to the scanned epoch engine, as the
reference's does; ``--epoch-chunk N`` runs up to N epochs as one
scan-engine call.
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import PGMConfig, TrainConfig
from repro_torch.data.pipeline import asr_units
from repro_torch.data.synthetic import make_asr_corpus
from repro_torch.kernels.backend import fp32_numerics, resolve_device
from repro_torch.models import rnnt as rnnt_mod
from repro_torch.models.api import build_model
from repro_torch.train.loop import train_with_selection

ARCH = "rnnt-crdnn-smoke"


def greedy_decode(bundle, params, feats, feat_lens, max_symbols=20):
    """The reference example's greedy transducer search, time-synchronous
    with one symbol a frame: it encodes the whole padded batch and walks
    every encoder frame whatever ``feat_lens`` says, emits at most
    ``max_symbols`` an utterance, starts from a zero prediction state
    and moves the GRU state only in rows that emitted (blank is id 0; an
    argmax tie takes the first index).  -> (hyp (B, max_symbols) int32,
    n_sym (B,) int32) on the host."""
    cfg = bundle.cfg
    r = cfg.rnnt
    dev = params["joint"]["w_out"].device
    with torch.no_grad():
        enc = rnnt_mod.encode(params, cfg, torch.as_tensor(feats,
                                                           device=dev))
        B, T, _ = enc.shape
        hyp = np.zeros((B, max_symbols), np.int32)
        n_sym = np.zeros((B,), np.int32)
        emb_w = params["pred_embed"]["w"]
        g_state = torch.zeros((B, r.pred_hidden), device=dev)
        for t in range(T):
            z = rnnt_mod.joint_hidden(params, enc[:, t:t + 1],
                                      g_state[:, None])
            logits = rnnt_mod.joint_logits(params, z)[:, 0, 0]
            tok_dev = torch.argmax(logits, -1)
            tok = tok_dev.cpu().numpy().astype(np.int32)
            emit = (tok != 0) & (n_sym < max_symbols)
            for b in np.where(emit)[0]:
                hyp[b, n_sym[b]] = tok[b]
                n_sym[b] += 1
            if emit.any():
                g_new, _ = rnnt_mod.gru_step(params["pred_gru"],
                                             emb_w[tok_dev], g_state)
                g_state = torch.where(
                    torch.as_tensor(emit, device=dev)[:, None], g_new,
                    g_state)
    return hyp, n_sym


def token_error_rate(hyp, n_sym, refs, ref_lens):
    """Levenshtein distance per reference token (the WER analogue)."""
    total_err = total_ref = 0
    for b in range(hyp.shape[0]):
        h = list(hyp[b, : n_sym[b]])
        r = list(refs[b, : ref_lens[b]])
        d = np.zeros((len(h) + 1, len(r) + 1), np.int32)
        d[:, 0] = np.arange(len(h) + 1)
        d[0, :] = np.arange(len(r) + 1)
        for i in range(1, len(h) + 1):
            for j in range(1, len(r) + 1):
                d[i, j] = min(d[i - 1, j] + 1, d[i, j - 1] + 1,
                              d[i - 1, j - 1] + (h[i - 1] != r[j - 1]))
        total_err += d[-1, -1]
        total_ref += len(r)
    return total_err / max(total_ref, 1)


def train_and_decode(*, method: str = "pgm", noise: float = 0.2,
                     snr_db: float = 10.0, subset: float = 0.3,
                     epochs: int = 8, n: int = 64, engine: str = "scan",
                     epoch_chunk: int = 1, ckpt: Optional[str] = None,
                     device: Optional[str] = None, params=None, proj=None,
                     log_fn: Callable[[str], None] = print):
    """The example's run: the noisy training corpus (seed 0) in units of
    4, the clean validation corpus (seed 31, 16 utterances), AdamW at lr
    0.05 with PGM every 2 epochs after 2 warm epochs over 4 partitions
    and 32 x 32 sketches, then greedy decode and TER on the validation
    utterances.  ``params``/``proj``: optional initial draws (a parity
    test hands in the reference's).  -> (History, hyp, n_sym, TER)."""
    dev = resolve_device(device)
    cfg = get_config(ARCH)
    r = cfg.rnnt
    bundle = build_model(cfg)
    corpus = make_asr_corpus(0, n, n_feats=r.n_feats,
                             vocab_size=r.vocab_size,
                             noise_fraction=noise, snr_db=snr_db)
    log_fn(f"train corpus: {int(corpus.noisy.sum())}/{n} utterances "
           f"corrupted at {snr_db:.0f} dB SNR")
    units = asr_units(corpus, 4)
    val_c = make_asr_corpus(31, 16, n_feats=r.n_feats,
                            vocab_size=r.vocab_size)
    val = asr_units(val_c, 4)
    tc = TrainConfig(
        lr=0.05, optimizer="adamw", epochs=epochs,
        pgm=PGMConfig(subset_fraction=subset, n_partitions=4,
                      select_every=2, warm_start_epochs=2,
                      sketch_dim_h=32, sketch_dim_v=32,
                      val_matching=noise > 0))
    h = train_with_selection(bundle, units, tc, method=method,
                             val_units=val, ckpt_dir=ckpt, engine=engine,
                             epoch_chunk=epoch_chunk, device=str(dev),
                             params=params, proj=proj, log_fn=log_fn)
    hyp, n_sym = greedy_decode(bundle, h.final_params, val_c.feats,
                               val_c.feat_lens)
    ter = token_error_rate(hyp, n_sym, val_c.tokens, val_c.token_lens)
    log_fn(f"\nmethod={method}: token error rate {ter:.3f}, "
           f"val loss {h.val_loss[-1]:.4f}, "
           f"training cost {h.cost_units:.2f} full-epoch units")
    return h, hyp, n_sym, ter


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="pgm")
    ap.add_argument("--noise", type=float, default=0.2,
                    help="fraction of corrupted training utterances")
    ap.add_argument("--snr-db", type=float, default=10.0,
                    help="SNR (dB) of the injected feature noise")
    ap.add_argument("--subset", type=float, default=0.3)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--engine", default="scan", choices=["scan", "host"])
    ap.add_argument("--epoch-chunk", type=int, default=1,
                    help="fold N epochs into one scan-engine call")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)
    fp32_numerics()
    return train_and_decode(method=args.method, noise=args.noise,
                            snr_db=args.snr_db, subset=args.subset,
                            epochs=args.epochs, n=args.n, engine=args.engine,
                            epoch_chunk=args.epoch_chunk, ckpt=args.ckpt,
                            device=args.device)


if __name__ == "__main__":
    main()
