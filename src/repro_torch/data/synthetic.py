"""Seeded synthetic ASR corpus (offline stand-in for Librispeech).

A copy of the reference's ``make_asr_corpus``: the same numpy code on the
same seed gives byte-identical corpora in both packages (a test checks
it).  Feats are emissions of the token sequence, so an acoustic model
can learn the mapping; a ``noise_fraction`` of utterances gets additive
feature noise at ``snr_db``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ASRCorpus:
    feats: np.ndarray         # (N, T, F) float32
    feat_lens: np.ndarray     # (N,)
    tokens: np.ndarray        # (N, U) int32 (0 = blank/pad)
    token_lens: np.ndarray    # (N,)
    durations: np.ndarray     # (N,) float (seconds-like)
    noisy: np.ndarray         # (N,) bool
    vocab_size: int
    n_feats: int


def make_asr_corpus(
    seed: int, n_examples: int, n_feats: int = 16, vocab_size: int = 32,
    min_tokens: int = 4, max_tokens: int = 12, frames_per_token: int = 4,
    noise_fraction: float = 0.0, snr_db: float = 10.0,
) -> ASRCorpus:
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(vocab_size, n_feats)).astype(np.float32)
    U = max_tokens
    T = max_tokens * frames_per_token
    tokens = np.zeros((n_examples, U), np.int32)
    feats = np.zeros((n_examples, T, n_feats), np.float32)
    token_lens = rng.integers(min_tokens, max_tokens + 1, n_examples)
    noisy = np.zeros(n_examples, bool)
    if noise_fraction > 0:
        noisy[rng.choice(n_examples, int(n_examples * noise_fraction),
                         replace=False)] = True
    for i in range(n_examples):
        u = token_lens[i]
        seq = rng.integers(1, vocab_size, u)
        tokens[i, :u] = seq
        frames = np.repeat(emb[seq], frames_per_token, axis=0)
        frames = frames + rng.normal(size=frames.shape) * 0.1
        if noisy[i]:
            sig_pow = float((frames ** 2).mean())
            noise_pow = sig_pow / (10 ** (snr_db / 10))
            frames = frames + rng.normal(size=frames.shape) * np.sqrt(noise_pow)
        feats[i, : u * frames_per_token] = frames
    feat_lens = (token_lens * frames_per_token).astype(np.int32)
    durations = feat_lens.astype(np.float32) / frames_per_token
    return ASRCorpus(feats, feat_lens, tokens, token_lens.astype(np.int32),
                     durations, noisy, vocab_size, n_feats)
