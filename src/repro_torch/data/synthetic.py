"""Seeded synthetic corpora (offline stand-ins for Librispeech and a
code/text LM corpus).

A copy of the reference's ``make_lm_corpus`` and ``make_asr_corpus``: the
same numpy code on the same seed gives byte-identical corpora in both
packages (a test checks it).  LM rows come from an easy (low-entropy) and
a hard (high-entropy) Markov chain with log-normal lengths; a
``noise_fraction`` of them gets corrupted labels.  ASR feats are
emissions of the token sequence, so an acoustic model can learn the
mapping; a ``noise_fraction`` of utterances gets additive feature noise
at ``snr_db``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LMCorpus:
    tokens: np.ndarray        # (N, S) int32, padded with pad_id
    lengths: np.ndarray       # (N,)
    difficulty: np.ndarray    # (N,) float in [0,1]
    noisy: np.ndarray         # (N,) bool
    vocab_size: int
    pad_id: int = 0


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


def _markov_tokens(rng, n, s_max, vocab, temperature):
    """Rows of a random Markov chain; temperature controls entropy."""
    k = min(vocab - 1, 64)
    logits = rng.normal(size=(k, k)) / max(temperature, 1e-3)
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    cdf = np.cumsum(probs, axis=1)
    out = np.zeros((n, s_max), np.int32)
    state = rng.integers(0, k, size=n)
    for t in range(s_max):
        out[:, t] = state + 1                         # reserve 0 for pad
        u = rng.random(n)
        state = (cdf[state] > u[:, None]).argmax(axis=1)
    return out


def make_lm_corpus(
    seed: int, n_examples: int, seq_len: int, vocab_size: int,
    hard_fraction: float = 0.4, noise_fraction: float = 0.0,
    min_len_frac: float = 0.3,
) -> LMCorpus:
    rng = np.random.default_rng(seed)
    n_hard = int(n_examples * hard_fraction)
    easy = _markov_tokens(rng, n_examples - n_hard, seq_len, vocab_size, 0.3)
    hard = _markov_tokens(rng, n_hard, seq_len, vocab_size, 2.5)
    tokens = np.concatenate([easy, hard], axis=0)
    difficulty = np.concatenate([
        np.zeros(n_examples - n_hard), np.ones(n_hard)])
    perm = rng.permutation(n_examples)
    tokens, difficulty = tokens[perm], difficulty[perm]

    lengths = np.clip(
        (np.exp(rng.normal(0.0, 0.5, n_examples))
         * seq_len * (min_len_frac + 0.35)).astype(np.int32),
        max(int(seq_len * min_len_frac), 4), seq_len)
    for i in range(n_examples):
        tokens[i, lengths[i]:] = 0

    noisy = np.zeros(n_examples, bool)
    if noise_fraction > 0:
        idx = rng.choice(n_examples, int(n_examples * noise_fraction),
                         replace=False)
        noisy[idx] = True
        for i in idx:                                  # label corruption
            L = lengths[i]
            n_corrupt = max(L // 3, 1)
            pos = rng.choice(L, n_corrupt, replace=False)
            tokens[i, pos] = rng.integers(1, vocab_size, n_corrupt)
    return LMCorpus(tokens, lengths, difficulty, noisy, vocab_size)


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
