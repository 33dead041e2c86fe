"""The paper's own architecture: CRDNN RNN-Transducer (SpeechBrain
Librispeech transducer recipe; Graves 2012, Ravanelli et al. 2021).

The port of the reference's ``models/rnnt.py``, as plain functions over
a params dict with the reference's keys and layouts:

* transcription network: 2 CNN blocks (3x3, stride 2x2, JAX ``SAME``
  padding) -> bi-LSTM layers -> 2 DNN layers;
* prediction network: embedding + 1-layer GRU;
* joint network: Linear(enc) + Linear(pred) -> tanh -> Linear to vocab.

The recurrent cells are written out step by step rather than taken from
``nn.LSTM``/``nn.GRU``, whose bias placement differs: the LSTM applies
``sigmoid(f + 1.0)`` with gates in i, f, g, o order and one input-side
bias, the GRU's r gate multiplies the bias-free ``h @ wh`` slice, and the
backward LSTM direction runs over the whole padded T' in reverse.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, embed_init

# ---------------------------------------------------------------------------
# Recurrent cells
# ---------------------------------------------------------------------------

def init_lstm(gen, d_in, d_h, device):
    return {"wx": dense_init(gen, d_in, 4 * d_h, device),
            "wh": dense_init(gen, d_h, 4 * d_h, device),
            "b": torch.zeros((4 * d_h,), device=device)}


def lstm_scan(p, x, reverse: bool = False):
    """x: (B,T,d_in) -> (B,T,d_h)."""
    B, T, _ = x.shape
    d_h = p["wh"].shape[0]
    xw = x @ p["wx"] + p["b"]
    h = x.new_zeros((B, d_h))
    c = x.new_zeros((B, d_h))
    hs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = xw[:, t] + h @ p["wh"]
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs[t] = h
    return torch.stack(hs, dim=1)


def init_gru(gen, d_in, d_h, device):
    return {"wx": dense_init(gen, d_in, 3 * d_h, device),
            "wh": dense_init(gen, d_h, 3 * d_h, device),
            "b": torch.zeros((3 * d_h,), device=device)}


def gru_scan(p, x, h0=None):
    """x: (B,T,d_in), initial state h0 (B,d_h) or zeros -> (B,T,d_h)."""
    B, T, _ = x.shape
    d_h = p["wh"].shape[0]
    xw = x @ p["wx"] + p["b"]
    h = x.new_zeros((B, d_h)) if h0 is None else h0
    hs = []
    for t in range(T):
        xr, xz, xn = xw[:, t].chunk(3, dim=-1)
        hr, hz, hn = (h @ p["wh"]).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs, dim=1)


def gru_step(p, x_t, h):
    """One GRU step for greedy transducer decoding: x_t (B,d_in), h
    (B,d_h) -> (y, h_new), which are the same (B,d_h) values."""
    y = gru_scan(p, x_t[:, None], h0=h)[:, 0]
    return y, y


#: Transducer blank symbol: training reserves id 0 for blank/pad (the
#: corpus samples labels from [1, V), the loss scores blank on column 0),
#: so decoding uses the same convention.
BLANK_ID = 0


# ---------------------------------------------------------------------------
# RNN-T model
# ---------------------------------------------------------------------------

def init_params(cfg, gen: torch.Generator, device: torch.device) -> Dict:
    """The port's own initialisation (same shapes and scales as the
    reference, drawn from ``gen``)."""
    r = cfg.rnnt
    p: Dict = {}
    c_in = 1
    for i, c in enumerate(r.cnn_channels):
        std = 1.0 / math.sqrt(9.0 * c_in)
        p[f"conv{i}"] = {
            "w": (torch.randn((3, 3, c_in, c), generator=gen) * std
                  ).to(device),
            "b": torch.zeros((c,), device=device),
        }
        c_in = c
    d_in = r.cnn_channels[-1] * (r.n_feats // 4)
    for i in range(r.lstm_layers):
        p[f"lstm{i}_f"] = init_lstm(gen, d_in, r.lstm_hidden, device)
        p[f"lstm{i}_b"] = init_lstm(gen, d_in, r.lstm_hidden, device)
        d_in = 2 * r.lstm_hidden
    p["dnn0"] = {"w": dense_init(gen, d_in, r.dnn_dim, device),
                 "b": torch.zeros((r.dnn_dim,), device=device)}
    p["dnn1"] = {"w": dense_init(gen, r.dnn_dim, r.dnn_dim, device),
                 "b": torch.zeros((r.dnn_dim,), device=device)}
    p["pred_embed"] = {"w": embed_init(gen, r.vocab_size, r.pred_embed,
                                       device)}
    p["pred_gru"] = init_gru(gen, r.pred_embed, r.pred_hidden, device)
    p["joint"] = {
        "w_enc": dense_init(gen, r.dnn_dim, r.joint_dim, device),
        "w_pred": dense_init(gen, r.pred_hidden, r.joint_dim, device),
        "w_out": dense_init(gen, r.joint_dim, r.vocab_size, device),
    }
    return p


def _same_pad(n: int, k: int = 3, s: int = 2) -> Tuple[int, int]:
    """JAX/XLA ``SAME`` padding (lo, hi) of one spatial dim: with stride
    2 an even size pads (0, 1), not (1, 1)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def encode(params, cfg, feats):
    """feats: (B,T,F) -> (B, T//4, dnn_dim)."""
    r = cfg.rnnt
    x = feats[:, None]                                    # (B,1,T,F)
    for i in range(len(r.cnn_channels)):
        w, b = params[f"conv{i}"]["w"], params[f"conv{i}"]["b"]
        t_lo, t_hi = _same_pad(x.shape[2])
        f_lo, f_hi = _same_pad(x.shape[3])
        x = F.pad(x, (f_lo, f_hi, t_lo, t_hi))
        # HWIO -> OIHW at the conv only
        x = F.conv2d(x, w.permute(3, 2, 0, 1), stride=2)
        x = torch.relu(x + b[None, :, None, None])
    B, C, T4, F4 = x.shape
    x = x.permute(0, 2, 3, 1).reshape(B, T4, F4 * C)     # NHWC flatten
    for i in range(r.lstm_layers):
        f = lstm_scan(params[f"lstm{i}_f"], x)
        bwd = lstm_scan(params[f"lstm{i}_b"], x, reverse=True)
        x = torch.cat([f, bwd], dim=-1)
    x = torch.relu(x @ params["dnn0"]["w"] + params["dnn0"]["b"])
    x = torch.relu(x @ params["dnn1"]["w"] + params["dnn1"]["b"])
    return x


def predict(params, cfg, tokens):
    """tokens: (B,U) -> (B, U+1, pred_hidden): position u conditions on
    tokens[<u]; position 0 is the blank-start state."""
    # F.embedding, not indexing: its backward is bitwise repeatable on the
    # CPU with several intra-op threads (F5)
    emb = F.embedding(tokens.long(), params["pred_embed"]["w"])
    emb = F.pad(emb, (0, 0, 1, 0))                        # start token = 0
    return gru_scan(params["pred_gru"], emb)


def joint_factors(params, cfg, feats, tokens):
    """-> (ze (B,T',J), zp (B,U+1,J)), the factors of the fused loss."""
    enc = encode(params, cfg, feats)
    pred = predict(params, cfg, tokens)
    ze = enc @ params["joint"]["w_enc"]
    zp = pred @ params["joint"]["w_pred"]
    return ze, zp


def joint_hidden(params, enc, pred):
    """(B,T,De),(B,U1,Dp) -> pre-vocab joint activations (B,T,U1,J)."""
    ze = enc @ params["joint"]["w_enc"]
    zp = pred @ params["joint"]["w_pred"]
    return torch.tanh(ze[:, :, None, :] + zp[:, None, :, :])


def joint_logits(params, z):
    return z @ params["joint"]["w_out"]


def forward(params, cfg, feats, tokens):
    """-> the dense logits (B, T', U+1, V) of the dense loss oracle."""
    enc = encode(params, cfg, feats)
    pred = predict(params, cfg, tokens)
    return joint_logits(params, joint_hidden(params, enc, pred))


def pred_step(params, cfg, tokens, h):
    """One prediction-network step for streaming greedy decode: tokens
    (B,) int, the symbol just emitted (any id < 0 is the blank-start
    state, a zero embedding, as ``predict`` feeds at position 0); h (B,
    pred_hidden) -> (g, h_new).  Stepping a label sequence through it
    reproduces ``predict``'s rows."""
    emb = F.embedding(torch.clamp(tokens.long(), min=0),
                      params["pred_embed"]["w"])
    emb = torch.where((tokens >= 0)[:, None], emb, torch.zeros_like(emb))
    return gru_step(params["pred_gru"], emb, h)


def pred_start(params, cfg, batch_size: int, dtype=torch.float32,
               device=torch.device("cpu")):
    """Blank-start prediction state ``(g0, h0)``: ``predict`` at u = 0."""
    h0 = torch.zeros((batch_size, cfg.rnnt.pred_hidden), dtype=dtype,
                     device=device)
    start = torch.full((batch_size,), -1, dtype=torch.int32, device=device)
    return pred_step(params, cfg, start, h0)


def joint_step(params, enc_t, g):
    """Joint network at one (frame, prediction state): enc_t (B,
    dnn_dim), g (B, pred_hidden) -> logits (B, V); one (t, u) cell of
    ``joint_hidden`` + ``joint_logits``."""
    ze = enc_t @ params["joint"]["w_enc"]
    zp = g @ params["joint"]["w_pred"]
    return torch.tanh(ze + zp) @ params["joint"]["w_out"]
