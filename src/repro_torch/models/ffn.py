"""Dense FFN variants of the port (the reference's ``models/ffn.py``):
SwiGLU / GeGLU (gated) and GELU / squared-ReLU."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.common import dense_init, ffn_act


def is_gated(ffn_type: str) -> bool:
    return ffn_type in ("swiglu", "geglu")


def init_ffn_params(gen: torch.Generator, d_model: int, d_ff: int,
                    ffn_type: str, device: torch.device) -> Dict:
    p = {"w_in": dense_init(gen, d_model, d_ff, device),
         "w_out": dense_init(gen, d_ff, d_model, device)}
    if is_gated(ffn_type):
        p["w_gate"] = dense_init(gen, d_model, d_ff, device)
    return p


def ffn_forward(params, x: torch.Tensor, ffn_type: str) -> torch.Tensor:
    dt = x.dtype
    act = ffn_act(ffn_type)
    h = x @ params["w_in"].to(dt)
    if is_gated(ffn_type):
        h = act(x @ params["w_gate"].to(dt)) * h
    else:
        h = act(h)
    return h @ params["w_out"].to(dt)
