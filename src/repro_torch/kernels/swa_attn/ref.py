"""Plain PyTorch version of the sliding-window attention kernel (the
port of the reference's ``kernels/swa_attn/ref.py:swa_attn_ref``, laid
out as its model-level band gather ``models/attention.py:_mha_band``).

Query s attends to the keys in ``(s - window, s]``: fp32 scores times an
fp32 ``1/sqrt(hd)``, ``-1e30`` outside the band, an fp32 softmax and an
fp32 ``p . v``, the output cast to q's dtype.  The queries go in blocks
of ``Q_BLOCK`` rows, each against the band of at most ``window - 1 +
Q_BLOCK`` keys it reaches, so memory is O(S (W + C)), not O(S^2), and
any S works (the reference's band gather needs S % 1024 == 0).

It reads the port's attention layout, q (B, S, KV, G, hd) and k/v (B,
S, KV, hd), so grouped heads share their KV head without a repeat.  With
``lengths`` (B,), row b holds ``lengths[b]`` valid tokens: keys at or
past it are masked, as a position of -1 is in the reference, and query
rows at or past it are written as zeros (they see no valid key).
"""
from __future__ import annotations

import torch

NEG = -1e30
Q_BLOCK = 1024


def attn_scale(hd: int) -> torch.Tensor:
    """fp32 ``1/sqrt(hd)`` as the models compute it."""
    return 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))


def swa_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 window: int, lengths: torch.Tensor = None) -> torch.Tensor:
    """q (B,S,KV,G,hd), k/v (B,S,KV,hd), lengths (B,) or None ->
    (B,S,KV,G,hd) in q's dtype."""
    B, S, KV, G, hd = q.shape
    dev = q.device
    scale = attn_scale(hd).to(dev)
    n = (torch.full((B,), S, device=dev) if lengths is None
         else lengths.to(device=dev, dtype=torch.long))
    C = min(Q_BLOCK, S)
    outs = []
    for i0 in range(0, S, C):
        i1 = min(i0 + C, S)
        j0 = max(0, i0 - window + 1)
        qp = torch.arange(i0, i1, device=dev)
        kp = torch.arange(j0, i1, device=dev)
        qb = q[:, i0:i1].to(torch.float32).permute(0, 2, 3, 1, 4)
        kb = k[:, j0:i1].to(torch.float32).permute(0, 2, 3, 1)[:, :, None]
        s = (qb @ kb) * scale                          # (B,KV,G,C,band)
        d = qp[:, None] - kp[None, :]
        mask = ((d >= 0) & (d < window))[None] \
            & (kp[None, None, :] < n[:, None, None])    # (B,C,band)
        s = torch.where(mask[:, None, None], s, NEG)
        p = torch.softmax(s, dim=-1)
        vb = v[:, j0:i1].to(torch.float32).permute(0, 2, 1, 3)[:, :, None]
        outs.append((p @ vb).permute(0, 3, 1, 2, 4))   # (B,C,KV,G,hd)
    out = torch.cat(outs, dim=1)
    rows = torch.arange(S, device=dev)[None, :] < n[:, None]
    out = out * rows[:, :, None, None, None]
    return out.to(q.dtype)
