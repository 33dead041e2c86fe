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

``swa_attn_fwd_ref`` also returns each row's logsumexp of its scaled
scores (fp32, (B, S, KV, G); ``NEG`` for a row with no valid key), which
``swa_attn_bwd_ref``, the plain backward, takes to recompute p block by
block: ``p = exp(s - lse)`` inside the band and 0 outside it and on rows
at or past their length, ``ds = p (dout . v - D)`` with ``D = dout .
out``, and dk / dv summed over the G query heads of their KV head.
"""
from __future__ import annotations

import torch

NEG = -1e30
Q_BLOCK = 1024


def attn_scale(hd: int) -> torch.Tensor:
    """fp32 ``1/sqrt(hd)`` as the models compute it."""
    return 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))


def _lengths(lengths, B: int, S: int, dev) -> torch.Tensor:
    return (torch.full((B,), S, device=dev) if lengths is None
            else lengths.to(device=dev, dtype=torch.long))


def _block(q, k, i0: int, i1: int, window: int, n, scale):
    """The scaled fp32 scores of q rows [i0, i1) against the keys their
    band reaches, and the band's mask -> (j0, scores (B,KV,G,C,band),
    mask (B,C,band))."""
    dev = q.device
    j0 = max(0, i0 - window + 1)
    qp = torch.arange(i0, i1, device=dev)
    kp = torch.arange(j0, i1, device=dev)
    qb = q[:, i0:i1].to(torch.float32).permute(0, 2, 3, 1, 4)
    kb = k[:, j0:i1].to(torch.float32).permute(0, 2, 3, 1)[:, :, None]
    s = (qb @ kb) * scale                              # (B,KV,G,C,band)
    d = qp[:, None] - kp[None, :]
    mask = ((d >= 0) & (d < window))[None] \
        & (kp[None, None, :] < n[:, None, None])        # (B,C,band)
    return j0, s, mask


def swa_attn_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int, lengths: torch.Tensor = None):
    """q (B,S,KV,G,hd), k/v (B,S,KV,hd), lengths (B,) or None -> (out
    (B,S,KV,G,hd) in q's dtype, lse (B,S,KV,G) fp32)."""
    B, S, KV, G, hd = q.shape
    dev = q.device
    scale = attn_scale(hd).to(dev)
    n = _lengths(lengths, B, S, dev)
    C = min(Q_BLOCK, S)
    outs, lses = [], []
    for i0 in range(0, S, C):
        i1 = min(i0 + C, S)
        j0, s, mask = _block(q, k, i0, i1, window, n, scale)
        s = torch.where(mask[:, None, None], s, NEG)
        p = torch.softmax(s, dim=-1)
        vb = v[:, j0:i1].to(torch.float32).permute(0, 2, 1, 3)[:, :, None]
        outs.append((p @ vb).permute(0, 3, 1, 2, 4))   # (B,C,KV,G,hd)
        # lse = m + log l = m - log p_max, p_max = exp(0) / l: no second
        # exp over the band (exp of the -1e30 entries is slow on the CPU)
        lse = s.amax(dim=-1) - torch.log(p.amax(dim=-1))
        lses.append(lse.permute(0, 3, 1, 2))
    rows = torch.arange(S, device=dev)[None, :] < n[:, None]
    out = torch.cat(outs, dim=1) * rows[:, :, None, None, None]
    lse = torch.where(rows[:, :, None, None], torch.cat(lses, dim=1), NEG)
    return out.to(q.dtype), lse


def swa_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 window: int, lengths: torch.Tensor = None) -> torch.Tensor:
    """q (B,S,KV,G,hd), k/v (B,S,KV,hd), lengths (B,) or None ->
    (B,S,KV,G,hd) in q's dtype."""
    return swa_attn_fwd_ref(q, k, v, window=window, lengths=lengths)[0]


def swa_attn_bwd_ref(q, k, v, out, lse, dout, *, window: int,
                     lengths: torch.Tensor = None):
    """The gradient of ``swa_attn_fwd_ref``'s output: q, k, v, its out and
    lse, and dout (out's shape) -> (dq, dk, dv) in q's dtype, summed in
    fp32 block by block."""
    B, S, KV, G, hd = q.shape
    dev = q.device
    scale = attn_scale(hd).to(dev)
    n = _lengths(lengths, B, S, dev)
    f32 = torch.float32
    do = dout.to(f32)
    delta = (do * out.to(f32)).sum(dim=-1)              # (B,S,KV,G)
    dq = torch.zeros(q.shape, dtype=f32, device=dev)
    dk = torch.zeros(k.shape, dtype=f32, device=dev)
    dv = torch.zeros(v.shape, dtype=f32, device=dev)
    C = min(Q_BLOCK, S)
    for i0 in range(0, S, C):
        i1 = min(i0 + C, S)
        j0, s, mask = _block(q, k, i0, i1, window, n, scale)
        live = torch.arange(i0, i1, device=dev)[None, :] < n[:, None]
        mask = mask & live[:, :, None]
        lb = lse[:, i0:i1].permute(0, 2, 3, 1)[..., None]   # (B,KV,G,C,1)
        p = torch.where(mask[:, None, None], torch.exp(s - lb), 0.0)
        dob = do[:, i0:i1].permute(0, 2, 3, 1, 4)           # (B,KV,G,C,hd)
        kb = k[:, j0:i1].to(f32).permute(0, 2, 1, 3)[:, :, None]
        vb = v[:, j0:i1].to(f32).permute(0, 2, 1, 3)[:, :, None]
        db = delta[:, i0:i1].permute(0, 2, 3, 1)[..., None]
        ds = p * (dob @ vb.transpose(-1, -2) - db)           # (B,KV,G,C,band)
        dq[:, i0:i1] = ((ds @ kb) * scale).permute(0, 3, 1, 2, 4)
        qb = q[:, i0:i1].to(f32).permute(0, 2, 3, 1, 4)
        dk[:, j0:i1] += ((ds.transpose(-1, -2) @ qb).sum(dim=2)
                         * scale).permute(0, 2, 1, 3)
        dv[:, j0:i1] += (p.transpose(-1, -2) @ dob).sum(dim=2) \
            .permute(0, 2, 1, 3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
