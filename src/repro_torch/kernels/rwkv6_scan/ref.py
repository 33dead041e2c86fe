"""Plain PyTorch versions of the RWKV6 WKV recurrence (the reference's
``models/rwkv6.py:wkv_scan`` and ``wkv_chunked``).

``wkv_scan`` is the sequential oracle.  ``wkv_chunked`` is the chunk
algebra, written as the reference writes it: ``lw = log(clip(w, 1e-8,
1))``, ``cum`` its cumulative sum, ``cum_prev = cum - lw``, the
strictly-lower pairwise decays ``exp(minimum(cum_prev_i - cum_j, 0))``,
the ``u . k`` diagonal bonus and the state update through
``exp(cum_C - cum)``.  ``wkv_chunked_lw`` is the same function of the
log-decays, what the kernel wrapper takes; the CPU runs it, and the
card's kernels are held against its values and its autograd.
"""
from __future__ import annotations

import torch

CHUNK = 64


def wkv_scan(r, k, v, w, u, state0):
    """r,k,v: (B,S,H,N); w: (B,S,H,N) decays in (0,1); u: (H,N);
    state0: (B,H,N,N) keyed [k-dim, v-dim].  Returns (y (B,S,H,N),
    state)."""
    S_ = state0
    ys = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]  # (B,H,N)
        a = k_t[..., :, None] * v_t[..., None, :]                # (B,H,N,N)
        ys.append(torch.einsum("bhn,bhnm->bhm", r_t,
                               S_ + u[..., :, None] * a))
        S_ = w_t[..., :, None] * S_ + a
    return torch.stack(ys, dim=1), S_


def wkv_chunked_lw(r, k, v, lw, u, state0, chunk: int = CHUNK):
    """``wkv_chunked`` on log-decays ``lw`` (B,S,H,N), already clipped
    and logged.  Returns (y (B,S,H,N) fp32, final state (B,H,N,N))."""
    B, S, H, N = r.shape
    C = min(chunk, S)
    assert S % C == 0, (S, C)
    nC = S // C
    f32 = torch.float32

    def chunks(t):                                   # -> (nC,B,H,C,N)
        return t.to(f32).reshape(B, nC, C, H, N).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lwc = chunks(r), chunks(k), chunks(v), chunks(lw)
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                      diagonal=-1)[None, None, :, :, None]
    S_ = state0.to(f32)
    ys = []
    for c in range(nC):
        rr, kk, vv, lww = rc[c], kc[c], vc[c], lwc[c]      # (B,H,C,N)
        cum = torch.cumsum(lww, dim=2)                     # sum_{j<=i}
        cum_prev = cum - lww                               # sum_{j<i}
        # inter-chunk: y_i += (r_i * exp(cum_{i-1})) @ S
        r_dec = rr * torch.exp(cum_prev)
        y = torch.einsum("bhcn,bhnm->bhcm", r_dec, S_)
        # intra-chunk strict-lower pairwise decays (exponents <= 0)
        dif = cum_prev[:, :, :, None, :] - cum[:, :, None, :, :]
        e = torch.where(mask, torch.exp(torch.minimum(
            dif, torch.zeros((), dtype=f32, device=r.device))),
            torch.zeros((), dtype=f32, device=r.device))
        A = torch.einsum("bhin,bhjn,bhijn->bhij", rr, kk, e)
        y = y + torch.einsum("bhij,bhjm->bhim", A, vv)
        # diagonal bonus term: y_i += (r_i . (u*k_i)) v_i
        diag = torch.einsum("bhcn,bhcn->bhc", rr, kk * u[..., None, :])
        y = y + diag[..., None] * vv
        # state update: S' = diag(exp(cum_C)) S
        #                    + sum_j (k_j exp(cum_C - cum_j))^T v_j
        tot = cum[:, :, -1:, :]                            # (B,H,1,N)
        k_dec = kk * torch.exp(tot - cum)
        S_ = torch.exp(tot[:, :, 0, :])[..., :, None] * S_ + \
            torch.einsum("bhjn,bhjm->bhnm", k_dec, vv)
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, S, H, N)
    return y.to(r.dtype), S_


def log_decay(w: torch.Tensor) -> torch.Tensor:
    """``lw = log(clip(w, 1e-8, 1))`` in fp32, outside the kernel (as
    the Pallas wrapper computes it), so autograd carries its gradient."""
    return torch.log(torch.clamp(w.to(torch.float32), 1e-8, 1.0))


def wkv_chunked(r, k, v, w, u, state0, chunk: int = CHUNK):
    """The reference's ``wkv_chunked``: decays ``w`` in (0, 1)."""
    return wkv_chunked_lw(r, k, v, log_decay(w), u, state0, chunk)
