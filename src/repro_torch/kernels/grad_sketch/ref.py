"""Plain PyTorch version of the grad-sketch kernel (the port of the
reference's ``kernels/grad_sketch/ref.py``): it materializes the (n, V)
softmax error, so it is for tests and ``chip_smoke.py`` only.  The
wrapper's CPU path is the vocab-streamed ``core/lastlayer.py:streamed_er2``
instead, which never holds an (n, V) tensor."""
from __future__ import annotations

import torch


def grad_sketch_ref(h, w, r_h, r_v, targets, scale) -> torch.Tensor:
    """h (N,d); w (d,V); r_h (d,k1); r_v (V,k2); targets (N,); scale (N,)
    -> (H R1)^T (E R2) (k1, k2) fp32, E = diag(scale) (softmax(H W) -
    onehot(targets))."""
    h32 = h.to(torch.float32)
    p = torch.softmax(h32 @ w.to(torch.float32), dim=-1)
    e = p.clone()
    e[torch.arange(e.shape[0], device=e.device), targets.long()] -= 1.0
    e = e * scale.to(torch.float32)[:, None]
    return (h32 @ r_h.to(torch.float32)).t() @ (e @ r_v.to(torch.float32))


def grad_sketch_units_ref(h, w, r_h, r_v, targets, scale) -> torch.Tensor:
    """(U, n, d) / (U, n) inputs -> (U, k1, k2) per-unit sketches."""
    return torch.stack([grad_sketch_ref(h[u], w, r_h, r_v, targets[u],
                                        scale[u])
                        for u in range(h.shape[0])])
