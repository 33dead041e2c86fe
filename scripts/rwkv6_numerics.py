"""Numerics of the RWKV6 port against the JAX reference, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/rwkv6_numerics.py

Prints the measurements behind the bars of ``tests/test_torch_rwkv.py``
and ``tests/test_torch_cuda.py`` (and the findings in PERF.md):

1. bf16 logistic: the share of entries where ``torch.sigmoid`` and the
   port's ``models/rwkv6.py:sigmoid`` differ from ``jax.nn.sigmoid``;
2. per gradient leaf of ``rwkv6-3b-smoke`` (seq 10 and 128, the tests'
   params and batch): the reference's bf16 gradient against its fp32
   one, and the port's bf16 gradient against the reference's bf16 one
   (with the port's sigmoid and with ``torch.sigmoid``), relative error
   in norm;
3. the WKV gradients at decays of 1e-6 and in (0.4, 0.99): autograd of
   the plain chunk algebra in fp32 against the same in fp64, error over
   the largest entry;
4. the 4-epoch trajectory of the tests (lr 0.5): the largest difference
   of the selection weights, round by round, port against reference.
"""
import dataclasses
import inspect
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))

import test_torch_rwkv as T  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref as wkv_ref  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402


def rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def logistic() -> None:
    x = (np.random.default_rng(0).normal(size=200_000) * 3).astype(
        np.float32)
    want = np.asarray(jax.nn.sigmoid(jnp.asarray(x, jnp.bfloat16))
                      .astype(jnp.float32))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    for name, fn in (("torch.sigmoid", torch.sigmoid),
                     ("port sigmoid", rwkv6.sigmoid)):
        got = fn(xt).float().numpy()
        print(f"[logistic] bf16 {name} differs from jax.nn.sigmoid in "
              f"{(got != want).mean():.4f} of entries")


def grads(params, dtype, seq, torch_sigmoid=False):
    cj = dataclasses.replace(T.jax_get_config(T.ARCH), compute_dtype=dtype)
    ct = dataclasses.replace(T.get_config(T.ARCH), compute_dtype=dtype)
    mj, mt = T.jax_build(cj), T.build_model(ct)
    batch = {k: v[1] for k, v in T._units(5, 8, seq, noise=0.25).items()}
    batch["weights"] = np.asarray([1.0, 0.5, 2.0, 0.0], np.float32)
    jb = jax.tree.map(jnp.asarray, batch)
    g_j = jax.grad(lambda p: mj.loss_fn(p, jb)[0])(params)
    live = T.tree_map(lambda x: x.clone().requires_grad_(True),
                      T.from_numpy(params))
    saved = rwkv6.sigmoid
    if torch_sigmoid:
        rwkv6.sigmoid = torch.sigmoid
    try:
        mt.loss_fn(live, T._to_torch(batch))[0].backward()
    finally:
        rwkv6.sigmoid = saved
    return {jax.tree_util.keystr(p): (np.asarray(w), T._at(live, p).grad
                                      .numpy())
            for p, w in jax.tree_util.tree_leaves_with_path(g_j)}


def bf16_gradients() -> None:
    mj = T.jax_build(T.jax_get_config(T.ARCH))
    params = jax.tree.map(np.asarray, mj.init_params(jax.random.PRNGKey(3)))
    for seq in (10, 128):
        f32 = grads(params, "float32", seq)
        b16 = grads(params, "bfloat16", seq)
        b16_ts = grads(params, "bfloat16", seq, torch_sigmoid=True)
        print(f"[bf16 grads] seq {seq}: leaf, ref bf16 vs ref fp32, port "
              f"bf16 vs ref bf16, the same with torch.sigmoid")
        rows = []
        for k in f32:
            rows.append((rel(b16[k][0], f32[k][0]), rel(b16[k][1], b16[k][0]),
                         rel(b16_ts[k][1], b16[k][0])))
            print(f"  {k:48s} {rows[-1][0]:.4f} {rows[-1][1]:.4f} "
                  f"{rows[-1][2]:.4f}")
        lo, hi = np.min(rows, axis=0), np.max(rows, axis=0)
        print(f"[bf16 grads] seq {seq}: ranges over leaves: ref bf16 vs "
              f"fp32 {lo[0]:.4f}-{hi[0]:.4f}; port vs ref bf16 "
              f"{lo[1]:.4f}-{hi[1]:.4f}; with torch.sigmoid "
              f"{lo[2]:.4f}-{hi[2]:.4f}")


def wkv_fp64() -> None:
    src = inspect.getsource(wkv_ref.wkv_chunked_lw).replace(
        "f32 = torch.float32", "f32 = r.dtype")
    ns = {"torch": torch, "CHUNK": wkv_ref.CHUNK}
    exec(src, ns)
    wkv_any = ns["wkv_chunked_lw"]
    for w in (1e-6, None):
        B, S, H, N, C = 1, 64, 1, 8, 16
        r, k, v, ww, u = T._wkv_inputs(B, S, H, N, seed=0, w=w)
        rng = np.random.default_rng(1)
        cy = rng.normal(size=(B, S, H, N))
        cs = rng.normal(size=(B, H, N, N)) * 0.1
        out = {}
        for dt in (torch.float64, torch.float32):
            xs = [torch.from_numpy(a).to(dt).requires_grad_(True)
                  for a in (r, k, v)]
            lw = wkv_ref.log_decay(torch.from_numpy(ww)).to(dt) \
                .requires_grad_(True)
            uu = torch.from_numpy(u).to(dt).requires_grad_(True)
            y, s = wkv_any(*xs, lw, uu, torch.zeros(B, H, N, N, dtype=dt), C)
            (torch.sum(y * torch.from_numpy(cy).to(dt))
             + torch.sum(s * torch.from_numpy(cs).to(dt))).backward()
            out[dt] = [t.grad.double() for t in (*xs, lw, uu)]
        for name, a, b in zip(("dr", "dk", "dv", "dlw", "du"),
                              out[torch.float64], out[torch.float32]):
            print(f"[wkv fp32 vs fp64] decays {w or '(0.4, 0.99)'}: {name} "
                  f"largest {float(a.abs().max()):.3e}, fp32 err "
                  f"{float((a - b).abs().max() / a.abs().max()):.2e} of it")


def trajectory() -> None:
    T.fp32_numerics()
    units, val = T._units(0, 32, 128, noise=0.25), T._units(7, 8, 128)
    run = dict(lr=0.5, optimizer="sgd", epochs=4)
    sel = dict(subset_fraction=0.5, n_partitions=2, select_every=2,
               warm_start_epochs=1, sketch_dim_h=16, sketch_dim_v=16,
               val_matching=True)
    tj = T.JaxTrainConfig(**run, pgm=T.JaxPGMConfig(**sel))
    mj = T.jax_build(T.jax_get_config(T.ARCH))
    h_j = T.jax_train(mj, units, tj, method="pgm", val_units=val,
                      engine="host")
    key = jax.random.PRNGKey(tj.seed)
    params = jax.tree.map(np.asarray, mj.init_params(key))
    proj = [np.asarray(x) for x in T.jax_make_proj(
        mj, jax.random.fold_in(key, 17), 16, 16)]
    h_t = T.train_with_selection(
        T.build_model(T.get_config(T.ARCH)), units,
        T.TrainConfig(**run, pgm=T.PGMConfig(**sel)), method="pgm",
        val_units=val, device="cpu", params=params, proj=proj)
    for st, sj in zip(h_t.selections, h_j.selections):
        d = np.abs(np.asarray(st["weights"]) - np.asarray(sj["weights"]))
        print(f"[trajectory] round at epoch {st['epoch']}: same indices "
              f"{st['indices'] == sj['indices']}, weights differ by at most "
              f"{d.max():.2e}")
    lr = np.max(np.abs(np.asarray(h_t.train_loss) / h_j.train_loss - 1))
    lv = np.max(np.abs(np.asarray(h_t.val_loss) / h_j.val_loss - 1))
    print(f"[trajectory] losses: train within {lr:.2e}, val within {lv:.2e} "
          f"relative")


if __name__ == "__main__":
    logistic()
    bf16_gradients()
    wkv_fp64()
    trajectory()
