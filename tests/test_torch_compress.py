"""PyTorch port, cross-pod gradient compression
(``repro_torch/train/compress.py``) against the JAX reference's
``train/compress.py`` on the CPU.

The port's ``compressed_psum`` runs over 2 and 4 gloo ranks, one a pod
(``tests/torch_dist_helpers.py``), each on its pod's gradients and
error state; the reference's runs on the same per-pod trees under
``jax.vmap(..., axis_name="pod")``, in-process, as its own tests bind
the axis (``tests/test_compress.py``):

- ``none``: the fp32 mean within 1e-6;
- ``bf16``: bitwise at 2 pods (ROADMAP hazard D3: one bf16 rounding of
  a sum of two); at 4 pods the reference sums in fp32 and rounds once,
  gloo rounds each partial sum to bf16, so the bar is 2 bf16 ulps of
  the pods' summed magnitudes, over the pod count;
- ``topk``: exactly k entries a whole leaf sent by every pod, the
  error-feedback invariant ``sent + new_err == g + old_err`` bitwise
  (D2), and on tie-free data the reference's mean and residuals (1e-6);
- the reference's top-k regressions (a zero k-th value, ties, the k
  floor of 1), ``init_error_state``'s pod dim, an unknown mode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train.compress import compressed_psum as jax_psum  # noqa: E402
from repro_torch.train.compress import (compressed_psum,  # noqa: E402
                                        init_error_state, topk_compress)
from torch_dist_helpers import spawn  # noqa: E402
from torch_dist_ranks import compress_modes  # noqa: E402

K_FRAC = 0.1
SHAPES = {"w": (16, 8), "b": (24,), "emb": (33, 5)}


def _pod_trees(n_pods, seed):
    rng = np.random.default_rng(seed)
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(n_pods)]
    errs = [{k: (0.1 * rng.normal(size=s)).astype(np.float32)
             for k, s in SHAPES.items()} for _ in range(n_pods)]
    return grads, errs


def _reference(grads, errs, mode):
    stack = lambda ts: {k: jnp.stack([jnp.asarray(t[k]) for t in ts])
                        for k in SHAPES}

    def per_pod(g, e):
        return jax_psum(g, "pod", mode, err=e, k_frac=K_FRAC)

    red, new = jax.vmap(per_pod, in_axes=(0, 0), out_axes=(None, 0),
                        axis_name="pod")(stack(grads), stack(errs))
    return ({k: np.asarray(v) for k, v in red.items()},
            {k: np.asarray(v) for k, v in new.items()})


def _bf16_ulp(x):
    """One bf16 ulp at each entry's magnitude."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("n_pods", [2, 4])
def test_compressed_psum_matches_reference(tmp_path, n_pods):
    grads, errs = _pod_trees(n_pods, seed=n_pods)
    got = spawn(compress_modes, n_pods, tmp_path, grads, errs, K_FRAC)
    for mode in ("none", "bf16", "topk"):
        want_red, want_err = _reference(grads, errs, mode)
        for k in SHAPES:
            reds = [g[mode][0][k] for g in got]
            for r in reds[1:]:              # every pod gets the same mean
                assert np.array_equal(r, reds[0]), (mode, k)
            if mode == "bf16":
                assert reds[0].dtype == np.float32
                if n_pods == 2:
                    assert np.array_equal(reds[0], want_red[k]), k
                else:
                    # each partial sum rounds to bf16 on gloo, the sum
                    # once in the reference: 2 ulps of the summed
                    # magnitudes, over the pod count
                    mag = sum(np.abs(g[k].astype(jnp.bfloat16)
                                     .astype(np.float32)) for g in grads)
                    gap = np.abs(reds[0] - want_red[k])
                    assert np.all(gap <= 2 * _bf16_ulp(mag) / n_pods), k
            else:
                np.testing.assert_allclose(reds[0], want_red[k], rtol=0,
                                           atol=1e-6)
            for pod in range(n_pods):
                new_err = got[pod][mode][1][k]
                if mode != "topk":          # the state passes through
                    assert np.array_equal(new_err, errs[pod][k])
                    continue
                flat = grads[pod][k] + errs[pod][k]
                # exactly k entries of the whole leaf sent (D2); the
                # residual is 0 on them and g + err off them, bit for bit
                k_n = max(int(flat.size * K_FRAC), 1)
                on = new_err == 0
                assert int(on.sum()) == k_n, (k, pod)
                assert np.array_equal(new_err[~on], flat[~on])
                # no ties here: the reference's residual, bit for bit
                assert np.array_equal(new_err, want_err[k][pod]), (k, pod)


def test_topk_regressions_and_error_state():
    """``tests/test_compress.py``'s regressions on the port: a leaf whose
    k-th largest |g| is 0 sends at most k entries (its three nonzeros
    among them), all-equal magnitudes send exactly k, k is at least 1;
    the invariant holds bitwise; ``init_error_state`` adds the pod dim
    in fp32; an unknown mode raises."""
    g = {"emb": torch.zeros(100)}
    g["emb"][[3, 50, 97]] = torch.tensor([1.0, -2.0, 0.5])
    sent, _ = topk_compress(g, init_error_state(g), k_frac=0.1)
    assert int((sent["emb"] != 0).sum()) <= 10
    assert sent["emb"][[3, 50, 97]].tolist() == [1.0, -2.0, 0.5]
    g = {"w": torch.ones(20)}
    sent, _ = topk_compress(g, init_error_state(g), k_frac=0.25)
    assert int((sent["w"] != 0).sum()) == 5
    g = {"w": torch.tensor([0.5, -3.0])}
    sent, _ = topk_compress(g, init_error_state(g), k_frac=0.0)
    assert sent["w"].tolist() == [0.0, -3.0]
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))}
    err = {"w": torch.from_numpy(
        (0.1 * rng.normal(size=(16, 8))).astype(np.float32))}
    sent, new = topk_compress(g, err, k_frac=0.2)
    assert torch.equal(sent["w"] + new["w"], g["w"] + err["w"])
    p = {"w": torch.zeros(4, 3), "b": torch.zeros(5)}
    e = init_error_state(p, n_pods=2)
    assert e["w"].shape == (2, 4, 3) and e["b"].shape == (2, 5)
    assert all(l.dtype == torch.float32 for l in e.values())
    assert init_error_state(p)["w"].shape == (4, 3)
    with pytest.raises(ValueError):
        compressed_psum(p, None, "int8")
