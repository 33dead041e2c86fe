"""PyTorch port, training through the band on the CPU: a whole model's
loss and every gradient leaf past the band's start, against
``jax.value_and_grad`` of the reference's ``loss_fn`` (its default
``remat=True``, its XLA ``_mha_band``), on the band archs' smokes
(window 16, so the band runs from S 1,041) at B 2, S 2,048 (a multiple of
1024, where the reference's band gather runs, B5): fp32 loss within
1e-5, each gradient leaf within 1e-4 of its largest entry (B1: at fp32
the port's band, p kept fp32, is the reference's function); bf16 at the
LM tests' bar, 2e-2 relative error in norm, the reference's bf16
gradient compiled with ``xla_allow_excess_precision`` off (ROADMAP X2).
The port runs with remat, its default, through the band's one autograd
function and its plain backward.  ``gemma3-27b-smoke``, whose global
layers make it the slowest, is in ``tests/test_torch_band_loss_gemma3.py``
(the same test), so that ``--dist loadfile`` can spread the two.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import lm_units  # noqa: E402
from repro.data.synthetic import make_lm_corpus  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_numpy  # noqa: E402
from repro_torch.kernels.backend import fp32_numerics  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402

ARCHS = ("starcoder2-3b-smoke", "recurrentgemma-9b-smoke")
SEQ = 2048


def _at(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_through_the_band_match_reference(arch, dtype):
    check_loss_and_grads(arch, dtype)


def check_loss_and_grads(arch, dtype):
    fp32_numerics()
    cj = dataclasses.replace(jax_get_config(arch), compute_dtype=dtype)
    ct = dataclasses.replace(get_config(arch), compute_dtype=dtype)
    assert SEQ > ct.window + 1024
    mj, mt = jax_build(cj), build_model(ct)
    params = jax.tree.map(np.asarray, mj.init_params(jax.random.PRNGKey(3)))
    units = lm_units(make_lm_corpus(5, 2, SEQ, ct.vocab_size,
                                    noise_fraction=0.25), 2)
    batch = {k: v[0] for k, v in units.items()}
    batch["weights"] = np.asarray([1.0, 0.5], np.float32)
    jb = jax.tree.map(jnp.asarray, batch)
    opts = ({"xla_allow_excess_precision": False} if dtype == "bfloat16"
            else {})
    (loss_j, _), g_j = jax.jit(jax.value_and_grad(
        lambda p: mj.loss_fn(p, jb), has_aux=True)).lower(params).compile(
            compiler_options=opts)(params)
    live = tree_map(lambda x: x.clone().requires_grad_(True),
                    from_numpy(params))
    with torch.enable_grad():
        total, _ = mt.loss_fn(live, {k: torch.from_numpy(np.array(v))
                                     for k, v in batch.items()})
        grads = torch.autograd.grad(total, tree_leaves(live))
    by_id = {id(l): g for l, g in zip(tree_leaves(live), grads)}
    np.testing.assert_allclose(float(total.detach()), float(loss_j),
                               rtol=1e-5 if dtype == "float32" else 2e-2)
    n_leaves = 0
    for path, want in jax.tree_util.tree_leaves_with_path(g_j):
        got = by_id[id(_at(live, path))]
        assert got.dtype == torch.float32, path
        got, want = got.numpy(), np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, err_msg=str(path), rtol=0,
                                       atol=1e-4 * np.abs(want).max())
        else:
            assert _rel(got, want) < 2e-2, (path, _rel(got, want))
        n_leaves += 1
    assert n_leaves == len(tree_leaves(live))
