"""PyTorch port, the encoder-decoder family (``seamless-m4t-medium``)
against the JAX reference on the CPU, on ``seamless-m4t-medium-smoke``
(2 encoder and 2 decoder layers, d 64) with the reference's params
carried across and norm gammas drawn off zero (``torch_family_helpers``
states the bars):

- configs (every field, ``n_params``), the port's init (the reference's
  tree; ``n_params`` is the leaves less the norms), ``make_batch``'s
  keys, shapes and dtypes, params and cache round trips bit for bit;
- ``per_example_loss``, ``loss_fn`` (aux 0) and every gradient leaf
  against ``jax.grad``, fp32 and bf16; ``final_hidden``;
- prefill logits and the converted cache (self K/V, ``ck``/``cv``), then
  8 decode steps, fp32 and bf16: in bf16 a decode step reads the
  decoder's norm gammas uncast where ``encode``/``decode_train`` round
  them (ED1), so the serving weights keep them fp32 and give the
  masters' logits bit for bit;
- ``generate`` with ``frames`` token for token and logits per step;
- ``train_with_selection`` on the host engine, the scan engine and with
  resident rounds against the reference's on units stacked from its
  ``make_batch``, and stage A with ``frames`` in each chunk;
- the refusals (ROADMAP S12): ``SlotEngine``, the train launcher and the
  serve launcher's one-shot path, each a ``ValueError``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

import torch_family_helpers as fam  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models.api import EncDecBundle, build_model  # noqa: E402
from repro_torch.serve.engine import SlotEngine  # noqa: E402

ARCH = "seamless-m4t-medium-smoke"


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", ARCH])
def test_configs_match_reference(arch):
    fam.check_config(arch)


def test_full_width_counts():
    cfg = get_config("seamless-m4t-medium")
    assert (cfg.n_enc_layers, cfg.n_layers, cfg.d_model, cfg.vocab_size) \
        == (12, 12, 1024, 256206)
    assert cfg.n_params() == 614_676_480


def test_init_has_the_reference_tree():
    fam.check_init(ARCH)


def test_make_batch_matches_reference():
    fam.check_make_batch(ARCH)
    batch = build_model(get_config(ARCH)).make_batch(
        torch.Generator().manual_seed(0), 2, 1024)
    assert tuple(batch["frames"].shape) == (2, 512, 64)
    assert tuple(batch["tokens"].shape) == (2, 512)


def test_params_and_cache_round_trip():
    fam.check_roundtrip(ARCH)


def test_init_cache_matches_reference():
    """``init_cache(src_len=...)``: the reference's empty cache in the
    port's layout, leaf for leaf (zeros, positions -1)."""
    import jax
    from repro.models.api import build_model as jax_build
    from repro_torch.convert import cache_from_numpy
    from repro_torch.models.common import tree_leaves

    cj, ct = fam.cfgs(ARCH)
    want = cache_from_numpy(jax.tree.map(
        np.asarray, jax_build(cj).init_cache(2, 30, src_len=12)))
    got = build_model(ct).init_cache(2, 30, src_len=12)
    assert tuple(got["ck"].shape) == (2, ct.n_layers, 12, ct.n_kv_heads,
                                      ct.head_dim)
    assert len(tree_leaves(got)) == len(tree_leaves(want))
    for a, w in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == w.dtype and torch.equal(a, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_reference(dtype):
    fam.check_loss_and_grads(ARCH, dtype)


def test_final_hidden_matches_reference():
    fam.check_final_hidden(ARCH)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    fam.check_prefill_and_decode(ARCH, dtype)


def test_generate_matches_reference():
    fam.check_generate(ARCH)


def test_serving_weights_keep_the_decode_norms_fp32():
    fam.check_serving_weights(ARCH, fp32_norms=(("decoder",),
                                                ("enc_norm",),
                                                ("final_norm",)))


@pytest.fixture(scope="module")
def history():
    return fam.history_setup(ARCH)


@pytest.mark.parametrize("engine,resident", [("host", False),
                                             ("scan", False),
                                             ("scan", True)])
def test_history_matches_reference(history, engine, resident):
    fam.check_history(history, ARCH, engine, resident)


def test_stage_a_matches_reference(history):
    fam.check_stage_a(history, ARCH)


def test_refusals():
    bundle = build_model(get_config(ARCH))
    assert isinstance(bundle, EncDecBundle)
    params = bundle.init_params(torch.Generator().manual_seed(0),
                                torch.device("cpu"))
    with pytest.raises(ValueError, match="SlotEngine"):
        SlotEngine(bundle, params)
    with pytest.raises(ValueError, match="S12"):
        train_launcher.main(["--arch", ARCH, "--device", "cpu"])
    with pytest.raises(ValueError, match="S12"):
        serve_launcher.main(["--arch", ARCH, "--device", "cpu"])
    with pytest.raises(ValueError, match="SlotEngine"):
        serve_launcher.main(["--arch", ARCH, "--engine", "slots",
                             "--device", "cpu"])
    import dataclasses
    with pytest.raises(ValueError, match="n_enc_layers"):
        build_model(dataclasses.replace(get_config(ARCH), n_enc_layers=0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(dataclasses.replace(get_config(ARCH),
                                        pattern=("local",), window=16))
