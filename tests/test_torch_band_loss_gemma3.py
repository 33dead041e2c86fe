"""PyTorch port, training through the band on the CPU:
``gemma3-27b-smoke``'s loss and every gradient leaf at B 2, S 2,048,
against ``jax.value_and_grad`` of the reference's ``loss_fn``, at the bars
of ``tests/test_torch_band_loss.py`` (a file of its own: its two global
layers' S x S scores make it the slowest of the three band archs)."""
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

from test_torch_band_loss import check_loss_and_grads  # noqa: E402


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_through_the_band_match_reference(dtype):
    check_loss_and_grads("gemma3-27b-smoke", dtype)
