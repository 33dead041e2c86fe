"""A training step's loss and gradients on the CPU are bitwise repeatable
with several intra-op threads (F5).

The port gathers token embeddings with ``F.embedding``, whose CPU backward
sums each token's rows in a fixed order however many threads run it;
the indexing it replaced (``w[tokens]``) summed them with ``index_put_``,
whose order varied between runs with four threads, so the ``embed.w``
gradient of a ``starcoder2-3b-smoke`` step differed by a few 1e-9.  Each
test sets four intra-op threads and restores the file's setting
(``tests/torch_threads.py``, one thread) afterwards.  Parity with the
reference is held elsewhere (``tests/test_torch_lm.py``,
``tests/test_torch_rnnt.py``) at its own bars."""
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import asr_units  # noqa: E402
from repro_torch.data.synthetic import make_asr_corpus  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.train.engine import to_device  # noqa: E402

THREADS = 4


@pytest.fixture
def four_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


def _loss_and_grads(bundle, params, batch, **kw):
    live = tree_map(lambda x: x.detach().requires_grad_(True), params)
    total, _ = bundle.loss_fn(live, batch, **kw)
    return total.detach(), torch.autograd.grad(total, tree_leaves(live))


def _twice_bitwise(bundle, params, batch, **kw):
    runs = [_loss_and_grads(bundle, params, batch, **kw) for _ in range(2)]
    assert torch.get_num_threads() == THREADS
    assert len(runs[0][1]) == len(tree_leaves(params))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(x, y) for x, y in zip(runs[0][1], runs[1][1]))


def test_lm_step_is_bitwise_with_four_threads(four_threads):
    """``starcoder2-3b-smoke`` at B 2, S 2,048 (past its band's start),
    without remat: two runs, the loss and every gradient leaf bit for
    bit."""
    b = build_model(get_config("starcoder2-3b-smoke"))
    params = b.init_params(torch.Generator().manual_seed(0),
                           torch.device("cpu"))
    toks = torch.randint(0, b.cfg.vocab_size, (2, 2048), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    _twice_bitwise(b, params, {"tokens": toks}, remat=False)


def test_rnnt_step_is_bitwise_with_four_threads(four_threads):
    """``rnnt-crdnn-smoke`` on one unit of 4 utterances (the fused loss):
    two runs, the loss and every gradient leaf bit for bit.  (At this
    size the prediction net's indexing gather was repeatable too, up to
    units of 32: its vocabulary and label count are small.)"""
    cfg = get_config("rnnt-crdnn-smoke")
    b = build_model(cfg)
    params = b.init_params(torch.Generator().manual_seed(0),
                           torch.device("cpu"))
    units = asr_units(make_asr_corpus(0, 4, n_feats=cfg.rnnt.n_feats,
                                      vocab_size=cfg.rnnt.vocab_size,
                                      noise_fraction=0.25), 4)
    batch = {k: v[0] for k, v in to_device(units,
                                           torch.device("cpu")).items()}
    _twice_bitwise(b, params, batch)
