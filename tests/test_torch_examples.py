"""PyTorch port, the twins of the reference's ``examples/quickstart.py``,
``examples/train_lm_pgm.py`` and ``examples/serve_lm.py``
(``repro_torch/examples/``) against the reference examples' ``main`` on
their default smoke archs, on the CPU, and the launcher's
``--selection-kernels``.

Each reference example runs as written (its own corpora, settings and
engine), its initial draws handed to the twin (H4): the same subset in
every PGM round, per-epoch losses and the round's weights within rtol
1e-3 (fp32 drift over epochs at lr 0.5 reaches 2-4e-4), the same greedy
tokens from ``generate`` and the slot engine, and printed lines of the
same shape (numbers masked).  ``random`` draws from the port's own
generator, so it is held by its invariants.  ``--selection-kernels``
(``PGMConfig.kernel_impl``) parses ``auto``, ``pallas`` and ``xla`` in
the launcher and the ``train_lm_pgm`` twin, reaches the config, and
changes no CPU result (every value runs the plain versions there)."""
import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.lastlayer import make_proj_for as jax_make_proj  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro_torch.configs.base import PGMConfig, TrainConfig  # noqa: E402
from repro_torch.convert import from_numpy  # noqa: E402
from repro_torch.examples import quickstart, serve_lm  # noqa: E402
from repro_torch.examples import train_lm_pgm  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402
from repro_torch.kernels.backend import fp32_numerics  # noqa: E402
from repro_torch.kernels.grad_sketch.ops import grad_sketch_units_op  # noqa: E402
from repro_torch.kernels.omp_gram.ops import omp_gram_batched_op  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NUM = re.compile(r"-?\d+(\.\d+)?|nan")


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_draws(arch, k, seed=0):
    """The reference loop's initial params and projections for a seed."""
    mj = jax_build(jax_get_config(arch))
    key = jax.random.PRNGKey(seed)
    params = jax.tree.map(np.asarray, mj.init_params(key))
    proj = [np.asarray(x) for x in jax_make_proj(
        mj, jax.random.fold_in(key, 17), k, k)]
    return params, proj


def _shape(line):
    return NUM.sub("#", line.strip())


def _run_reference(monkeypatch, capsys, name, argv, record):
    """Run the reference example's ``main`` with ``argv``, recording the
    calls named in ``record`` ({attribute: list}) -> its printed lines."""
    ref = _reference_example(name)
    for attr, seen in record.items():
        orig = getattr(ref, attr)

        def wrapped(*a, _orig=orig, _seen=seen, **kw):
            out = _orig(*a, **kw)
            _seen.append((a, kw, out))
            return out
        monkeypatch.setattr(ref, attr, wrapped)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    ref.main()
    return capsys.readouterr().out.rstrip("\n").splitlines()


def _same_run(h_t, h_j):
    assert len(h_t.selections) == len(h_j.selections)
    for st, sj in zip(h_t.selections, h_j.selections):
        assert st["epoch"] == sj["epoch"]
        assert st["indices"] == sj["indices"], (st, sj)
        # the weights are a function of the trained params, so they carry
        # the losses' drift (2.7e-4 in quickstart's second round)
        np.testing.assert_allclose(st["weights"], sj["weights"], rtol=1e-3)
    np.testing.assert_allclose(h_t.train_loss, h_j.train_loss, rtol=1e-3)
    np.testing.assert_allclose(h_t.val_loss, h_j.val_loss, rtol=1e-3)
    np.testing.assert_allclose(h_t.lr, h_j.lr, rtol=1e-6)
    assert h_t.cost_units == pytest.approx(h_j.cost_units)


def test_quickstart_twin_matches_reference(monkeypatch, capsys):
    fp32_numerics()
    runs = []
    ref_lines = _run_reference(monkeypatch, capsys, "quickstart", [],
                               {"train_with_selection": runs})
    hist_j = {kw["method"]: out for _, kw, out in runs}
    params, proj = _reference_draws(quickstart.ARCH, 32)
    lines = []
    hist_t = quickstart.run(device="cpu", params=params, proj=proj,
                            log_fn=lines.append)
    assert list(hist_t) == list(hist_j) == ["pgm", "random", "full"]
    _same_run(hist_t["pgm"], hist_j["pgm"])
    _same_run(hist_t["full"], hist_j["full"])
    assert [s["epoch"] for s in hist_t["random"].selections] == \
        [s["epoch"] for s in hist_j["random"].selections] == [1, 3]
    for s in hist_t["random"].selections:
        assert len(set(s["indices"])) == len(s["indices"]) == 4
        assert s["weights"] == [1.0] * 4
    assert hist_t["random"].cost_units == pytest.approx(
        hist_j["random"].cost_units)
    text = "\n".join(lines).splitlines()
    assert [_shape(l) for l in text] == [_shape(l) for l in ref_lines]
    for method in ("pgm", "full"):
        want = next(l for l in ref_lines if l.startswith(f"{method:7s}:"))
        got = next(l for l in text if l.startswith(f"{method:7s}:"))
        assert got.split(", cost")[1] == want.split(", cost")[1]
    assert text[-1] == ref_lines[-1]          # the speedup line


def test_train_lm_pgm_twin_matches_reference(monkeypatch, capsys):
    """At ``--n 32 --epochs 4`` (the reference example's own flags).  At
    its defaults (96 examples, 6 epochs at lr 0.5) the run is chaotic:
    the reference against itself with its initial params scaled by 1 +
    1e-7 moves its epoch-5 training loss by 2.4e-2 (epoch 1: 1.0e-3),
    so no second implementation can be held to 1e-3 there; at these
    flags the same perturbation moves it by 6.3e-5."""
    fp32_numerics()
    runs = []
    ref_lines = _run_reference(monkeypatch, capsys, "train_lm_pgm",
                               ["--n", "32", "--epochs", "4"],
                               {"train_with_selection": runs})
    (_, _, h_j), = runs
    params, proj = _reference_draws("starcoder2-3b-smoke", 32)
    lines = []
    h_t = train_lm_pgm.run(n=32, epochs=4, device="cpu", params=params,
                           proj=proj, log_fn=lines.append)
    assert len(h_t.selections) == 2
    _same_run(h_t, h_j)
    text = "\n".join(lines).splitlines()
    assert [_shape(l) for l in text] == [_shape(l) for l in ref_lines]
    # the final line: cost and rounds (the loss is held above)
    assert text[-1].split(", cost")[1] == ref_lines[-1].split(", cost")[1]


def test_serve_lm_twin_matches_reference(monkeypatch, capsys):
    fp32_numerics()
    gens, engines = [], []
    ref = _reference_example("serve_lm")
    orig_generate, orig_engine = ref.generate, ref.SlotEngine

    def record_generate(*a, **kw):
        out = orig_generate(*a, **kw)
        gens.append((a, out))
        return out

    class RecordEngine(orig_engine):
        def run(self, reqs):
            comps = super().run(reqs)
            engines.append(comps)
            return comps

    monkeypatch.setattr(ref, "generate", record_generate)
    monkeypatch.setattr(ref, "SlotEngine", RecordEngine)
    monkeypatch.setattr(sys, "argv", ["serve_lm.py"])
    ref.main()
    ref_lines = capsys.readouterr().out.strip().splitlines()
    (args, (toks_j, stats_j)), = gens
    params_j, prompts_j = args[1], np.asarray(args[2])
    assert prompts_j.shape == (4, 16)
    lines = []
    toks_t, stats_t, comps_t = serve_lm.serve(
        device="cpu", params=from_numpy(jax.tree.map(np.asarray, params_j)),
        prompts=prompts_j, log_fn=lines.append)
    np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))
    for f in ("prompt_tokens", "prefill_tokens", "decode_tokens",
              "decode_steps"):
        assert getattr(stats_t, f) == getattr(stats_j, f), f
    (comps_j,), = [engines]
    assert {c.uid: list(c.tokens) for c in comps_t} == \
        {c.uid: [int(t) for t in c.tokens] for c in comps_j}
    assert len(lines) == len(ref_lines) == 4
    assert lines[0] == ref_lines[0]           # arch and token shape
    assert lines[2] == ref_lines[2]           # the sample tokens
    # the stats line up to the rate; the slot line up to the wall time
    assert _shape(lines[1]).split(" tok/s")[0] == \
        _shape(ref_lines[1]).split(" tok/s")[0]
    assert _shape(lines[3]) == _shape(ref_lines[3])


def test_serve_lm_twin_refuses_the_vlm_family(monkeypatch):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("gemma3-27b-smoke"), family="vlm")
    monkeypatch.setattr(serve_lm, "get_config", lambda name: cfg)
    with pytest.raises(NotImplementedError, match="item 9"):
        serve_lm.serve(device="cpu")


@pytest.mark.parametrize("impl", ["auto", "pallas", "xla"])
def test_selection_kernels_flag_reaches_the_config(monkeypatch, impl):
    seen = {}

    def record(bundle, units, tc, **kw):
        seen["tc"] = tc
        return launcher.History()

    monkeypatch.setattr(launcher, "train_with_selection", record)
    launcher.main(["--arch", "starcoder2-3b-smoke", "--n", "16", "--device",
                   "cpu", "--selection-kernels", impl])
    assert seen["tc"].pgm.kernel_impl == impl
    monkeypatch.setattr(train_lm_pgm, "train_with_selection", record)
    train_lm_pgm.main(["--device", "cpu", "--n", "16",
                       "--selection-kernels", impl])
    assert seen["tc"].pgm.kernel_impl == impl


def test_selection_kernels_default_and_bad_value(monkeypatch):
    seen = {}
    monkeypatch.setattr(launcher, "train_with_selection",
                        lambda b, u, tc, **kw: seen.update(tc=tc)
                        or launcher.History())
    launcher.main(["--arch", "starcoder2-3b-smoke", "--n", "16", "--device",
                   "cpu"])
    assert seen["tc"].pgm.kernel_impl == "auto"
    with pytest.raises(SystemExit):
        launcher.main(["--arch", "starcoder2-3b-smoke", "--device", "cpu",
                       "--selection-kernels", "triton"])
    with pytest.raises(ValueError, match="kernel_impl"):
        backend.use_kernel("triton", torch.zeros(1))
    assert not any(backend.use_kernel(i, torch.zeros(1))
                   for i in backend.KERNEL_IMPLS)


def test_selection_kernels_change_no_cpu_result():
    """The LM and RNN-T launch paths, host and resident stage A, under
    each value: the same subsets and bitwise the same losses; no kernel
    launch is counted on the CPU."""
    fp32_numerics()
    grad_sketch_units_op.launches = omp_gram_batched_op.launches = 0
    for arch, extra in (("starcoder2-3b-smoke", {}),
                        ("rnnt-crdnn-smoke", dict(optimizer="adamw",
                                                  lr=0.05))):
        runs = {}
        for impl in ("auto", "pallas", "xla"):
            for resident in (False, True):
                tc = TrainConfig(epochs=3, **{"lr": 0.5, **extra},
                                 pgm=PGMConfig(
                                     subset_fraction=0.5, n_partitions=2,
                                     select_every=1, warm_start_epochs=1,
                                     val_matching=True, kernel_impl=impl))
                h = launcher.launch_train(
                    arch, tc, n=16, noise=0.25, device="cpu",
                    resident_selection=resident)
                runs[impl, resident] = (
                    [(s["indices"], s["weights"]) for s in h.selections],
                    h.train_loss, h.val_loss)
        first = runs["auto", False]
        assert len(first[0]) == 2
        assert all(r == first for r in runs.values()), arch
    assert grad_sketch_units_op.launches == omp_gram_batched_op.launches == 0
