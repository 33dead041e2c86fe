"""PyTorch port, the level-1 lints (``repro_torch/analysis/lint.py`` and
its ``rules_*.py``): every rule fails on a violation fixture and passes
on a clean one, suppressions need a known rule and a justification, and
the whole rule set runs clean on ``src/repro_torch/`` (the CLI exits 0),
as ``tests/test_analysis.py`` holds the reference's lints."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

from repro_torch.analysis import lint  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# rule -> (path in the fixture tree, violating source, clean source)
FIXTURES = {
    "host-sync-graph": ("src/repro_torch/train/fx.py", """
        import torch

        def make_step():
            def step(x):
                return x * float(x.sum())
            return step

        class Engine:
            def __init__(self):
                self._step = make_step()

            def _body(self, x):
                y = self._step(x)
                return y.item()

            def capture(self, x):
                with torch.cuda.graph(self.g):
                    self._body(x)
        """, """
        import torch

        def make_step():
            def step(x):
                return x * x.sum() / x.shape[0]
            return step

        class Engine:
            def __init__(self):
                self._step = make_step()

            def _body(self, x):
                return self._step(x) + int(x.shape[0])

            def capture(self, x):
                with torch.cuda.graph(self.g):
                    self._body(x)
                return self._body(x).item()
        """),
    "host-sync-loop": ("src/repro_torch/serve/fx.py", """
        def drain(pool, n):
            out = []
            for i in range(n):
                out.append(pool[i].item())
            return out
        """, """
        import numpy as np

        def drain(pool, n):
            host = pool.cpu().numpy()
            return [float(host[i]) for i in range(n)]
        """),
    "global-rng": ("src/repro_torch/models/fx.py", """
        import torch

        def init(shape, w):
            torch.manual_seed(0)
            w.normal_()
            return torch.randn(shape) + torch.rand_like(w)
        """, """
        import torch

        def init(shape, w, gen):
            w.normal_(generator=gen)
            return torch.randn(shape, generator=gen) + torch.randint(
                0, 4, shape, generator=gen)
        """),
    "dtype-widen": ("src/repro_torch/core/fx.py", """
        import torch

        def acc(x):
            y = x.double() + torch.zeros(3, dtype=torch.float64)
            return y.to(torch.double), torch.ones(2, dtype=float)
        """, """
        import numpy as np
        import torch

        def acc(x):
            host = np.asarray([1.0], np.float64)
            return x.float() + torch.zeros(3, dtype=torch.float32), host
        """),
    "collective-cast-order": ("src/repro_torch/train/fx2.py", """
        import torch
        import torch.distributed as dist

        def mean(g, group):
            flat = g.reshape(-1)
            dist.all_reduce(flat, group=group)
            flat = flat / 2
            return flat.to(torch.bfloat16)
        """, """
        import torch
        import torch.distributed as dist

        def mean(g, group):
            flat = g.reshape(-1).to(torch.bfloat16)
            dist.all_reduce(flat, group=group)
            return (flat / 2).to(torch.float32)
        """),
    "kernel-no-fallback": ("src/repro_torch/kernels/fx/ops.py", """
        from repro_torch.kernels import backend
        from repro_torch.kernels.fx.ref import fx_ref

        def fx_op(x):
            if x.is_cuda:
                try:
                    return _launch(x)
                except RuntimeError:
                    return fx_ref(x)
            return fx_ref(x)
        """, """
        from repro_torch.kernels import backend
        from repro_torch.kernels.fx.ref import fx_ref

        def fx_op(x):
            if backend.shape_only(x):
                return x.new_empty(x.shape)
            if not backend.on_card(x):
                return fx_ref(x)
            try:
                return _launch(x)
            except RuntimeError as e:
                raise RuntimeError("fx failed") from e

        def gx_op(x):
            if backend.on_card(x):
                return _launch(x)
            return fx_ref(x)
        """),
    "ctypes-signature": ("src/repro_torch/kernels/fx/ops2.py", """
        import ctypes
        from repro_torch.kernels import backend

        def _launcher():
            fn = backend.library("fx").fx_launch
            fn.argtypes = [ctypes.c_void_p]
            return fn

        def direct(p):
            return backend.library("fx").fx_launch(p)
        """, """
        import ctypes
        from repro_torch.kernels import backend

        def _launcher():
            fn = backend.library("fx").fx_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
            fn.restype = ctypes.c_int
            return fn
        """),
    "noqa-hygiene": ("src/repro_torch/core/fx2.py", """
        def f(x):
            return x  # repro_torch: noqa[host-sync-loop]

        def g(x):
            return x  # repro_torch: noqa[no-such-rule] -- a reason
        """, '''
        def f(x):
            """Mentions `# repro_torch: noqa[x]` in a docstring only."""
            return x  # repro_torch: noqa[host-sync-loop] -- a reason
        '''),
}


def _lint(tmp_path, rule, rel, src):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(src))
    rules = lint.all_rules()
    return lint.run_lint(tmp_path, rules={rule: rules[rule]}, files=[path])


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_fails_on_its_violation_fixture(tmp_path, rule):
    rel, bad, _ = FIXTURES[rule]
    found = _lint(tmp_path, rule, rel, bad)
    assert found and {f.rule for f in found} == {rule}, found
    assert all(f.path == rel for f in found)


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_passes_on_its_clean_fixture(tmp_path, rule):
    rel, _, good = FIXTURES[rule]
    assert _lint(tmp_path, rule, rel, good) == []


def test_violations_found_in_full():
    """The fixtures' findings, line by line, for the rules with several
    violations in one fixture."""
    import tempfile
    want = {"global-rng": 4, "dtype-widen": 4, "kernel-no-fallback": 3,
            "ctypes-signature": 2, "noqa-hygiene": 2, "host-sync-graph": 2}
    with tempfile.TemporaryDirectory() as d:
        got = {r: len(_lint(Path(d), r, FIXTURES[r][0], FIXTURES[r][1]))
               for r in want}
    assert got == want


def test_a_justified_suppression_hides_a_finding(tmp_path):
    rel, bad, _ = FIXTURES["host-sync-loop"]
    src = bad.replace("out.append(pool[i].item())",
                      "out.append(pool[i].item())  # repro_torch: "
                      "noqa[host-sync-loop] -- a deliberate read")
    assert _lint(tmp_path, "host-sync-loop", rel, src) == []


def test_rule_paths_scope_the_rules(tmp_path):
    """host-sync-loop reads train/, serve/ and core/ only; the kernel
    rule reads kernels/*/ops.py only."""
    _, bad, _ = FIXTURES["host-sync-loop"]
    assert _lint(tmp_path, "host-sync-loop", "src/repro_torch/models/fx.py",
                 bad) == []
    _, bad, _ = FIXTURES["kernel-no-fallback"]
    assert _lint(tmp_path, "kernel-no-fallback",
                 "src/repro_torch/kernels/fx/ref.py", bad) == []


def test_the_port_runs_clean_and_its_suppressions_are_justified():
    findings = lint.run_lint(ROOT)
    assert findings == [], "\n".join(map(str, findings))
    sups = [s for p in lint.iter_python_files(ROOT)
            for s in lint.parse_suppressions(p.read_text())]
    assert sups and all(s.justified and s.rules for s in sups)
    assert {r for s in sups for r in s.rules} <= set(lint.all_rules())


def test_the_cli_exits_0_with_json_and_lists_the_rules():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--root", str(ROOT), "--json"],
                         capture_output=True, text=True, env=env, timeout=120)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    out = json.loads(run.stdout)
    assert out["version"] == lint.JSON_SCHEMA_VERSION
    assert out["findings"] == [] and out["counts"] == {}
    assert out["rules"] == sorted(FIXTURES)
    run = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--list"], capture_output=True, text=True, env=env,
                         timeout=120)
    assert run.returncode == 0
    assert len(run.stdout.strip().splitlines()) == len(FIXTURES)
