"""repro_torch.analysis: the port's static contracts.

Level 1 (``lint``): AST lints over ``src/repro_torch/``
(``python -m repro_torch.analysis --root .``), held to violation and
clean fixtures by ``tests/test_torch_lint.py``.

Level 2 (``contracts``): checkers over the port's runs (captures,
in-place state, host syncs, captured graphs' nodes, collectives), which
the tests and ``chip_smoke.py`` turn on the engines.
"""
from repro_torch.analysis.lint import (JSON_SCHEMA_VERSION, Finding, Rule,
                                       all_rules, run_lint, to_json)

__all__ = ["Finding", "JSON_SCHEMA_VERSION", "Rule", "all_rules",
           "run_lint", "to_json"]
