"""Level-1 static analysis of the port: AST lints over its invariants,
the counterpart of the reference's ``repro/analysis/lint.py``.

The port's engines rest on conventions that were each asserted once and
can rot silently: no host read inside a captured CUDA graph, explicit
generators only, collectives cast before the reduce, no fallback from a
kernel to its plain version, ctypes signatures set before a launch.
This module is the framework that turns them into rules:

  * a registry (``@register``); each rule is a pure function from a
    parsed source file to ``Finding``s;
  * per-line / per-file suppression with ``# repro_torch: noqa[rule]``
    followed by a one-line justification (a bare one is itself a
    finding, ``noqa-hygiene``);
  * human and JSON output (stable schema, ``JSON_SCHEMA_VERSION``);
  * a CLI, ``python -m repro_torch.analysis --root .``, which scans
    ``src/repro_torch/`` and exits non-zero on any finding.

Rules live in the ``rules_*.py`` siblings; ``contracts.py`` holds the
level-2 checkers over runs (captures, in-place state, host syncs, graph
nodes, collectives).  Adding a rule: write ``def check(sf: SourceFile)
-> list[Finding]``, decorate it with ``@register("my-rule", "one-line
doc")`` and import its module in ``all_rules``.
"""
from __future__ import annotations

import ast
import dataclasses
import fnmatch
import io
import json
import re
import sys
import tokenize
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

JSON_SCHEMA_VERSION = 1
PACKAGE = "src/repro_torch"

# suppression syntax: a comment of the form
#     "repro_torch: noqa[rule-a,rule-b] -- why this is deliberate"
_NOQA_RE = re.compile(r"#\s*repro_torch:\s*noqa\[([^\]]*)\](.*)$")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # repo-relative, '/'-separated
    line: int          # 1-indexed
    message: str

    def to_dict(self) -> Dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message}

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclasses.dataclass
class SourceFile:
    """A parsed python file handed to the rules."""
    path: str                    # repo-relative
    text: str
    tree: ast.Module


@dataclasses.dataclass(frozen=True)
class Rule:
    name: str
    doc: str                     # one line, shown by --list
    check: Callable              # SourceFile -> List[Finding]
    paths: Sequence[str] = ()    # fnmatch globs; empty = every file


_REGISTRY: Dict[str, Rule] = {}


def register(name: str, doc: str, *, paths: Sequence[str] = ()):
    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"duplicate rule {name!r}")
        _REGISTRY[name] = Rule(name=name, doc=doc, check=fn,
                               paths=tuple(paths))
        return fn
    return deco


def all_rules() -> Dict[str, Rule]:
    # imported for the registration side effect; cheap and idempotent
    from repro_torch.analysis import (rules_dtype,  # noqa: F401
                                      rules_host_sync, rules_kernels,
                                      rules_rng)
    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# suppression
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Suppression:
    line: int
    rules: List[str]
    justified: bool


def parse_suppressions(text: str) -> List[Suppression]:
    """Suppressions live in real comment tokens only: a docstring that
    mentions the syntax (this module's own) is not one."""
    try:
        comments = [(t.start[0], t.string) for t in
                    tokenize.generate_tokens(io.StringIO(text).readline)
                    if t.type == tokenize.COMMENT]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        comments = list(enumerate(text.splitlines(), start=1))
    out = []
    for i, comment in comments:
        m = _NOQA_RE.search(comment)
        if m:
            rules = [r.strip() for r in m.group(1).split(",") if r.strip()]
            just = m.group(2).strip().lstrip("-—: ").strip()
            out.append(Suppression(line=i, rules=rules, justified=bool(just)))
    return out


def _is_suppressed(f: Finding, sups: List[Suppression]) -> bool:
    return any(f.rule in s.rules and s.line in (f.line, 1) for s in sups)


def check_noqa_hygiene(path: str, text: str,
                       known: Sequence[str]) -> List[Finding]:
    """``noqa-hygiene``: every suppression names a registered rule and
    carries an inline justification."""
    out = []
    for s in parse_suppressions(text):
        for r in s.rules:
            if r not in known:
                out.append(Finding("noqa-hygiene", path, s.line,
                                   f"suppression names unknown rule {r!r}"))
        if not s.rules:
            out.append(Finding("noqa-hygiene", path, s.line,
                               "suppression lists no rules"))
        if not s.justified:
            out.append(Finding(
                "noqa-hygiene", path, s.line,
                "suppression lacks a justification (write `# repro_torch: "
                "noqa[rule] -- why this is deliberate`)"))
    return out


# `noqa-hygiene` registers so that it is in the catalog; it runs inside
# `run_lint`, which sees the suppression comments
register("noqa-hygiene",
         "every `# repro_torch: noqa[rule]` names a known rule and carries "
         "an inline justification")(lambda sf: [])


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

def _rule_applies(rule: Rule, relpath: str) -> bool:
    return not rule.paths or any(fnmatch.fnmatch(relpath, pat)
                                 for pat in rule.paths)


def iter_python_files(root: Path) -> List[Path]:
    return sorted((root / PACKAGE).rglob("*.py"))


def run_lint(root: Path, rules: Optional[Dict[str, Rule]] = None,
             files: Optional[Sequence[Path]] = None) -> List[Finding]:
    """Run ``rules`` (default: the whole registry) over the port at
    ``root``, or over ``files`` (the fixture tests).  Suppressions are
    applied here, after the rules ran; ``noqa-hygiene`` checks every
    scanned file whenever it is among ``rules``."""
    rules = all_rules() if rules is None else rules
    known = sorted(all_rules())
    findings: List[Finding] = []
    for path in (list(files) if files is not None
                 else iter_python_files(root)):
        path = Path(path)
        try:
            rel = path.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = path.as_posix()
        text = path.read_text()
        try:
            tree = ast.parse(text, filename=str(path))
        except SyntaxError as e:
            findings.append(Finding("syntax", rel, e.lineno or 1, str(e)))
            continue
        sf = SourceFile(path=rel, text=text, tree=tree)
        sups = parse_suppressions(text)
        for rule in rules.values():
            if _rule_applies(rule, rel):
                findings += [f for f in rule.check(sf)
                             if not _is_suppressed(f, sups)]
        if "noqa-hygiene" in rules:
            findings += check_noqa_hygiene(rel, text, known)
    return sorted(set(findings), key=lambda f: (f.path, f.line, f.rule,
                                                f.message))


def to_json(findings: Sequence[Finding],
            rules: Optional[Dict[str, Rule]] = None) -> Dict:
    rules = all_rules() if rules is None else rules
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return {"version": JSON_SCHEMA_VERSION, "rules": sorted(rules),
            "findings": [f.to_dict() for f in findings], "counts": counts}


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's static lints (src/repro_torch/)")
    p.add_argument("--root", default=".", help="repo root (default: cwd)")
    p.add_argument("--json", action="store_true", help="machine output")
    p.add_argument("--list", action="store_true", dest="list_rules",
                   help="print the rule catalog and exit")
    p.add_argument("--rule", action="append", default=None,
                   help="run only these rules (repeatable)")
    args = p.parse_args(argv)

    rules = all_rules()
    if args.list_rules:
        for name in sorted(rules):
            print(f"{name}: {rules[name].doc}")
        return 0
    if args.rule:
        unknown = set(args.rule) - set(rules)
        if unknown:
            p.error(f"unknown rule(s): {sorted(unknown)}")
        rules = {n: rules[n] for n in args.rule}
    root = Path(args.root).resolve()
    if not (root / PACKAGE).is_dir():
        p.error(f"{root} holds no {PACKAGE}/")
    findings = run_lint(root, rules=rules)
    if args.json:
        print(json.dumps(to_json(findings, rules), indent=2))
    else:
        for f in findings:
            print(f)
        print(f"repro_torch.analysis: {len(findings)} finding(s), "
              f"{len(rules)} rule(s) active")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
