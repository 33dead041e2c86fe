"""Kernel-wrapper hygiene.

``kernel-no-fallback`` (the reference's ``pallas-interpret``, whose
invariant is that what the tests check is what ships): in a
``kernels/*/ops.py`` wrapper a card tensor always reaches the kernel,
and a failed build or launch raises.  So (a) no ``try`` around
``backend.library`` or a launch (a ``_launch*`` / ``_launcher`` call, a
``data_ptr()``) whose handlers do not re-raise, and (b) every call of a
plain version (a name imported from a ``ref`` module, a local
``_plain*`` / ``*_ref`` function, a ``*Plain*`` autograd function,
whose own methods are plain-route code) sits in the branch that a route test
(``backend.on_card`` / ``backend.use_kernel``) sends the CPU, or a user's
``kernel_impl="xla"``, to: the body of ``if not on_card(...)`` /
``if not use_kernel(...)``, the ``else`` of a positive test, or after a
positive test whose body returns.  Any other test (``x.is_cuda``, a
``try``) would choose the route itself.

``ctypes-signature`` (the reference's ``pallas-blockspec``, whose
invariant is a correct launch interface): every function taken from
``backend.library(...)`` has ``argtypes`` and ``restype`` set before it
is called or returned.  Without ``argtypes`` ctypes passes a Python int
as a C ``int``, which truncates a 64-bit device pointer; without
``restype`` the launch status is read as ``int`` whatever the C type.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch.analysis.astutil import call_name
from repro_torch.analysis.lint import Finding, SourceFile, register

_ROUTE_TESTS = ("on_card", "use_kernel")


def _plain_names(tree: ast.Module) -> Set[str]:
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.rsplit(".", 1)[-1] == "ref":
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                (node.name.startswith("_plain") or
                 node.name.endswith("_ref")):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef) and "Plain" in node.name:
            names.add(node.name)
    return names - {"CHUNK", "NEG"}


def _route_test(test: ast.AST) -> Optional[bool]:
    """True for ``on_card(...)`` / ``use_kernel(...)`` (card route),
    False for their negation, None for any other test.  A conjunction
    ``not shape_only(...) and not on_card(...)`` is the negation."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        inner = _route_test(test.operand)
        return None if inner is None else not inner
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        got = [_route_test(v) for v in test.values]
        if False in got:
            return False
        return None
    if isinstance(test, ast.Call):
        name = call_name(test) or ""
        if name.rsplit(".", 1)[-1] in _ROUTE_TESTS:
            return True
        if name.rsplit(".", 1)[-1] == "shape_only":
            return None
    return None


def _guarded_calls(body: List[ast.stmt], plain: bool, out: Dict[int, bool]):
    """Record for each call under ``body`` whether the route is the plain
    one there (``plain``), following ``if`` route tests and early
    returns."""
    after_card_return = False
    for stmt in body:
        here = plain or after_card_return
        if isinstance(stmt, ast.If):
            r = _route_test(stmt.test)
            for n in ast.walk(stmt.test):
                out.setdefault(id(n), here)
            if r is None:
                _guarded_calls(stmt.body, here, out)
                _guarded_calls(stmt.orelse, here, out)
            else:
                _guarded_calls(stmt.body, here or not r, out)
                _guarded_calls(stmt.orelse, here or r, out)
                if r and stmt.body and isinstance(stmt.body[-1], ast.Return):
                    after_card_return = True
            continue
        if isinstance(stmt, (ast.With, ast.For, ast.While, ast.Try)):
            for n in ast.iter_child_nodes(stmt):
                if not isinstance(n, ast.stmt):
                    for m in ast.walk(n):
                        out.setdefault(id(m), here)
            for block in ("body", "orelse", "finalbody"):
                _guarded_calls(getattr(stmt, block, []), here, out)
            for h in getattr(stmt, "handlers", []):
                _guarded_calls(h.body, here, out)
            continue
        for n in ast.walk(stmt):
            out.setdefault(id(n), here)


def _is_launch(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = call_name(node) or ""
    short = name.rsplit(".", 1)[-1]
    return name.endswith("backend.library") or short.startswith("_launch") \
        or short == "data_ptr" or short.endswith("_launcher")


def _reraises(handler: ast.ExceptHandler) -> bool:
    return any(isinstance(n, ast.Raise) for n in ast.walk(handler))


@register("kernel-no-fallback",
          "kernels/*/ops.py: no try/except around a build or launch that "
          "does not re-raise; a plain version only where a route test "
          "(backend.on_card / use_kernel) sends the CPU",
          paths=("src/repro_torch/kernels/*/ops.py",))
def check_kernel_no_fallback(sf: SourceFile) -> List[Finding]:
    out = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Try) and any(
                _is_launch(n) for s in node.body for n in ast.walk(s)):
            for h in node.handlers:
                if not _reraises(h):
                    out.append(Finding(
                        "kernel-no-fallback", sf.path, h.lineno,
                        "an except around a kernel build or launch that "
                        "does not re-raise: a failure must not fall back"))
    plain = _plain_names(sf.tree)
    inside_plain = {id(d) for c in ast.walk(sf.tree)
                    if isinstance(c, ast.ClassDef) and c.name in plain
                    for d in ast.walk(c)}
    for fn in ast.walk(sf.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) or \
                fn.name in plain or id(fn) in inside_plain:
            continue
        routes: Dict[int, bool] = {}
        _guarded_calls(fn.body, False, routes)
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and \
                    (call_name(node) or "").split(".")[0] in plain and \
                    not routes.get(id(node), False):
                out.append(Finding(
                    "kernel-no-fallback", sf.path, node.lineno,
                    f"plain version `{call_name(node)}` is reachable "
                    f"without a route test (backend.on_card / use_kernel) "
                    f"sending the CPU there: a card tensor could take it"))
    return out


@register("ctypes-signature",
          "every function taken from backend.library(...) has argtypes and "
          "restype set before it is called or returned")
def check_ctypes_signature(sf: SourceFile) -> List[Finding]:
    out = []
    for fn in ast.walk(sf.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        taken: Dict[str, int] = {}
        set_attrs: Dict[str, Set[str]] = {}
        for stmt in sorted((n for n in ast.walk(fn)
                            if isinstance(n, ast.stmt) and n is not fn),
                           key=lambda n: n.lineno):
            # uses first: a call or return of a name taken earlier
            for node in ast.walk(stmt):
                used = None
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Name):
                    used = node.func.id
                elif isinstance(node, ast.Return) and \
                        isinstance(node.value, ast.Name):
                    used = node.value.id
                if used in taken and \
                        set_attrs[used] != {"argtypes", "restype"}:
                    missing = {"argtypes", "restype"} - set_attrs[used]
                    out.append(Finding(
                        "ctypes-signature", sf.path, node.lineno,
                        f"`{used}` from backend.library is used before "
                        f"its {sorted(missing)} are set"))
                    set_attrs[used] = {"argtypes", "restype"}
                # a symbol called straight off the library
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        isinstance(node.func.value, ast.Call) and \
                        (call_name(node.func.value) or "").endswith(
                            "library"):
                    out.append(Finding(
                        "ctypes-signature", sf.path, node.lineno,
                        "a backend.library symbol called without argtypes "
                        "and restype"))
            if isinstance(stmt, ast.Assign):
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name) and \
                            isinstance(stmt.value, ast.Attribute) and \
                            isinstance(stmt.value.value, ast.Call) and \
                            (call_name(stmt.value.value) or "").endswith(
                                "library"):
                        taken[tgt.id] = stmt.lineno
                        set_attrs[tgt.id] = set()
                    elif isinstance(tgt, ast.Attribute) and \
                            isinstance(tgt.value, ast.Name) and \
                            tgt.value.id in taken and \
                            tgt.attr in ("argtypes", "restype"):
                        set_attrs[tgt.value.id].add(tgt.attr)
        for name, line in taken.items():
            if set_attrs[name] != {"argtypes", "restype"}:
                out.append(Finding(
                    "ctypes-signature", sf.path, line,
                    f"`{name}` from backend.library never gets "
                    f"{sorted({'argtypes', 'restype'} - set_attrs[name])}"))
    return out
