"""Shared AST helpers for the port's lint rules (a copy of the
reference's ``repro/analysis/astutil.py``)."""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Tuple

HOST_BUILTINS = {"len", "int", "float", "bool", "str", "range", "min", "max",
                 "sorted", "sum", "abs", "round", "enumerate", "zip", "list",
                 "tuple", "dict", "set"}


def dotted(node: ast.AST) -> Optional[str]:
    """``torch.cuda.graph`` -> "torch.cuda.graph"; None for non-name
    trees."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def root_name(node: ast.AST) -> Optional[str]:
    """Leftmost Name of an attribute/subscript/call chain, else None."""
    while True:
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, (ast.Attribute, ast.Starred)):
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        else:
            return None


def functions(tree: ast.AST) -> Iterator[ast.AST]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def call_name(call: ast.Call) -> Optional[str]:
    return dotted(call.func)


def param_names(fn) -> List[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def assign_targets(stmt) -> List[Tuple[str, ast.AST]]:
    """(name, value) pairs for simple / tuple-unpacking assignments."""
    pairs: List[Tuple[str, ast.AST]] = []
    if isinstance(stmt, ast.Assign):
        for tgt in stmt.targets:
            if isinstance(tgt, ast.Name):
                pairs.append((tgt.id, stmt.value))
            elif isinstance(tgt, (ast.Tuple, ast.List)):
                for elt in tgt.elts:
                    if isinstance(elt, ast.Name):
                        pairs.append((elt.id, stmt.value))
    elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None and \
            isinstance(stmt.target, ast.Name):
        pairs.append((stmt.target.id, stmt.value))
    elif isinstance(stmt, ast.AugAssign) and isinstance(stmt.target, ast.Name):
        pairs.append((stmt.target.id, stmt.value))
    return pairs
