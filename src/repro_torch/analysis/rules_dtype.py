"""dtype drift.

``dtype-widen`` (the reference's rule of that name): device code in the
port is fp32 (masters, accumulators) and bf16 (compute, wire, kernel
inputs) by contract.  ``torch.float64`` / ``torch.double``, ``.double()``
or ``dtype=float`` (Python's float is float64 to PyTorch) double the
memory and leave the kernels, which take fp32 and bf16 only.  Host-side
numpy float64 (the loss logs) is exempt: the rule reads torch only.

``collective-cast-order`` (the reference's rule of that name): a
narrowing cast of a tensor after it went through ``dist.all_reduce`` /
``reduce_scatter`` / ``all_gather`` in the same function means the
collective already moved the wide bytes; the cast belongs before the
reduce, as ``train/compress.py`` does it (hazard D3).  Widening after
the reduce (bf16 back to fp32) is the right pattern and is not flagged.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from repro_torch.analysis.astutil import call_name, root_name
from repro_torch.analysis.lint import Finding, SourceFile, register

_WIDE_ATTRS = {"float64", "double", "complex128", "cdouble"}
_NARROW = {"bfloat16", "float16", "half", "int8", "uint8",
           "float8_e4m3fn", "float8_e5m2"}
_NARROW_METHODS = {"bfloat16", "half"}
_COLLECTIVES = {"all_reduce", "reduce_scatter", "reduce_scatter_tensor",
                "all_gather", "all_gather_into_tensor", "all_gather_single",
                "all_gather_flat"}


def _is_torch_wide(node: ast.AST) -> bool:
    return isinstance(node, ast.Attribute) and node.attr in _WIDE_ATTRS \
        and root_name(node) == "torch"


@register("dtype-widen",
          "no torch.float64 / torch.double / .double() / dtype=float on "
          "device paths (fp32 masters and accumulators, bf16 compute)")
def check_dtype_widen(sf: SourceFile) -> List[Finding]:
    out = []
    for node in ast.walk(sf.tree):
        if _is_torch_wide(node):
            out.append(Finding(
                "dtype-widen", sf.path, node.lineno,
                f"`{ast.unparse(node)}` is a 64-bit dtype: device state "
                f"is fp32 / bf16 by contract"))
        elif isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "double" and not node.args:
                out.append(Finding(
                    "dtype-widen", sf.path, node.lineno,
                    "`.double()` widens to float64"))
            for kw in node.keywords:
                if kw.arg == "dtype" and isinstance(kw.value, ast.Name) \
                        and kw.value.id == "float":
                    out.append(Finding(
                        "dtype-widen", sf.path, node.lineno,
                        "`dtype=float` is float64 to PyTorch"))
    return out


def _narrow_cast(node: ast.Call) -> Optional[ast.AST]:
    """The receiver of a narrowing cast (``x.to(torch.bfloat16)``,
    ``x.to(dtype=torch.half)``, ``x.bfloat16()``), else None."""
    f = node.func
    if not isinstance(f, ast.Attribute):
        return None
    if f.attr in _NARROW_METHODS and not node.args:
        return f.value
    if f.attr == "to":
        for arg in list(node.args) + [kw.value for kw in node.keywords
                                      if kw.arg == "dtype"]:
            if isinstance(arg, ast.Attribute) and arg.attr in _NARROW:
                return f.value
    return None


def _names(expr: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(expr) if isinstance(n, ast.Name)}


@register("collective-cast-order",
          "no narrowing cast of a tensor after it went through a "
          "collective in the same function: cast before the reduce (D3)")
def check_collective_cast_order(sf: SourceFile) -> List[Finding]:
    out = []
    for fn in ast.walk(sf.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        stmts = sorted((n for n in ast.walk(fn) if isinstance(n, ast.stmt)
                        and n is not fn), key=lambda n: n.lineno)
        reduced: Set[str] = set()
        for stmt in stmts:
            # casts in this statement of what an earlier one reduced
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call):
                    recv = _narrow_cast(node)
                    if recv is not None and _names(recv) & reduced:
                        out.append(Finding(
                            "collective-cast-order", sf.path, node.lineno,
                            f"`{ast.unparse(node)[:60]}` narrows a tensor "
                            f"after its collective: the wire already moved "
                            f"the wide bytes; cast before the reduce"))
            # what this statement reduces, and what it derives from that
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call) and (call_name(node) or "") \
                        .rsplit(".", 1)[-1] in _COLLECTIVES and node.args:
                    reduced |= _names(node.args[0])
            if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                value = stmt.value
                targets = stmt.targets if isinstance(stmt, ast.Assign) \
                    else [stmt.target]
                calls_coll = value is not None and any(
                    isinstance(n, ast.Call) and (call_name(n) or "")
                    .rsplit(".", 1)[-1] in _COLLECTIVES
                    for n in ast.walk(value))
                if value is not None and (calls_coll
                                          or _names(value) & reduced):
                    for tgt in targets:
                        reduced |= {n.id for n in ast.walk(tgt)
                                    if isinstance(n, ast.Name)}
    return out
