"""Host-sync lints.

``host-sync-graph`` (the reference's ``host-sync-jit``): no host read
(``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``np.asarray`` /
``np.array``, ``bool`` / ``int`` / ``float`` of tensor data) in code a
CUDA graph captures: the body of a ``with torch.cuda.graph(...)`` block,
the functions it calls and, transitively, their same-module callees.
Calls are followed by bare name (a module function), through ``self.m``
(a method of the enclosing class) and through ``self.attr`` bound to a
module function's result (``self._step = make_step_core(...)``: every
function nested in ``make_step_core`` is captured code).  A host read
there fails the capture, or is frozen into the graph as a constant.
Shape reads (``int(x.shape[0])``, ``len``) are not syncs.

``host-sync-loop`` (the reference's rule of that name): no per-iteration
read of device data inside a host ``for`` / ``while`` loop, where one
read of the whole tensor outside it would do.  Scoped to ``train/``,
``serve/`` and ``core/``; deliberate sync points carry ``# repro_torch:
noqa[host-sync-loop]`` with a justification.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set

from repro_torch.analysis.astutil import (HOST_BUILTINS, assign_targets,
                                          call_name, root_name)
from repro_torch.analysis.lint import Finding, SourceFile, register

SYNC_BUILTINS = {"float", "int", "bool"}
NP_SYNCS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_SHAPE_ATTRS = ("shape", "size", "ndim", "dtype", "numel", "dim",
                "element_size", "device")


def _own_nodes(fn) -> List[ast.AST]:
    """``ast.walk(fn)`` minus what nested function defs own (they are
    analysed as functions in their own right)."""
    skip: Set[int] = set()
    for d in ast.walk(fn):
        if isinstance(d, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)) and d is not fn:
            skip.update(id(x) for x in ast.walk(d))
    return [n for n in ast.walk(fn) if id(n) not in skip or n is fn]


def _is_shape_math(expr: ast.AST) -> bool:
    """True when the expression only touches static shape metadata."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and node.attr in _SHAPE_ATTRS:
            return True
        if isinstance(node, ast.Call):
            name = call_name(node) or ""
            if name == "len" or name.startswith(("np.", "numpy.", "math.")):
                return True
    return False


def sync_calls(nodes) -> List[ast.Call]:
    out = []
    for node in nodes:
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        if name in SYNC_BUILTINS and len(node.args) == 1 and \
                not isinstance(node.args[0], ast.Constant) and \
                not _is_shape_math(node.args[0]):
            out.append(node)
        elif name in NP_SYNCS and node.args and \
                not _is_shape_math(node.args[0]):
            out.append(node)
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr in SYNC_METHODS and not node.args and \
                not node.keywords:
            out.append(node)
    return out


def _is_graph_block(item: ast.withitem) -> bool:
    e = item.context_expr
    return isinstance(e, ast.Call) and \
        (call_name(e) or "").endswith("cuda.graph")


def captured_functions(tree: ast.Module):
    """(functions a CUDA graph captures, the ``with torch.cuda.graph``
    blocks): the functions called in a capture block, by bare name,
    ``self.method`` or ``self.attr`` bound to a module function's result
    (whose nested functions are then captured), and transitively their
    callees and nested functions."""
    defs = [n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    by_name: Dict[str, List[ast.AST]] = {}
    for d in defs:
        by_name.setdefault(d.name, []).append(d)
    methods: Dict[str, List[ast.AST]] = {}
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        for d in cls.body:
            if isinstance(d, (ast.FunctionDef, ast.AsyncFunctionDef)):
                methods.setdefault(d.name, []).append(d)
    # self.attr = factory(...): calling self.attr runs what factory made
    bound: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            fname = call_name(node.value)
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute) and \
                        isinstance(tgt.value, ast.Name) and \
                        tgt.value.id == "self" and fname in by_name:
                    bound.setdefault(tgt.attr, []).extend(by_name[fname])

    def callees(nodes):
        out = []
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Name):
                out += by_name.get(f.id, [])
            elif isinstance(f, ast.Attribute) and \
                    isinstance(f.value, ast.Name) and f.value.id == "self":
                out += methods.get(f.attr, [])
                for factory in bound.get(f.attr, []):
                    out += [d for d in ast.walk(factory)
                            if isinstance(d, (ast.FunctionDef,
                                              ast.AsyncFunctionDef))
                            and d is not factory]
        return out

    blocks = [w for w in ast.walk(tree) if isinstance(w, ast.With)
              and any(_is_graph_block(i) for i in w.items)]
    frontier = []
    for w in blocks:
        frontier += callees([n for s in w.body for n in ast.walk(s)])
    device: Set[ast.AST] = set()
    while frontier:
        fn = frontier.pop()
        if fn in device:
            continue
        device.add(fn)
        frontier += [d for d in ast.walk(fn)
                     if isinstance(d, (ast.FunctionDef, ast.AsyncFunctionDef))
                     and d is not fn]
        frontier += callees(_own_nodes(fn))
    return device, blocks


@register("host-sync-graph",
          "no .item()/.tolist()/.cpu()/.numpy()/np.asarray or "
          "bool()/int()/float() of tensor data in code a CUDA graph "
          "captures (a torch.cuda.graph block and its same-module callees)")
def check_host_sync_graph(sf: SourceFile) -> List[Finding]:
    out, seen = [], set()
    device, blocks = captured_functions(sf.tree)
    sites = [(f"function `{fn.name}`", _own_nodes(fn)) for fn in device]
    sites += [("a torch.cuda.graph block",
               [n for s in w.body for n in ast.walk(s)]) for w in blocks]
    for where, nodes in sites:
        for call in sync_calls(nodes):
            if id(call) in seen:
                continue
            seen.add(id(call))
            out.append(Finding(
                "host-sync-graph", sf.path, call.lineno,
                f"host read `{ast.unparse(call)[:60]}` in {where}, which a "
                f"CUDA graph captures: keep it out of the captured step"))
    return out


# -- host-sync-loop ---------------------------------------------------------

_HOST_PRODUCERS = ("np.", "numpy.", "time.", "os.", "math.", "re.", "json.")


def _host_names(fn) -> Set[str]:
    """Names that (somewhere in ``fn``) hold host values: assigned from
    numpy, builtin or literal expressions, or loop targets over them."""
    host: Set[str] = set()

    def value_is_host(v: ast.AST) -> bool:
        if isinstance(v, (ast.Constant, ast.ListComp, ast.DictComp,
                          ast.SetComp, ast.List, ast.Dict, ast.Set,
                          ast.JoinedStr)):
            return True
        if isinstance(v, ast.Call):
            name = call_name(v) or ""
            if name in HOST_BUILTINS or name.startswith(_HOST_PRODUCERS):
                return True
            if isinstance(v.func, ast.Attribute):
                if v.func.attr in SYNC_METHODS:
                    return True          # x.tolist() etc. is on the host
                return value_is_host(v.func.value)
            return False
        if isinstance(v, (ast.Subscript, ast.Attribute)):
            return value_is_host(v.value)
        if isinstance(v, ast.Name):
            return v.id in host
        if isinstance(v, ast.BinOp):
            return value_is_host(v.left) and value_is_host(v.right)
        if isinstance(v, ast.Compare):
            return value_is_host(v.left) and \
                all(value_is_host(c) for c in v.comparators)
        if isinstance(v, ast.BoolOp):
            return all(value_is_host(x) for x in v.values)
        if isinstance(v, ast.UnaryOp):
            return value_is_host(v.operand)
        if isinstance(v, ast.IfExp):
            return value_is_host(v.body) and value_is_host(v.orelse)
        if isinstance(v, ast.Tuple):
            return all(value_is_host(e) for e in v.elts)
        return False

    for _ in range(2):        # so that `a = np.asarray(x); b = a[i]` marks b
        for node in ast.walk(fn):
            for name, value in assign_targets(node):
                if value_is_host(value):
                    host.add(name)
            if isinstance(node, (ast.For, ast.comprehension)) and \
                    value_is_host(node.iter):
                for tgt in ast.walk(node.target):
                    if isinstance(tgt, ast.Name):
                        host.add(tgt.id)
    return host


def _device_fetch_in(expr: ast.AST, host: Set[str]) -> bool:
    """Does ``expr`` reach into device data: a subscript of a non-host
    name, a method call on one, or a ``torch.`` call?  Descent stops at
    host-producing calls (np.*, len, ...)."""

    def walk(node) -> bool:
        if isinstance(node, ast.Call):
            name = call_name(node) or ""
            if name in HOST_BUILTINS or name.startswith(_HOST_PRODUCERS):
                return False
            if name.startswith("torch."):
                return True
            if isinstance(node.func, ast.Attribute):
                root = root_name(node.func)
                if root is not None and root not in host and \
                        root not in ("np", "numpy", "math", "time", "os"):
                    return True
            return any(walk(c) for c in ast.iter_child_nodes(node))
        if isinstance(node, ast.Subscript):
            root = root_name(node.value)
            if root is not None and root not in host:
                return True
            return walk(node.slice)
        return any(walk(c) for c in ast.iter_child_nodes(node))

    return walk(expr)


@register("host-sync-loop",
          "no per-iteration device read (x.item(), x.tolist(), "
          "float(t[k]), np.asarray(pool[i])) inside host for/while loops",
          paths=("src/repro_torch/train/*", "src/repro_torch/serve/*",
                 "src/repro_torch/core/*"))
def check_host_sync_loop(sf: SourceFile) -> List[Finding]:
    out = []
    device, _ = captured_functions(sf.tree)
    for fn in ast.walk(sf.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                or fn in device:
            continue                 # host-sync-graph owns captured code
        host = _host_names(fn)
        own = _own_nodes(fn)
        own_ids = {id(n) for n in own}
        seen = set()
        for loop in [n for n in own if isinstance(n, (ast.For, ast.While))]:
            in_loop = [n for n in ast.walk(loop) if id(n) in own_ids]
            for call in sync_calls(in_loop):
                if id(call) in seen:
                    continue
                seen.add(id(call))
                payload = call.func.value if isinstance(
                    call.func, ast.Attribute) and \
                    call.func.attr in SYNC_METHODS else call.args[0]
                if _device_fetch_in(payload, host):
                    out.append(Finding(
                        "host-sync-loop", sf.path, call.lineno,
                        f"per-iteration device read "
                        f"`{ast.unparse(call)[:60]}`: read the tensor once "
                        f"outside the loop (or justify with noqa)"))
    return out
