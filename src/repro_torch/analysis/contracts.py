"""Level-2 contracts: checkers over the port's runs, the counterpart of
the reference's ``repro/analysis/contracts.py``.

The port rests on invariants that each engine asserted once, ad hoc;
this module makes them checkers any test or card run can turn on:

  * ``track_captures`` / ``assert_recapture_free`` (the reference's
    ``track_compiles`` / ``assert_retrace_free``): every CUDA graph
    capture begun inside the block (``CUDAGraph.capture_begin``, which
    ``torch.cuda.graph`` calls), each with its capture site.  One capture
    an engine and a corpus, none for a new bucket or a later round.
  * ``pointers`` / ``assert_in_place`` (``assert_donated``): the leaves
    of a carried state keep their storage across a run, as the
    reference's donated carry aliases its outputs.
  * ``no_host_sync`` (``no_implicit_transfers``): the block reads nothing
    back to the host.  On the card ``torch.cuda.set_sync_debug_mode``
    raises on any synchronizing call; on every device a
    ``TorchFunctionMode`` raises on ``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()`` and ``bool`` / ``int`` / ``float`` of a
    tensor, so the guard also bites on the CPU (the reference's passes
    there vacuously).
  * ``graph_nodes`` / ``assert_graph_device_only``
    (``assert_no_host_transfers``): a captured graph's nodes read through
    the driver; a host node, or a memcpy node with host memory at either
    end, is refused.
  * ``record_collectives`` with ``assert_collective_width``,
    ``expected_groups`` and ``assert_replica_groups``: every
    ``torch.distributed`` collective issued in the block (op, dtype,
    elements, the group's ranks, whether a capture was running), its
    wire width, and its groups against a mesh axis's.
"""
from __future__ import annotations

import ctypes
import dataclasses
import inspect
import re
import traceback
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

__all__ = [
    "CaptureLog", "track_captures", "assert_recapture_free",
    "pointers", "assert_in_place",
    "HostSyncError", "no_host_sync",
    "NODE_TYPES", "header_node_types", "graph_nodes",
    "assert_graph_device_only",
    "CollectiveCall", "CollectiveLog", "record_collectives",
    "wire_bytes", "assert_collective_width", "expected_groups",
    "assert_replica_groups",
]


# ---------------------------------------------------------------------------
# recapture freedom
# ---------------------------------------------------------------------------

class CaptureLog:
    """The capture sites (``file:line in function``, the first frame
    outside torch and this module) of every capture begun in a
    ``track_captures`` block."""

    def __init__(self):
        self.sites: List[str] = []

    @property
    def count(self) -> int:
        return len(self.sites)

    def __repr__(self):
        return f"CaptureLog(count={self.count}, sites={self.sites!r})"


def _caller_site() -> str:
    here = __file__
    for fr in reversed(traceback.extract_stack()[:-2]):
        if fr.filename != here and "/torch/" not in fr.filename:
            return f"{fr.filename}:{fr.lineno} in {fr.name}"
    return "unknown"


class track_captures:
    """``with track_captures() as log: ...; log.count``: counts every
    ``capture_begin`` of ``graph_cls`` (default
    ``torch.cuda.graphs.CUDAGraph``, the class ``torch.cuda.graph``
    captures into, whatever ``torch.cuda.CUDAGraph`` is rebound to) in
    the block.  Nesting is fine; each block gets its own log."""

    def __init__(self, graph_cls=None):
        self.cls = torch.cuda.graphs.CUDAGraph if graph_cls is None \
            else graph_cls
        self.log = CaptureLog()

    def __enter__(self) -> CaptureLog:
        self.orig = self.cls.__dict__.get("capture_begin")
        base = self.cls.capture_begin
        log = self.log

        def capture_begin(graph, *a, **kw):
            log.sites.append(_caller_site())
            return base(graph, *a, **kw)

        self.cls.capture_begin = capture_begin
        return log

    def __exit__(self, *exc):
        if self.orig is None:
            del self.cls.capture_begin
        else:
            self.cls.capture_begin = self.orig


class assert_recapture_free:
    """``with assert_recapture_free("14a epoch 2"): ...``: raises after
    the block when it began more than ``allowed`` captures.  Use after
    the run that captured."""

    def __init__(self, what: str = "block", allowed: int = 0,
                 graph_cls=None):
        self.what, self.allowed = what, allowed
        self.tracker = track_captures(graph_cls)

    def __enter__(self) -> CaptureLog:
        return self.tracker.__enter__()

    def __exit__(self, exc_type, *exc):
        self.tracker.__exit__(exc_type, *exc)
        log = self.tracker.log
        if exc_type is None and log.count > self.allowed:
            raise AssertionError(
                f"{self.what} recaptured: {log.count} capture(s) (allowed "
                f"{self.allowed}): {log.sites}")


# ---------------------------------------------------------------------------
# in place (the counterpart of donation)
# ---------------------------------------------------------------------------

def _leaves(tree) -> List[torch.Tensor]:
    from repro_torch.models.common import tree_leaves
    return [l for l in tree_leaves(tree) if isinstance(l, torch.Tensor)]


def pointers(tree) -> List[int]:
    """``data_ptr()`` of every tensor leaf of ``tree``, in leaf order."""
    return [l.data_ptr() for l in _leaves(tree)]


def assert_in_place(before: Sequence[int], tree, what: str = "state"
                    ) -> None:
    """Every leaf of ``tree`` still at the address ``pointers`` read
    before the run: the carried state was updated in place, not
    replaced by copies (which a captured graph would not read, and which
    would double the state's memory)."""
    after = pointers(tree)
    if len(after) != len(before):
        raise AssertionError(f"{what}: {len(before)} leaves before, "
                             f"{len(after)} after")
    moved = [i for i, (a, b) in enumerate(zip(before, after)) if a != b]
    if moved:
        raise AssertionError(
            f"{what}: leaves {moved} of {len(after)} were replaced, not "
            f"updated in place")


# ---------------------------------------------------------------------------
# no host sync
# ---------------------------------------------------------------------------

class HostSyncError(RuntimeError):
    """A read back to the host inside a ``no_host_sync`` block."""


_HOST_READS = {
    torch.Tensor.item: ".item()", torch.Tensor.tolist: ".tolist()",
    torch.Tensor.cpu: ".cpu()", torch.Tensor.numpy: ".numpy()",
    torch.Tensor.__bool__: "bool()", torch.Tensor.__int__: "int()",
    torch.Tensor.__float__: "float()", torch.Tensor.__index__: "index()",
    torch.Tensor.__array__: "np.asarray()",
}


class _HostReadGuard(TorchFunctionMode):
    def __init__(self, what: str):
        super().__init__()
        self.what = what

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = _HOST_READS.get(func)
        if name is not None:
            raise HostSyncError(f"{self.what}: {name} of a tensor reads it "
                                f"back to the host")
        return func(*args, **(kwargs or {}))


class no_host_sync:
    """``with no_host_sync("14a replays"): ...``: the block reads nothing
    back to the host.  Every device: ``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()``, ``np.asarray`` and ``bool`` / ``int`` /
    ``float`` / ``index`` of a tensor raise ``HostSyncError``.  With a card: also
    ``torch.cuda.set_sync_debug_mode("error")``, under which any call
    that synchronizes the host with the card raises."""

    def __init__(self, what: str = "block"):
        self.what = what
        self.mode = _HostReadGuard(what)
        self.cuda = torch.cuda.is_available()

    def __enter__(self):
        if self.cuda:
            self.prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)
        if self.cuda:
            torch.cuda.set_sync_debug_mode(self.prev)


# ---------------------------------------------------------------------------
# captured graphs: device-only nodes
# ---------------------------------------------------------------------------

#: ``CUgraphNodeType`` of the driver API (``cuda.h``), by the header's
#: names without the ``CU_GRAPH_NODE_TYPE_`` prefix
NODE_TYPES = {"KERNEL": 0, "MEMCPY": 1, "MEMSET": 2, "HOST": 3, "GRAPH": 4,
              "EMPTY": 5, "WAIT_EVENT": 6, "EVENT_RECORD": 7,
              "EXT_SEMAS_SIGNAL": 8, "EXT_SEMAS_WAIT": 9, "MEM_ALLOC": 10,
              "MEM_FREE": 11, "BATCH_MEM_OP": 12, "CONDITIONAL": 13}
_TYPE_NAMES = {v: k for k, v in NODE_TYPES.items()}
#: ``CUmemorytype``
MEMORY_TYPES = {1: "host", 2: "device", 3: "array", 4: "unified"}
_MEMCPY3D_BYTES = 200           # sizeof(CUDA_MEMCPY3D)
_SRC_TYPE, _SRC_DEV, _DST_TYPE, _DST_DEV = 32, 48, 120, 136


def header_node_types(path: str) -> Dict[str, int]:
    """``{name: value}`` of the ``CU_GRAPH_NODE_TYPE_*`` enumerators in a
    toolkit's ``cuda.h``, to hold ``NODE_TYPES`` against."""
    with open(path) as f:
        text = f.read()
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"\bCU_GRAPH_NODE_TYPE_(\w+)\s*=\s*(\d+)", text)}


def _driver():
    cu = ctypes.CDLL("libcuda.so.1")
    vp, pp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
    for fn, args in (
            ("cuGraphGetNodes", (vp, vp, ctypes.POINTER(ctypes.c_size_t))),
            ("cuGraphNodeGetType", (vp, ctypes.POINTER(ctypes.c_int))),
            ("cuGraphChildGraphNodeGetGraph", (vp, pp)),
            ("cuGraphKernelNodeGetParams_v2", (vp, vp)),
            ("cuGraphMemcpyNodeGetParams", (vp, vp)),
            ("cuPointerGetAttribute", (vp, ctypes.c_int, ctypes.c_uint64)),
            ("cuFuncGetName", (ctypes.POINTER(ctypes.c_char_p), vp)),
            ("cuKernelGetName", (ctypes.POINTER(ctypes.c_char_p), vp))):
        getattr(cu, fn).argtypes = args
        getattr(cu, fn).restype = ctypes.c_int          # CUresult
    return cu


def _ok(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"graph_nodes: {what} returned CUresult {status}")


def graph_nodes(graph) -> List[Tuple[str, object]]:
    """Every node of a captured graph as ``(type, detail)``, child graphs
    walked: a kernel's function name, a memcpy's (source, destination)
    memory kinds (``"host"`` / ``"device"`` / ...), else None.  ``graph``
    is a ``torch.cuda.CUDAGraph`` made with ``keep_graph=True`` (its
    ``cudaGraph_t`` outlives the capture) or a raw ``CUgraph`` handle.
    Read through the driver: ``cuGraphGetNodes``, ``cuGraphNodeGetType``,
    ``cuGraphKernelNodeGetParams`` then ``cuFuncGetName`` or
    ``cuKernelGetName``, ``cuGraphMemcpyNodeGetParams``.  A replay runs
    every node once, so a kernel's nodes x replays is what the replays
    launched."""
    cu = _driver()

    def nodes_of(g):
        n = ctypes.c_size_t(0)
        _ok(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
        arr = (ctypes.c_void_p * n.value)()
        _ok(cu.cuGraphGetNodes(g, arr, ctypes.byref(n)), "cuGraphGetNodes")
        return list(arr)

    def end_kind(buf, type_off, ptr_off):
        kind = ctypes.c_int.from_buffer(buf, type_off).value
        if kind != 4:                                   # not unified
            return MEMORY_TYPES.get(kind, str(kind))
        ptr = ctypes.c_uint64.from_buffer(buf, ptr_off).value
        got = ctypes.c_int(0)
        # CU_POINTER_ATTRIBUTE_MEMORY_TYPE; pageable host memory is not
        # known to the driver and fails the query
        status = cu.cuPointerGetAttribute(ctypes.byref(got), 2, ptr)
        return MEMORY_TYPES.get(got.value, "host") if status == 0 \
            else "host"

    def walk(g):
        out = []
        for node in nodes_of(g):
            node = ctypes.c_void_p(node)
            kind = ctypes.c_int(-1)
            _ok(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
                "cuGraphNodeGetType")
            name = _TYPE_NAMES.get(kind.value, str(kind.value))
            if kind.value == NODE_TYPES["GRAPH"]:
                child = ctypes.c_void_p()
                _ok(cu.cuGraphChildGraphNodeGetGraph(node, ctypes.byref(
                    child)), "cuGraphChildGraphNodeGetGraph")
                out += walk(child)
            elif kind.value == NODE_TYPES["KERNEL"]:
                # CUDA_KERNEL_NODE_PARAMS_v2: func at 0, kern at 56
                buf = (ctypes.c_char * 128)()
                _ok(cu.cuGraphKernelNodeGetParams_v2(node, buf),
                    "cuGraphKernelNodeGetParams_v2")
                func = ctypes.c_void_p.from_buffer(buf, 0).value
                kern = ctypes.c_void_p.from_buffer(buf, 56).value
                fname = ctypes.c_char_p()
                if func:
                    _ok(cu.cuFuncGetName(ctypes.byref(fname),
                                         ctypes.c_void_p(func)),
                        "cuFuncGetName")
                else:
                    _ok(cu.cuKernelGetName(ctypes.byref(fname),
                                           ctypes.c_void_p(kern)),
                        "cuKernelGetName")
                out.append(("KERNEL", fname.value.decode()))
            elif kind.value == NODE_TYPES["MEMCPY"]:
                buf = (ctypes.c_char * _MEMCPY3D_BYTES)()
                _ok(cu.cuGraphMemcpyNodeGetParams(node, buf),
                    "cuGraphMemcpyNodeGetParams")
                out.append(("MEMCPY", (end_kind(buf, _SRC_TYPE, _SRC_DEV),
                                       end_kind(buf, _DST_TYPE, _DST_DEV))))
            else:
                out.append((name, None))
        return out

    raw = graph if isinstance(graph, int) else graph.raw_cuda_graph()
    return walk(ctypes.c_void_p(raw))


def assert_graph_device_only(graph, what: str = "graph") -> None:
    """A captured graph holds no host node and no memcpy with host
    memory at either end: its replay never waits on or feeds the host."""
    bad = [(kind, d) for kind, d in graph_nodes(graph)
           if kind == "HOST" or (kind == "MEMCPY" and "host" in d)]
    if bad:
        raise AssertionError(f"{what}: host node(s) or host transfers in "
                             f"the captured graph: {bad}")


# ---------------------------------------------------------------------------
# collectives: width and groups
# ---------------------------------------------------------------------------

#: op -> (the argument holding the buffer the ring models size, the
#: argument whose dtype is on the wire)
_COLLECTIVES = {
    "all_reduce": ("tensor", "tensor"),
    "all_gather_into_tensor": ("output_tensor", "input_tensor"),
    "all_gather_single": ("output_tensor", "input_tensor"),
    "reduce_scatter_tensor": ("output", "input"),
    "all_to_all_single": ("output", "input"),
    "broadcast": ("tensor", "tensor"),
}
_REDUCTIONS = ("all_reduce", "reduce_scatter_tensor")


@dataclasses.dataclass(frozen=True)
class CollectiveCall:
    op: str                 # the torch.distributed function's name
    dtype: torch.dtype      # what the wire carries
    numel: int              # elements of the buffer the ring models size
    element_size: int
    ranks: Tuple[int, ...]  # the group's global ranks
    captured: bool          # issued while a CUDA graph capture ran

    @property
    def nbytes(self) -> int:
        return self.numel * self.element_size


class CollectiveLog:
    def __init__(self):
        self.calls: List[CollectiveCall] = []

    @property
    def count(self) -> int:
        return len(self.calls)

    @property
    def captured(self) -> int:
        """Calls issued while the current stream captured a graph."""
        return sum(c.captured for c in self.calls)

    def in_capture(self) -> "CollectiveLog":
        """The calls issued inside a capture: what a captured step
        holds."""
        log = CollectiveLog()
        log.calls = [c for c in self.calls if c.captured]
        return log

    def __repr__(self):
        return f"CollectiveLog({self.calls!r})"


def _group_ranks(dist, group) -> Tuple[int, ...]:
    g = dist.group.WORLD if group is None else group
    return tuple(int(r) for r in dist.get_process_group_ranks(g))


class record_collectives:
    """``with record_collectives() as log: ...``: each
    ``torch.distributed`` collective of ``_COLLECTIVES`` issued in the
    block (the module's functions are wrapped, so every caller that
    looks them up at call time is seen) is logged, then run."""

    def __enter__(self) -> CollectiveLog:
        import torch.distributed as dist
        self.log = log = CollectiveLog()
        self.orig = {n: getattr(dist, n) for n in _COLLECTIVES
                     if hasattr(dist, n)}

        def wrap(name, fn):
            sig = inspect.signature(fn)
            size_arg, wire_arg = _COLLECTIVES[name]

            def logged(*a, **kw):
                args = sig.bind(*a, **kw).arguments
                buf, wire = args[size_arg], args[wire_arg]
                capturing = (torch.cuda.is_available()
                             and torch.cuda.is_current_stream_capturing())
                log.calls.append(CollectiveCall(
                    name, wire.dtype, int(buf.numel()), wire.element_size(),
                    _group_ranks(dist, args.get("group")), capturing))
                return fn(*a, **kw)
            return logged

        for n, fn in self.orig.items():
            setattr(dist, n, wrap(n, fn))
        return log

    def __exit__(self, *exc):
        import torch.distributed as dist
        for n, fn in self.orig.items():
            setattr(dist, n, fn)


def wire_bytes(call: CollectiveCall) -> float:
    """Bytes one rank sends for ``call`` by the reference's ring models
    (``repro/launch/dryrun.py:parse_collectives``), ``size`` the buffer's
    bytes and ``g`` the group's ranks: all-reduce 2 size (g-1)/g,
    all-gather and all-to-all size (g-1)/g (size = the output),
    reduce-scatter size (g-1) (size = the output), broadcast size."""
    g, size = max(len(call.ranks), 1), float(call.nbytes)
    if call.op == "all_reduce":
        return 2.0 * size * (g - 1) / g
    if call.op in ("all_gather_into_tensor", "all_gather_single",
                   "all_to_all_single"):
        return size * (g - 1) / g
    if call.op == "reduce_scatter_tensor":
        return size * (g - 1)
    return size


def _dtype(d) -> torch.dtype:
    if isinstance(d, torch.dtype):
        return d
    return {"bf16": torch.bfloat16, "f32": torch.float32,
            "fp32": torch.float32}.get(d) or getattr(torch, d)


def assert_collective_width(log: CollectiveLog, *, dtype,
                            n_expected: Optional[int] = None) -> None:
    """The log's reductions (all-reduce, reduce-scatter) run at
    ``dtype``: the wire moves that many bytes an element.  With
    ``n_expected`` exactly that many run at ``dtype`` and reductions of
    another width (the step's fp32 metric and weight sums) are
    tolerated; without it every reduction runs at ``dtype``."""
    want = _dtype(dtype)
    got = [c.dtype for c in log.calls if c.op in _REDUCTIONS]
    if not got:
        raise AssertionError("no reductions in the log")
    if n_expected is not None:
        n_at = sum(d == want for d in got)
        if n_at != n_expected:
            raise AssertionError(f"{n_at} reductions at {want}, expected "
                                 f"{n_expected}; widths seen: {got}")
    else:
        wrong = sorted({str(d) for d in got if d != want})
        if wrong:
            raise AssertionError(
                f"reductions at {wrong}, expected {want}: the wire moves "
                f"the wrong number of bytes")


def _mesh_ranks(mesh) -> Tuple[np.ndarray, List[str]]:
    if isinstance(mesh, Mapping):
        names = [str(a) for a in mesh]
        shape = [int(mesh[a]) for a in mesh]
        return np.arange(int(np.prod(shape))).reshape(shape), names
    return (np.asarray(mesh.mesh.tolist()).reshape(tuple(mesh.mesh.shape)),
            list(mesh.mesh_dim_names))


def expected_groups(mesh, axis: str) -> List[List[int]]:
    """The rank groups a collective over mesh axis ``axis`` must form:
    one a cross-section, each holding the ranks along ``axis``.  ``mesh``
    is a ``DeviceMesh`` or a mapping ``{axis: size}`` in axis order
    (ranks row-major, as ``init_device_mesh`` lays them out)."""
    ids, names = _mesh_ranks(mesh)
    k = names.index(axis)
    return np.moveaxis(ids, k, -1).reshape(-1, ids.shape[k]).tolist()


def assert_replica_groups(log: CollectiveLog, mesh, axis: str,
                          min_count: int = 1) -> None:
    """At least ``min_count`` logged collectives ran over a group of
    mesh axis ``axis``: exactly the ranks along it through the issuing
    rank."""
    want = {tuple(sorted(g)) for g in expected_groups(mesh, axis)}
    seen = [tuple(sorted(c.ranks)) for c in log.calls]
    found = sum(s in want for s in seen)
    if found < min_count:
        raise AssertionError(
            f"{found} collective(s) grouped over mesh axis {axis!r}, want "
            f"at least {min_count} (groups {sorted(want)}, saw {seen})")
