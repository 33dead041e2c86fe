"""The FLOPs and HBM bytes of one step of the port, counted op by op at
true multiplicity, and its collectives' wire bytes: the counterpart of
the reference's ``repro/launch/hlo_analysis.py``, which reads them off
compiled HLO.  PyTorch runs each op once per call, so counting at
dispatch needs no loop multiplicity.

``count_ops()`` is a ``TorchDispatchMode``:

  * FLOPs of matmuls, convolutions and attention from
    ``torch.utils.flop_counter``'s formulas (``dot_flops`` holds the
    matmuls alone, what the reference's analysis counts as dots);
  * bytes: each op that is not a view reads its tensor inputs and writes
    its outputs once (a broadcast input counts its distinct elements),
    an estimate of an eager launch's HBM traffic;
  * each hand-written kernel by its formula (``PERF.md``'s bound line:
    the band 4 hd FLOP a (query, key) pair and head, 10 hd backward; the
    WKV 4 N^2 a (token, head), 8 N^2 backward; the lattice 16 B a cell;
    the Gram P n (n+1) D; the grad sketch its four products), reported
    by the wrapper through ``kernels.backend.kernel_work`` on every
    route, with no aten op inside counted: the kernel, its plain
    version and the dry run's shape-only route count the same work;
  * collectives through ``analysis.contracts.record_collectives``, their
    wire bytes by the reference's ring models.

It counts real tensors on the card or the CPU and fake ones alike
(``launch/dryrun.py``).
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis.contracts import record_collectives, wire_bytes
from repro_torch.kernels import backend

aten = torch.ops.aten
DOTS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm}
# ops that move no bytes: allocation and aliasing
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten.detach, aten.alias, aten.lift_fresh,
         aten._unsafe_view, aten.set_, aten.resize_, aten.sym_size,
         aten.sym_stride, aten.sym_numel, aten.sym_storage_offset}
# ops whose first argument is written, not read
_WRITE_ONLY = {aten.copy_, aten.fill_, aten.zero_}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of a tensor's distinct elements (a broadcast dim, stride 0,
    counts once)."""
    if t.numel() == 0:
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


class OpCount:
    """Totals of a ``count_ops`` block: ``flops`` (matmuls, convolutions,
    attention and the kernels' formulas), ``dot_flops``, ``bytes``, and
    per aten op, per kernel and per collective op."""

    def __init__(self):
        self.flops = 0.0
        self.dot_flops = 0.0
        self.bytes = 0.0
        self.by_op: Dict[str, List[float]] = {}      # [calls, flops, bytes]
        self.kernels: Dict[str, List[float]] = {}    # [calls, flops, bytes]
        self.collectives: Dict[str, Dict[str, float]] = {}
        self.suspended = 0

    def _add(self, table, name, flops, n_bytes):
        row = table.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += n_bytes
        self.flops += flops
        self.bytes += n_bytes

    def record(self, func, args, kwargs, out) -> None:
        if func.namespace == "prim":        # metadata queries (prim.device)
            return
        packet = func._overloadpacket
        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
        if packet in DOTS:
            self.dot_flops += flops
        n_bytes = 0
        if not (func.is_view or packet in _FREE):
            ins, _ = tree_flatten((args, kwargs))
            ins = [t for t in ins if isinstance(t, torch.Tensor)]
            if packet in _WRITE_ONLY:
                ins = ins[1:]
            seen = set()
            for t in ins:
                if id(t) not in seen:
                    seen.add(id(t))
                    n_bytes += tensor_bytes(t)
            outs, _ = tree_flatten(out)
            n_bytes += sum(tensor_bytes(t) for t in outs
                           if isinstance(t, torch.Tensor))
        self._add(self.by_op, str(packet), flops, n_bytes)

    # -- kernels (backend.kernel_work) --------------------------------------
    def enter_kernel(self, name: str, flops: float, n_bytes: float) -> None:
        if self.suspended == 0:
            self._add(self.kernels, name, flops, n_bytes)
        self.suspended += 1

    def exit_kernel(self) -> None:
        self.suspended -= 1

    def add_collectives(self, log) -> None:
        for c in log.calls:
            row = self.collectives.setdefault(
                c.op, {"count": 0, "bytes": 0.0, "wire_bytes": 0.0})
            row["count"] += 1
            row["bytes"] += c.nbytes
            row["wire_bytes"] += wire_bytes(c)

    @property
    def wire_bytes(self) -> float:
        return sum(r["wire_bytes"] for r in self.collectives.values())

    @property
    def kernel_flops(self) -> float:
        return sum(r[1] for r in self.kernels.values())

    def top_ops(self, n: int = 12) -> List:
        """The ``n`` aten ops with the most FLOPs, then bytes."""
        rows = sorted(self.by_op.items(), key=lambda kv: (-kv[1][1],
                                                           -kv[1][2]))
        return [(k, int(v[0]), v[1], v[2]) for k, v in rows[:n]]

    def to_dict(self) -> Dict:
        return {"flops": self.flops, "dot_flops": self.dot_flops,
                "kernel_flops": self.kernel_flops, "bytes": self.bytes,
                "wire_bytes": self.wire_bytes,
                "kernels": {k: {"calls": int(v[0]), "flops": v[1],
                                "bytes": v[2]}
                            for k, v in sorted(self.kernels.items())},
                "collectives": self.collectives,
                "top_ops": self.top_ops()}


class _Counter(TorchDispatchMode):
    def __init__(self, count: OpCount):
        super().__init__()
        self.count = count

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.count.suspended == 0:
            self.count.record(func, args, kwargs, out)
        return out


class count_ops:
    """``with count_ops() as c: step(...)``; then ``c.flops``,
    ``c.bytes``, ``c.wire_bytes``, ``c.to_dict()``.  Enter it inside a
    ``FakeTensorMode`` to count a step that allocates nothing."""

    def __init__(self):
        self.count = OpCount()

    def __enter__(self) -> OpCount:
        self.mode = _Counter(self.count)
        self.coll = record_collectives()
        self.log = self.coll.__enter__()
        self.mode.__enter__()
        backend.WORK_SINKS.append(self.count)
        return self.count

    def __exit__(self, *exc):
        backend.WORK_SINKS.remove(self.count)
        self.mode.__exit__(*exc)
        self.coll.__exit__(*exc)
        self.count.add_collectives(self.log)
