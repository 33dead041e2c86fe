"""PGM — Partitioned Gradient Matching (paper Algorithm 1), the
reference's ``core/pgm.py``.

Every ``R`` epochs:
  stage A  per-unit last-layer gradient representations of all candidate
           units (sketched by default; exact = paper-faithful);
  stage B  split the units into D partitions; per partition, gradient
           matching (Algorithm 2, ``gm.py``) against the partition's own
           summed gradient (Val=False) or the validation gradient
           (Val=True, robust mode), each with budget b_k/D;
  stage C  concatenate the partial subsets and their weights.

Stage B builds all D Gram matrices in one call of the ``omp_gram``
kernel (the Hopper kernel on the card, its plain version on the CPU).
``PGMConfig.kernel_impl`` routes the round's kernels, as the reference's
does: ``"auto"`` and ``"pallas"`` launch the grad sketch and the Gram
on the card, ``"xla"`` runs their plain versions there; on the CPU
every value runs the plain versions (``kernels/backend.py:use_kernel``).

Distribution: with a ``mesh`` (``launch/mesh.py``), when the ``data``
axis divides the partitions and the units (ROADMAP hazard D4), rank r
takes stage A over its block of units ``[r n/size, (r+1) n/size)``,
which holds its ``D/size`` whole partitions, and runs their OMPs
(``pgm_select_sharded``); the selection is all-gathered.  Otherwise
every rank runs the whole round, as the reference falls back to one
device.  Validation units are sketched whole on every rank.

Residency: ``ResidentSelector`` runs stage A as one batched pass
(``units_gradients_batched``) over the engine's device-resident units.
On the card each unit corpus (train, val) has one CUDA graph of one
chunk of that pass, captured at the first round against the params' and
units' tensors and the projections, with a cursor over the units on the
card, and replayed a chunk at a time every round: the counterpart of
the reference's one jitted stage-A scan reused across rounds.  With the
MoE router term (``PGMConfig.moe_router_term`` on an ``moe`` bundle,
``_router_term_for``) each unit of a chunk is its head sketch and one
``torch.autograd.grad`` of its total loss with respect to the router
leaves alone, captured in the same graph.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import gm
from repro_torch.core.lastlayer import (_chunk_size, units_gradients,
                                        units_gradients_batched)
from repro_torch.core.sketch import Projections
from repro_torch.kernels.omp_gram.ops import omp_gram_batched_op
from repro_torch.models.common import tree_leaves
from repro_torch.train.optim import commit_


class Selection(NamedTuple):
    indices: torch.Tensor     # (b_k,) global unit ids, -1 padded
    weights: torch.Tensor     # (b_k,) fp32
    n_selected: int
    errors: torch.Tensor      # (D,) per-partition final E_lambda


def partitioned_gm(g_units: torch.Tensor, n_partitions: int,
                   budget_per_part: int, lam: float = 0.5,
                   eps: float = 1e-10, nonneg: bool = True,
                   val_matching: bool = False,
                   g_val: Optional[torch.Tensor] = None,
                   solver: str = "chol",
                   kernel_impl: str = "auto") -> Selection:
    n, D_sk = g_units.shape
    P = n_partitions
    if n % P:
        raise ValueError(f"n units {n} must divide into {P} partitions")
    per = n // P
    gp = g_units.reshape(P, per, D_sk).to(torch.float32).contiguous()
    if val_matching:
        target = g_val.to(torch.float32).expand(P, D_sk)
    else:
        # the partition's own summed gradient (sum, not mean, so that
        # sum_i w_i g_i reaches it with O(1) weights per unit)
        target = gp.sum(dim=1)
    K = omp_gram_batched_op(gp, impl=kernel_impl)
    c = torch.einsum("pnd,pd->pn", gp, target)
    tsq = torch.einsum("pd,pd->p", target, target)
    res = [gm.gram_omp(K[p], c[p], tsq[p], budget_per_part, lam, eps,
                       nonneg, solver) for p in range(P)]
    idx = torch.stack([r.indices for r in res])               # (P, budget)
    offsets = (torch.arange(P, device=idx.device) * per)[:, None]
    glob = torch.where(idx >= 0, idx + offsets, torch.full_like(idx, -1))
    return Selection(indices=glob.reshape(-1),
                     weights=torch.stack([r.weights for r in res]).reshape(-1),
                     n_selected=sum(r.n_selected for r in res),
                     errors=torch.stack([r.error for r in res]))


def _mesh_divides(mesh, axis: str, n_partitions: int, n_units: int) -> bool:
    """Sharded stage B needs whole partitions (and whole units) a rank;
    when they do not divide, every rank runs one-device stage B (D4)."""
    from repro_torch.launch.mesh import axis_names, mesh_shape
    if axis not in axis_names(mesh):
        return False
    size = mesh_shape(mesh)[axis]
    return n_partitions % size == 0 and n_units % size == 0


def _sharded_axis(mesh, axis: str, pgm_cfg, n_units: int) -> bool:
    return mesh is not None and _mesh_divides(
        mesh, axis, min(pgm_cfg.n_partitions, n_units), n_units)


def unit_block(mesh, axis: str, n_units: int):
    """``(lo, hi)``: the units of this rank's block, ``[r n / size, (r+1)
    n / size)`` for its coordinate r on ``axis`` (D4)."""
    from repro_torch.launch.mesh import coordinate, mesh_shape
    size = mesh_shape(mesh)[axis]
    r = coordinate(mesh)[axis]
    per = n_units // size
    return r * per, (r + 1) * per


def _stage_b(g_units, pgm_cfg, g_val=None, mesh=None,
             data_axis: str = "data") -> Selection:
    """Stage B over stage-A vectors: with ``mesh``, ``g_units`` is this
    rank's block of units and the partitions are spread over
    ``data_axis`` (``pgm_select_sharded``); without, one-device stage B
    over every unit."""
    if mesh is not None:
        from repro_torch.launch.mesh import mesh_shape
        n_units = g_units.shape[0] * mesh_shape(mesh)[data_axis]
        D = min(pgm_cfg.n_partitions, n_units)
        cfg = pgm_cfg if pgm_cfg.n_partitions == D else \
            dataclasses.replace(pgm_cfg, n_partitions=D)
        return pgm_select_sharded(mesh, data_axis, g_units, cfg, g_val=g_val)
    n_units = g_units.shape[0]
    budget_total = max(int(pgm_cfg.subset_fraction * n_units), 1)
    D = min(pgm_cfg.n_partitions, n_units)
    budget_per = max(budget_total // D, 1)
    return partitioned_gm(g_units, D, budget_per, pgm_cfg.lam, pgm_cfg.eps,
                          pgm_cfg.nonneg_weights, pgm_cfg.val_matching,
                          g_val, kernel_impl=pgm_cfg.kernel_impl)


def pgm_select_sharded(mesh, axis: str, g_units, pgm_cfg,
                       g_val=None) -> Selection:
    """Stage B with the partitions spread over ``axis`` (the reference's
    ``shard_map`` of it): ``g_units`` is this rank's block of ``n/size``
    units, which holds ``n_partitions/size`` whole partitions; the rank
    runs their OMPs locally, moves its indices by its block's offset, and
    the indices, weights and errors are all-gathered in rank order along
    the axis and ``n_selected`` summed.  Every rank returns the whole
    selection."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import (all_gather_flat, coordinate,
                                         mesh_shape)
    size = mesh_shape(mesh)[axis]
    per = g_units.shape[0]
    n = per * size
    D = pgm_cfg.n_partitions
    if D % size:
        raise ValueError(f"{D} partitions do not divide over {axis!r} of "
                         f"size {size}")
    budget_total = max(int(pgm_cfg.subset_fraction * n), 1)
    budget_per = max(budget_total // D, 1)
    sel = partitioned_gm(g_units, D // size, budget_per, pgm_cfg.lam,
                         pgm_cfg.eps, pgm_cfg.nonneg_weights,
                         pgm_cfg.val_matching,
                         g_val if pgm_cfg.val_matching else None,
                         kernel_impl=pgm_cfg.kernel_impl)
    off = coordinate(mesh)[axis] * per
    idx = torch.where(sel.indices >= 0, sel.indices + off,
                      torch.full_like(sel.indices, -1))
    group = mesh.get_group(axis)

    def gather(t):
        t = t.contiguous()
        out = torch.empty((size * t.numel(),), dtype=t.dtype,
                          device=t.device)
        return all_gather_flat(out, t.reshape(-1), group)

    n_sel = torch.tensor([sel.n_selected], dtype=torch.int64,
                         device=g_units.device)
    dist.all_reduce(n_sel, group=group)
    return Selection(indices=gather(idx), weights=gather(sel.weights),
                     n_selected=int(n_sel.item()),
                     errors=gather(sel.errors))


def _val_target(gv: torch.Tensor, n_units: int, pgm_cfg) -> torch.Tensor:
    """Validation target: mean gradient scaled to the partition mass so
    budgets/weights stay comparable with train matching."""
    D = min(pgm_cfg.n_partitions, n_units)
    return gv.mean(dim=0) * (n_units / D)


def pgm_select(bundle, params, units, pgm_cfg,
               proj: Optional[Projections] = None,
               val_units=None, mesh=None,
               data_axis: str = "data") -> Selection:
    """One selection round (stages A + B) over device-resident units.
    With ``mesh`` (and whole partitions a rank, D4) each rank takes stage
    A over its block of units and stage B over its partitions
    (``pgm_select_sharded``); else every rank runs the whole round."""
    n_units = units["tokens"].shape[0]
    exact = not pgm_cfg.use_sketch
    impl = pgm_cfg.kernel_impl
    rt = _router_term_for(bundle, pgm_cfg)
    sharded = _sharded_axis(mesh, data_axis, pgm_cfg, n_units)
    mine = units
    if sharded:
        lo, hi = unit_block(mesh, data_axis, n_units)
        mine = {k: v[lo:hi] for k, v in units.items()}
    g = units_gradients(bundle, params, mine, proj, exact=exact,
                        kernel_impl=impl, router_term=rt)
    g_val = None
    if pgm_cfg.val_matching:
        gv = units_gradients(bundle, params, val_units, proj, exact=exact,
                             kernel_impl=impl, router_term=rt)
        g_val = _val_target(gv, n_units, pgm_cfg)
    return _stage_b(g, pgm_cfg, g_val=g_val,
                    mesh=mesh if sharded else None, data_axis=data_axis)


def _router_term_for(bundle, pgm_cfg) -> bool:
    """The MoE router-aware term applies only to sparse-expert bundles;
    other families ignore the flag (the reference's rule)."""
    return bool(getattr(pgm_cfg, "moe_router_term", False)
                and bundle.cfg.family == "moe")


def _soft_random_selection(gen: torch.Generator, n_units: int, pgm_cfg,
                           device: torch.device) -> Selection:
    """A degraded round: a uniform subset of the budget with unit weights
    (``baselines.random_subset``'s convention), drawn from ``gen``."""
    budget = max(int(pgm_cfg.subset_fraction * n_units), 1)
    idx = torch.randperm(n_units, generator=gen)[:budget].to(torch.int32)
    return Selection(idx.to(device), torch.ones((budget,), device=device),
                     budget, torch.zeros((1,), device=device))


class _Captured(NamedTuple):
    units: dict                    # the corpus the graph reads
    graph: "torch.cuda.CUDAGraph"  # one chunk at the cursor
    out: torch.Tensor              # (n_units, D), a chunk a replay
    n_chunks: int                  # replays a round
    cursor: tuple                  # the cursor and the chunk's row
                                   # offsets the graph reads, kept alive


class ResidentSelector:
    """Selection rounds over the engine's device-resident units.

    Stage A is ``units_gradients_batched`` over every unit of a corpus,
    ``chunk_units`` units a chunk (the reference's scan over chunks),
    then stage B as in ``pgm_select``.

    On the card each corpus (train, val) gets one CUDA graph, captured at
    its first round and replayed every round: the graph gathers one chunk
    of units at a cursor on the card, runs the chunk's pass, writes its
    vectors into the corpus's output at the cursor's rows and advances
    the cursor modulo the corpus, so a round is one replay a chunk and
    the cursor is back at 0 after it (the counterpart of the reference's
    one jitted scan body).  A replay makes no Python call, so the
    kernels' launch counters see only the warm-up (the first chunk, on a
    side stream) and the capture.  The graph reads fixed addresses:

    * the params: the first call's tensors are adopted (the scan engine's
      buffers, which its optimizer updates in place); a later call with
      other tensors (the host engine, a restored or re-initialised state)
      has them copied into the adopted ones leaf by leaf, so a replay
      never reads stale params;
    * the units: each corpus is the tensors it was captured against; a
      corpus of other tensors gets a graph of its own;
    * the projections, fixed at construction;
    * an untied LM head as the (V, d) rows the grad-sketch kernel reads:
      a buffer that a small graph of its own copies the head into, once
      a pass before the chunks (in the chunk graph the copy would run
      once a chunk).

    Graphs share one memory pool; each round's vectors are cloned out of
    the output.  ``captures`` (the corpus graphs) and ``replays`` (chunks
    run through them) are totals over every selector, reset by the caller
    as ``EpochEngine``'s are.  On the CPU the same function runs over the
    whole corpus without a graph.

    Failure: on the card a round that fails raises, whatever
    ``on_failure`` says (a fallback would hide the kernel).  On the CPU,
    the plain route, ``on_failure="soft_random"`` (the default) degrades
    a failed round to a uniform subset of the budget with unit weights,
    drawn from a generator keyed on the round, and counts it in
    ``degraded_rounds``; ``"raise"`` re-raises.
    """

    captures = 0
    replays = 0

    def __init__(self, bundle, pgm_cfg, proj: Optional[Projections] = None,
                 *, chunk_units: Optional[int] = None, mesh=None,
                 data_axis: str = "data", vocab_chunk: int = 8192,
                 on_failure: str = "soft_random", log_fn=None):
        if mesh is not None:
            from repro_torch.launch.mesh import require_mesh
            require_mesh(mesh)
        self.mesh = mesh
        self.data_axis = data_axis
        self._blocks = []              # (corpus, this rank's block views)
        if on_failure not in ("soft_random", "raise"):
            raise ValueError(f"on_failure must be 'soft_random' or 'raise', "
                             f"got {on_failure!r}")
        self.bundle = bundle
        self.cfg = pgm_cfg
        self.on_failure = on_failure
        self._log = log_fn or (lambda s: None)
        self._proj = proj
        self._chunk_units = chunk_units
        self._vocab_chunk = vocab_chunk
        self._exact = not pgm_cfg.use_sketch
        self._rt = _router_term_for(bundle, pgm_cfg)
        self.degraded_rounds = 0
        self._round = 0
        self._params = None            # the tensors the graphs read
        self._captured = []            # one _Captured per corpus
        self._pool = None
        self._head_rows = None         # an untied head's (V, d) copy
        self._head_graph = None        # ... and the graph refreshing it

    def _fn(self, params, units) -> torch.Tensor:
        # the module global, looked up at each call: the fault injector
        # (train/faults.py:failing_selection_kernels) patches it
        return units_gradients_batched(
            self.bundle, params, units, self._proj,
            chunk_units=self._chunk_units, vocab_chunk=self._vocab_chunk,
            exact=self._exact, head_rows=self._head_rows,
            kernel_impl=self.cfg.kernel_impl, router_term=self._rt)

    def _bind(self, params) -> None:
        if self._params is None:
            self._params = params
            self._pool = torch.cuda.graph_pool_handle()
            self._capture_head_copy()
        elif any(a is not b for a, b in zip(tree_leaves(self._params),
                                             tree_leaves(params))):
            commit_(self._params, params)

    def _capture_head_copy(self) -> None:
        """For an untied LM head on the sketch path: copy it to (V, d)
        rows and capture that copy (the kernel reads the tied embedding in
        place)."""
        if self.bundle.cfg.family == "rnnt" or self._exact:
            return
        w = self.bundle.head_weight(self._params).detach()
        if w.t().is_contiguous():
            return
        self._head_rows = w.t().contiguous()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            self._head_rows.copy_(w.t())
        self._head_graph = graph

    def _capture(self, units) -> _Captured:
        """Warm up on the first chunk on a side stream, then capture one
        chunk at the cursor; a failure raises."""
        dev = units["tokens"].device
        U = units["tokens"].shape[0]
        cu = _chunk_size(U, self._chunk_units)
        cursor = torch.zeros((), dtype=torch.long, device=dev)
        offsets = torch.arange(cu, device=dev)
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            first = self._fn(self._params,
                             {k: v[:cu] for k, v in units.items()})
        cur.wait_stream(side)
        out = torch.empty((U,) + first.shape[1:], dtype=first.dtype,
                          device=dev)
        del first
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            rows = cursor + offsets
            out.index_copy_(0, rows, self._fn(
                self._params,
                {k: v.index_select(0, rows) for k, v in units.items()}))
            cursor.add_(cu).remainder_(U)
        ResidentSelector.captures += 1
        self._log(f"resident stage A: one CUDA graph captured over a chunk "
                  f"of {cu} of {U} units")
        return _Captured(units, graph, out, U // cu, (cursor, offsets))

    def stage_a(self, params, units) -> torch.Tensor:
        """(n_units, D) stage-A gradient representations: on the card one
        replay of the corpus's graph a chunk (captured at its first
        round)."""
        if units["tokens"].device.type != "cuda":
            return self._fn(params, units)
        self._bind(params)
        entry = next((c for c in self._captured
                      if c.units.keys() == units.keys()
                      and all(c.units[k] is units[k] for k in units)), None)
        if entry is None:
            entry = self._capture(units)
            self._captured.append(entry)
        if self._head_graph is not None:
            self._head_graph.replay()
        for _ in range(entry.n_chunks):
            entry.graph.replay()
        ResidentSelector.replays += entry.n_chunks
        return entry.out.clone()

    def _block(self, units):
        """This rank's block of a corpus, as views made once a corpus (a
        captured stage A reads the tensors it was captured against)."""
        for corpus, block in self._blocks:
            if corpus.keys() == units.keys() and \
                    all(corpus[k] is units[k] for k in units):
                return block
        lo, hi = unit_block(self.mesh, self.data_axis,
                            int(units["tokens"].shape[0]))
        block = {k: v[lo:hi] for k, v in units.items()}
        self._blocks.append((units, block))
        return block

    def _select_round(self, params, units, val_units) -> Selection:
        n_units = int(units["tokens"].shape[0])
        sharded = _sharded_axis(self.mesh, self.data_axis, self.cfg,
                                n_units)
        g = self.stage_a(params, self._block(units) if sharded else units)
        g_val = None
        if self.cfg.val_matching:
            gv = self.stage_a(params, val_units)
            g_val = _val_target(gv, n_units, self.cfg)
        return _stage_b(g, self.cfg, g_val=g_val,
                        mesh=self.mesh if sharded else None,
                        data_axis=self.data_axis)

    def __call__(self, params, units, val_units=None) -> Selection:
        self._round += 1
        try:
            return self._select_round(params, units, val_units)
        except Exception as err:
            dev = units["tokens"].device
            if dev.type == "cuda" or self.on_failure != "soft_random":
                raise
            self.degraded_rounds += 1
            self._log(f"warning: selection scorer failed ({err}); "
                      f"degrading this round to a soft-random subset")
            return _soft_random_selection(
                torch.Generator().manual_seed(self._round),
                units["tokens"].shape[0], self.cfg, dev)
