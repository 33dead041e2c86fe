"""Training engines of the port (the reference's ``train/engine.py`` on
one device: ``make_step_core``, ``newbob_step``,
``autotune_loss_vocab_chunk``, ``EpochEngine``, ``HostEngine`` and
``make_engine``).

``HostEngine`` runs one step per host-assembled batch of the (seed,
epoch)-keyed plans and reads each step's loss back: the parity oracle.
``EpochEngine`` (``engine="scan"``) keeps the units on the device and
runs an epoch as one captured CUDA graph of the training step, replayed
once per plan row; it reads the losses back once an epoch, or once a
chunk of epochs with ``run_epochs`` (validation and the newbob update
then run on the device between epochs).  On the CPU, which only the
tests ask for, it runs the same device-resident loop without a graph.

With a ``mesh`` (``launch/mesh.py``: a ``DeviceMesh``, one process a
rank) both engines train data-parallel (:class:`MeshContext`), through
the one step of ``make_step_core``: every rank holds the whole params,
optimizer state and its pod's error-feedback state; each rank computes
the loss of its slice of the batch's examples, scaled so that the ranks'
mean is the global weighted mean (ROADMAP hazard D1); the gradients are
averaged over the data axes in fp32, and over a ``pod`` axis through
``train/compress.py:compressed_psum`` (``TrainConfig.compress_mode``,
the reference's two-level ``data x pod`` step); every rank then clips by
the norm of the whole averaged gradient (D5) and updates.  On the card
the scan engine's captured graph holds these collectives (NCCL; D6).

The non-finite guard (``TrainConfig.nonfinite_guard``) checks each
step's loss and clipped gradient norm on the device and folds the result
into the optimizer's ``gate_step`` select, as the reference does: a
poisoned batch leaves params and optimizer state bit for bit as they
were, and a guarded run on finite data is bitwise the unguarded one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.chunking import auto_vocab_chunk
from repro_torch.data.pipeline import epoch_plan, subset_epoch_plan
from repro_torch.models.api import build_model
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.train.optim import (clip_by_global_norm, commit_,
                                     make_update_for, make_update_in_place,
                                     require_masters)


def make_step_core(bundle, cfg: TrainConfig, update=None, ctx=None):
    """One weighted SGD step: ``step(params, opt_state, batch, lr,
    step_on=None, err=None) -> (params, opt_state, metrics)``.  Gradients
    come from autograd through the fused loss's analytic backward, and
    ``update`` (default: the functional ``optim.make_update_for(cfg)``
    update, which leaves its inputs untouched) applies them;
    ``EpochEngine`` passes ``optim.make_update_in_place(cfg)``, which
    writes into the trees and returns them.  ``step_on`` (0-dim bool
    tensor) gates the update.

    With ``cfg.nonfinite_guard`` the step also gates on ``isfinite(loss)
    & isfinite(gnorm)`` (the clip's global norm: any NaN/Inf gradient
    leaf poisons it, and a finite tree whose norm overflows is gated off
    too), zeroes the metrics of a gated-off step and reports
    ``metrics["skipped"]``, whether a live step was suppressed.  Nothing
    is read back to the host.  Params that are not fp32 masters are
    refused (``optim.require_masters``).  The loss differentiated (and
    guarded) is ``bundle.loss_fn``'s total: for an MoE bundle the
    weighted task loss plus the load-balance aux, which
    ``metrics["aux_loss"]`` carries; ``metrics["loss"]`` is the task
    loss the epochs report, as the reference's engine has them.

    With ``ctx`` (a :class:`MeshContext`) the step is data-parallel:
    ``batch`` is the whole batch and this rank takes the loss of its
    examples, scaled so that the ranks' mean is the global weighted mean
    (D1); the gradients are averaged over the data axes and compressed
    over the pod axis (``ctx.reduce_grads``: top-k over whole leaves,
    D2, advancing ``err``, this rank's pod's error-feedback state, in
    place); the metrics are the ranks' means; the clip reads the norm of
    the whole averaged gradient, the same on every rank, as does the
    guard, which gates every rank off the same step and leaves ``err``
    bit for bit (D5).  A data group of one averages nothing, so at world
    size 1 the step is the one-device step's arithmetic."""
    opt_update = make_update_for(cfg)[1] if update is None else update
    guard = bool(cfg.nonfinite_guard)

    def step(params, opt_state, batch, lr, step_on=None, err=None):
        require_masters(params)
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(live)
        if ctx is not None:
            batch = ctx.slice_batch(batch)
            scale = ctx.scale(batch)
        with torch.enable_grad():
            total, metrics = bundle.loss_fn(live, batch)
            if ctx is not None:
                total = metrics["loss"] * scale + metrics["aux_loss"]
            grad_leaves = torch.autograd.grad(total, leaves)
        by_id = {id(l): g for l, g in zip(leaves, grad_leaves)}
        grads = tree_map(lambda p: by_id[id(p)], live)
        # only `grads` holds the raw gradients now: rebinding it to the
        # clipped tree frees them before the update allocates new params
        del grad_leaves, by_id
        with torch.no_grad():
            metrics = {k: v.detach() for k, v in metrics.items()}
            if ctx is not None:
                grads, new_err = ctx.reduce_grads(grads, err)
                metrics = ctx.mean_metrics(metrics, scale)
                total = metrics["total_loss"]
            grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
            ok = step_on
            if guard:
                finite = torch.isfinite(total) & torch.isfinite(gnorm)
                ok = finite if step_on is None else step_on & finite
            params, opt_state = opt_update(params, grads, opt_state, lr,
                                           step_on=ok)
            if err is not None:
                for old, new in zip(tree_leaves(err), tree_leaves(new_err)):
                    old.copy_(new if ok is None else
                              torch.where(ok, new, old))
            metrics["grad_norm"] = gnorm
            if ok is not None:
                metrics = {k: torch.where(ok, v, torch.zeros_like(v))
                           for k, v in metrics.items()}
            if guard:
                live = (torch.ones_like(finite) if step_on is None
                        else step_on)
                metrics["skipped"] = live & ~finite
        return params, opt_state, metrics

    return step


class PodSpec(NamedTuple):
    """The two-level ``data x pod`` step's slow cross-pod axis: its name,
    its pod count and the ``train/compress.py`` compressor of its
    gradient collective."""

    axis: str
    n_pods: int
    mode: str          # none | bf16 | topk
    k_frac: float      # top-k fraction a leaf (mode == "topk")


def _compress_check(cfg: TrainConfig, axes) -> None:
    """A compressor needs a pod axis among the mesh's ``axes`` (None: no
    mesh)."""
    if cfg.compress_mode != "none" and cfg.pod_axis not in (axes or ()):
        raise ValueError(
            f"compress_mode={cfg.compress_mode!r} needs a mesh with a "
            f"{cfg.pod_axis!r} axis (e.g. --mesh 2x2 with axes "
            f"data x pod); got mesh={axes}")


class MeshContext:
    """An engine's distribution on ``mesh``: this rank's slice of each
    batch and the step's collectives.

    * Storage: every rank holds the whole params, optimizer state and
      its pod's whole error-feedback state (replicated, as DDP does).
      Shards gathered whole once a step, the only granularity there is
      without per-layer gathers, would peak at the same memory and move
      more; sharded storage pays with per-layer gathers (ROADMAP queue
      1, item 17).  The mesh's ``SpecBuilder`` gives the batch axes.
    * Compute: a batch's examples split into ``n_pods`` slices, pod-major
      (the reference's ``(pod, data)`` placement), and each pod slice
      over the spec's batch axes (``data``; every axis but pod and
      expert in ``fsdp_batch``) when they divide it, else every rank of
      the pod computes the pod's slice.  Ranks along ``model`` compute
      the same examples.  The units are held whole on every rank.
    * D7: an MoE bundle groups tokens over the reference's whole batch
      (M1); when a rank's tokens are not a whole number of those groups
      the grouping cannot be reproduced, and the engine raises."""

    def __init__(self, mesh, cfg: TrainConfig, bundle, spec_mode: str,
                 batch_units: int, unit_size: int, seq: int):
        import torch.distributed as dist

        from repro_torch.launch.mesh import (axes_group, axis_names,
                                             coordinate, mesh_shape,
                                             require_mesh)
        from repro_torch.sharding.specs import SpecBuilder

        require_mesh(mesh)
        self.shape = mesh_shape(mesh)
        names = axis_names(mesh)
        pod_active = cfg.pod_axis in names
        _compress_check(cfg, names)
        n_pods = self.shape[cfg.pod_axis] if pod_active else 1
        self.pod = (PodSpec(cfg.pod_axis, n_pods, cfg.compress_mode,
                            cfg.compress_k_frac) if pod_active else None)
        self.spec = SpecBuilder(mesh, mode=spec_mode,
                                pod_axis=cfg.pod_axis if pod_active else None,
                                arch=bundle.cfg.name)
        self.coord = coordinate(mesh)
        self.is_writer = dist.get_rank() == 0
        n_examples = batch_units * unit_size
        if n_examples % n_pods:
            raise ValueError(
                f"batch ({batch_units} units x {unit_size} "
                f"examples) must divide into n_pods={n_pods} equal "
                f"per-pod slices")
        per_pod = n_examples // n_pods
        batch_axes = self.spec.batch_axes
        size = math.prod(self.shape[a] for a in batch_axes)
        #: the data ranks a pod slice splits over (1: not split, and the
        #: step averages nothing over them)
        self.n_data = size if size > 1 and per_pod % size == 0 else 1
        self.data_group = (axes_group(mesh, batch_axes) if self.n_data > 1
                           else None)
        self.pod_group = (mesh.get_group(cfg.pod_axis) if pod_active
                          else None)
        j = 0
        for a in batch_axes:
            j = j * self.shape[a] + self.coord[a]
        per_rank = per_pod // self.n_data
        pod_i = self.coord[cfg.pod_axis] if pod_active else 0
        self.lo = pod_i * per_pod + (j if self.n_data > 1 else 0) * per_rank
        self.hi = self.lo + per_rank
        if bundle.cfg.family == "moe" and self.n_data > 1:
            from repro_torch.models.moe import DEFAULT_GROUP
            g = min(DEFAULT_GROUP, per_pod * seq)
            if (per_rank * seq) % g:
                raise ValueError(
                    f"MoE groups (ROADMAP hazards M1 and D7): a rank's "
                    f"{per_rank * seq} tokens ({per_rank} examples x "
                    f"{seq}) are not a whole number of the reference's "
                    f"groups of {g} tokens over its batch of {per_pod} "
                    f"examples; the data-parallel step cannot reproduce "
                    f"its grouping (grow the batch or drop the data axis)")

    # -- the step's collectives -------------------------------------------
    def slice_batch(self, batch):
        """This rank's examples of a whole batch (views)."""
        if self.hi - self.lo == int(next(iter(batch.values())).shape[0]):
            return batch
        return {k: v[self.lo:self.hi] for k, v in batch.items()}

    def _sum(self, t: torch.Tensor, group) -> torch.Tensor:
        import torch.distributed as dist
        dist.all_reduce(t, group=group)
        return t

    def scale(self, batch) -> torch.Tensor:
        """The factor of this rank's weighted mean loss on its slice
        ``batch`` that makes the ranks' mean the global weighted mean
        (D1): ``W_r / mean_data W`` within the pod, times ``W_pod /
        mean_pods W_pod`` across pods (``W``: the slice's weight sum, or
        its example count without weights)."""
        first = next(iter(batch.values()))
        w = batch.get("weights")
        w = (torch.sum(w.to(torch.float32)) if w is not None else
             torch.full((), float(first.shape[0]), device=first.device))
        w = w.reshape(1)
        if self.n_data > 1:
            w_pod = self._sum(w.clone(), self.data_group)
            s = w / torch.clamp(w_pod / self.n_data, min=1e-9)
        else:
            w_pod, s = w, None
        if self.pod is not None:
            w_all = self._sum(w_pod.clone(), self.pod_group)
            sp = w_pod / torch.clamp(w_all / self.pod.n_pods, min=1e-9)
            s = sp if s is None else s * sp
        return (torch.ones_like(w) if s is None else s).reshape(())

    def mean_metrics(self, metrics, scale):
        """The ranks' means of this rank's scaled task loss and its aux
        -> ``loss``, ``aux_loss``, ``total_loss``."""
        from repro_torch.train.compress import _mean
        values = [(metrics["loss"] * scale).to(torch.float32),
                  metrics["aux_loss"].to(torch.float32)]
        if self.n_data > 1:
            values = _mean(values, self.data_group, self.n_data,
                           torch.float32)
        if self.pod is not None:
            values = _mean(values, self.pod_group, self.pod.n_pods,
                           torch.float32)
        loss, aux = values
        return {"loss": loss, "aux_loss": aux, "total_loss": loss + aux}

    def reduce_grads(self, grads, err):
        """The data axes' fp32 mean, then the pod axis's compressed mean
        -> (mean gradient tree, the pod's new error state)."""
        from repro_torch.train.compress import _mean, compressed_psum
        if self.n_data > 1:
            leaves = tree_leaves(grads)
            red = _mean(leaves, self.data_group, self.n_data, torch.float32)
            grads = tree_unflatten(grads, red)
        if self.pod is None:
            return grads, err
        return compressed_psum(grads, self.pod_group, self.pod.mode, err,
                               self.pod.k_frac)

    def gather_pods(self, tree):
        """The ``(n_pods, *shape)`` stack of every pod's copy of a
        params-shaped tree (a collective over the pod axis, in one
        buffer)."""
        from repro_torch.launch.mesh import all_gather_flat
        n = self.pod.n_pods
        leaves = tree_leaves(tree)
        flat = torch.cat([l.reshape(-1) for l in leaves])
        got = torch.empty((n * flat.numel(),), dtype=flat.dtype,
                          device=flat.device)
        all_gather_flat(got, flat, self.pod_group)
        got = got.view(n, -1)
        out, at = [], 0
        for l in leaves:
            out.append(got[:, at:at + l.numel()].reshape(
                (n,) + tuple(l.shape)))
            at += l.numel()
        return tree_unflatten(tree, out)

    def any(self, flag: bool) -> bool:
        """``flag`` on any rank (a host-side collective)."""
        import torch.distributed as dist
        t = torch.tensor([int(bool(flag))], dtype=torch.int32)
        if dist.get_backend() == "nccl":
            t = t.cuda()
        dist.all_reduce(t)
        return bool(t.item())


def autotune_loss_vocab_chunk(bundle, units, batch_units: int):
    """Resolve ``RNNTConfig.loss_vocab_chunk == 0`` ("auto") into the
    chunk width the reference picks for the same shapes (rows =
    ``B * (U+1) + joint_dim``, the shared ``auto_vocab_chunk`` budget),
    rebuilding the bundle only when that width is below the vocab.
    Returns ``(bundle, resolved_chunk)``; ``(bundle, None)`` for a bundle
    that is not RNN-T."""
    r = bundle.cfg.rnnt
    if bundle.cfg.family != "rnnt" or r is None:
        return bundle, None
    if r.loss_vocab_chunk != 0:
        return bundle, r.loss_vocab_chunk
    unit_size = int(units["tokens"].shape[1])
    U = int(units["tokens"].shape[2])
    rows = int(batch_units) * unit_size * (U + 1) + int(r.joint_dim)
    tuned = auto_vocab_chunk(rows, int(r.vocab_size))
    if tuned >= int(r.vocab_size):
        return bundle, tuned
    cfg_new = dataclasses.replace(
        bundle.cfg, rnnt=dataclasses.replace(r, loss_vocab_chunk=tuned))
    return build_model(cfg_new), tuned


def plan_live_steps(plan) -> np.ndarray:
    """Host-side mask of a plan's real (non-padding) rows: a row of ids
    -1 is padding, excluded from the epoch's mean loss."""
    return np.asarray(plan[0])[:, 0] >= 0


def to_device(units: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in units.items()}


def newbob_step(lr: torch.Tensor, prev_loss: torch.Tensor,
                val_loss: torch.Tensor, anneal_factor: float,
                threshold: float):
    """The device-side newbob update (the reference's ``newbob_step``,
    twin of ``optim.NewbobState.update``) on 0-dim fp32 tensors: anneal
    ``lr`` by ``anneal_factor`` when the relative validation improvement
    over ``prev_loss`` falls below ``threshold``.  ``prev_loss = inf``
    (the first epoch) and a NaN ``val_loss`` (no validation set) leave
    ``lr`` as it is.  -> (lr, new prev_loss); nothing is read back."""
    rel = (prev_loss - val_loss) / torch.clamp(torch.abs(prev_loss),
                                               min=1e-9)
    anneal = (prev_loss != float("inf")) & (rel < threshold)
    return torch.where(anneal, lr * anneal_factor, lr), val_loss


def _plan_tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)




class _MeshState:
    """The mesh parts the engines share: the error-feedback state, the
    whole ``(n_pods, *shape)`` state a checkpoint holds, and
    ``restore_sharding``.  Without a mesh they are inert."""

    ctx: Optional[MeshContext] = None
    compress_state = None

    def _mesh_setup(self, mesh, cfg, bundle, spec_mode, units) -> None:
        self.ctx = None
        if mesh is None:
            _compress_check(cfg, None)
            return
        tok = units["tokens"]
        self.ctx = MeshContext(mesh, cfg, bundle, spec_mode,
                               self.batch_units, int(tok.shape[1]),
                               int(tok.shape[-1]))

    @property
    def mesh_shape(self):
        """``{axis: size}`` of the mesh (None without one)."""
        return None if self.ctx is None else dict(self.ctx.shape)

    @property
    def pod_axis(self):
        return (None if self.ctx is None or self.ctx.pod is None
                else self.ctx.pod.axis)

    @property
    def is_writer(self) -> bool:
        """Whether this rank prints and writes checkpoints (rank 0)."""
        return self.ctx is None or self.ctx.is_writer

    @property
    def uses_error_feedback(self) -> bool:
        """True when the engine carries per-pod top-k residuals, which
        the loop checkpoints under ``err``."""
        return (self.ctx is not None and self.ctx.pod is not None
                and self.ctx.pod.mode == "topk")

    def init_compress_state(self, params):
        """Zero error-feedback state: this rank's pod's residuals, shaped
        like ``params``; None unless the engine compresses with error
        feedback."""
        if not self.uses_error_feedback:
            return None
        from repro_torch.train.compress import init_error_state
        return init_error_state(params)

    def init_compress_state_once(self, params):
        """The error-feedback state, made (zero) at its first use."""
        if self.uses_error_feedback and self.compress_state is None:
            self.compress_state = self.init_compress_state(params)
        return self.compress_state

    def set_compress_state(self, err) -> None:
        """Take a restored error-feedback tree (this rank's pod's), or
        zero residuals for ``None``: copied into the engine's buffers
        when they exist (a captured step reads them), else adopted (for
        ``None``, made zero at first use)."""
        if not self.uses_error_feedback:
            return
        if self.compress_state is None:
            self.compress_state = err
            return
        olds = tree_leaves(self.compress_state)
        news = [None] * len(olds) if err is None else tree_leaves(err)
        for old, new in zip(olds, news):
            if new is None:
                old.zero_()
            else:
                old.copy_(new)

    def full_err(self):
        """The whole ``(n_pods, *shape)`` error-feedback tree (a
        collective over the pod axis), what a checkpoint holds under
        ``err``."""
        return self.ctx.gather_pods(self.compress_state)

    def restore_sharding(self, path: str, arr):
        """``checkpoint.restore(sharding_fn=...)``: this rank's part of a
        whole restored array: an ``err`` leaf ``(n_pods, *shape)`` gives
        its pod's residuals, any other leaf is whole on every rank.  A
        checkpoint of any mesh restores onto any other."""
        if self.ctx is not None and "['err']" in path:
            return np.asarray(arr)[self.ctx.coord[self.pod_axis]]
        return arr

    def barrier(self) -> None:
        if self.ctx is not None:
            import torch.distributed as dist
            dist.barrier()

    def any_rank(self, flag: bool) -> bool:
        return bool(flag) if self.ctx is None else self.ctx.any(flag)


class EpochEngine(_MeshState):
    """The scanned epoch engine on one device (``engine="scan"``).

    Residency: ``units`` and ``val_units`` move to the device once; each
    step gathers its batch from them with the plan row's ids.

    Plans: ``full_plan`` / ``subset_plan`` return host arrays ``(idx, w)``
    of shape ``(n_steps, batch_units)``, pure functions of ``(seed, salt,
    epoch)`` (so a prefetch thread can build them).  Full plans have
    ``steps_per_epoch_max`` rows; subset plans are padded with rows of id
    -1 and weight 0 up to ``bucket_steps(live)``, the next multiple of
    ``plan_granule``.  A padding row runs the step on unit 0 and gates
    it off (``step_on = idx[0] >= 0`` through ``optim.gate_step``): a
    bitwise no-op on params and optimizer state, its loss reported as 0.
    ``epoch_cost`` charges the rows run, padding included.

    Capture: the engine owns static buffers for params, optimizer state,
    ``lr``, one plan of ``steps_per_epoch_max`` rows, a step cursor and
    the per-step loss and skip outputs.  On the card, at its first run,
    it warms the step up on a side stream on padding rows (gated off, so
    no copy of the state is needed) and captures one step with
    ``torch.cuda.graph``; every plan of every bucket replays that graph,
    once per row, since a row only changes what the replay reads.
    Selection rounds and resume do not recapture.  A capture or replay
    that fails raises: nothing falls back to eager steps or to
    ``HostEngine``.  On the CPU the same step body runs once per row
    without a graph.  A replay makes no Python call, so the kernels'
    launch counters, which count at the launch site, see the warm-up
    steps and the capture only; what a replay launches is read from a
    profiler trace of it.

    Aliasing: ``run_epoch`` / ``run_epochs`` copy the caller's params
    and state into the buffers when they are not those buffers, and
    return the buffers themselves, which the next run updates in place
    (the reference donates its carry): a caller that keeps an epoch's
    state copies it.

    Guard: with ``cfg.nonfinite_guard`` each step's skip flag and the
    count ride device buffers; ``last_skipped`` (per step, ``(n,)`` or
    ``(E, n)``) and ``last_n_skipped`` are device tensors of the last
    run, read by the caller once an epoch or chunk.  ``plan_salt``
    re-keys the plans after a watchdog rollback.
    """

    kind = "scan"
    #: gated-off steps run before the capture
    WARMUP_STEPS = 2
    #: totals over every engine, reset by the caller like the kernels'
    #: launch counters: graphs captured, replays, warm-up steps on the card
    captures = 0
    replays = 0
    warmup_steps = 0

    def __init__(self, bundle, cfg: TrainConfig, units: Dict[str, np.ndarray],
                 val_units: Optional[Dict[str, np.ndarray]] = None,
                 batch_units: int = 1,
                 device: torch.device = torch.device("cpu"), mesh=None,
                 spec_mode: str = "tp"):
        bundle, self.loss_vocab_chunk = autotune_loss_vocab_chunk(
            bundle, units, batch_units)
        self.bundle = bundle
        self.cfg = cfg
        self.device = dev = torch.device(device)
        self.batch_units = int(batch_units)
        self._mesh_setup(mesh, cfg, bundle, spec_mode, units)
        if mesh is not None and dev.type == "cuda":
            import torch.distributed as dist
            if dist.get_backend() != "nccl":
                raise ValueError(
                    f"EpochEngine on the card captures its step, and the "
                    f"step's collectives, in a CUDA graph (ROADMAP hazard "
                    f"D6); {dist.get_backend()} collectives cannot be "
                    f"captured: use NCCL, or engine='host'")
        self.units = to_device(units, dev)
        self.val_units = (None if val_units is None
                          else to_device(val_units, dev))
        self.n_units = int(self.units["tokens"].shape[0])
        self.unit_size = int(self.units["tokens"].shape[1])
        #: full-data step count, the rows of every plan at most
        self.steps_per_epoch_max = n = self.n_units // self.batch_units
        #: bucket granule of padded subset plans (1/8 of a full epoch)
        self.plan_granule = max(n // 8, 1)
        self.guard = bool(cfg.nonfinite_guard)
        self.plan_salt = 0
        self.last_skipped: Optional[torch.Tensor] = None
        self.last_n_skipped: Optional[torch.Tensor] = None
        self._step = make_step_core(bundle, cfg,
                                    update=make_update_in_place(cfg),
                                    ctx=self.ctx)
        self._plan_idx = torch.full((n, self.batch_units), -1,
                                    dtype=torch.int32, device=dev)
        self._plan_w = torch.zeros((n, self.batch_units), device=dev)
        self._k = torch.zeros((1,), dtype=torch.long, device=dev)
        self._lr = torch.zeros((), device=dev)
        self._losses = torch.zeros((n,), device=dev)
        self._skipped = torch.zeros((n,), device=dev)
        self._n_skipped = torch.zeros((), dtype=torch.int32, device=dev)
        #: the params and optimizer-state buffers (from the first run on)
        self.params = None
        self.opt_state = None
        self._graph = None

    # -- plans -------------------------------------------------------------
    def _plan_seed(self) -> int:
        return self.cfg.seed + 1_000_003 * self.plan_salt

    def full_plan(self, epoch: int):
        idx = epoch_plan(self.n_units, self._plan_seed(), epoch,
                         self.batch_units)
        return idx, np.ones(idx.shape, np.float32)

    def bucket_steps(self, n_live_steps: int) -> int:
        """A live step count rounded up to the next ``plan_granule``
        multiple, at least one granule, at most ``steps_per_epoch_max``."""
        g = self.plan_granule
        return min(max(-(-n_live_steps // g) * g, g),
                   self.steps_per_epoch_max)

    def subset_plan(self, indices, weights, epoch: int):
        """The weighted-subset plan padded to ``bucket_steps(live)``
        rows."""
        n_live = int((np.asarray(indices) >= 0).sum())
        return subset_epoch_plan(
            np.asarray(indices), np.asarray(weights), self._plan_seed(),
            epoch, self.batch_units,
            pad_to_steps=self.bucket_steps(n_live // self.batch_units))

    plan_live_steps = staticmethod(plan_live_steps)

    def epoch_cost(self, plan, use_full: bool = False,
                   n_selected: Optional[int] = None) -> float:
        """The rows run over a full epoch's, padding included: a padding
        row runs a whole step before it is gated off."""
        return np.shape(plan[0])[0] / self.steps_per_epoch_max

    # -- the step and its graph --------------------------------------------
    def adopt(self, params, opt_state) -> None:
        """Take the caller's tensors (on the engine's device) as the
        buffers, without a copy: the counterpart of the reference's
        donation.  The caller hands them over; the runs update them in
        place.  ``train_with_selection`` adopts its fresh initial state,
        so a 3B model's fp32 weights are not held twice at its first
        epoch."""
        self.params, self.opt_state = params, opt_state

    def _load(self, params, opt_state) -> None:
        """Make the buffers hold ``params`` and ``opt_state``: copies at
        the first run, leaf-by-leaf copies into them later (a restored or
        re-initialised state), nothing when they are the buffers."""
        if self.params is None:
            own = lambda x: x.detach().to(self.device, copy=True)
            self.params = tree_map(own, params)
            self.opt_state = tree_map(own, opt_state)
            return
        if params is not self.params:
            commit_(self.params, params)
        if opt_state is not self.opt_state:
            commit_(self.opt_state, opt_state)

    def _set_lr(self, lr) -> None:
        if isinstance(lr, torch.Tensor):
            self._lr.copy_(lr)
        else:
            self._lr.fill_(float(lr))

    def _body(self) -> None:
        """One step on plan row ``_k`` of the buffers, committed in place;
        the row's loss (and skip flag) written out and the cursor
        advanced.  What the graph captures: no host read."""
        k = self._k
        idx = self._plan_idx.index_select(0, k)[0]
        w = self._plan_w.index_select(0, k)[0]
        # a row is wholly real or wholly padding (ids -1, weight 0)
        live = idx[0] >= 0
        gidx = torch.clamp(idx, min=0).long()
        batch = {name: v.index_select(0, gidx).reshape((-1,) + v.shape[2:])
                 for name, v in self.units.items()}
        if "weights" in batch:
            batch["weights"] = batch["weights"] * w[:, None].expand(
                -1, self.unit_size).reshape(-1)
        _, _, metrics = self._step(self.params, self.opt_state, batch,
                                   self._lr, step_on=live,
                                   err=self.compress_state)
        self._losses.index_copy_(
            0, k, metrics["loss"].to(torch.float32).reshape(1))
        if self.guard:
            sk = metrics["skipped"]
            self._skipped.index_copy_(0, k, sk.to(torch.float32).reshape(1))
            self._n_skipped.add_(sk.to(torch.int32))
        k.add_(1)

    def _ensure_graph(self) -> None:
        """On the card, at the first run: warm the step up on a side
        stream on padding rows, then capture it once."""
        if self.device.type != "cuda" or self._graph is not None:
            return
        self._plan_idx.fill_(-1)
        self._plan_w.zero_()
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP_STEPS):
                self._k.zero_()
                self._body()
        cur.wait_stream(side)
        EpochEngine.warmup_steps += self.WARMUP_STEPS
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._body()
        self._graph = graph
        EpochEngine.captures += 1

    def _run_rows(self, idx: torch.Tensor, w: torch.Tensor) -> int:
        """Copy one plan into the plan buffer on the engine's stream
        (ordered before the replays that read it) and run every row."""
        n = int(idx.shape[0])
        if n > self.steps_per_epoch_max or \
                tuple(idx.shape[1:]) != (self.batch_units,):
            raise ValueError(
                f"plan of shape {tuple(idx.shape)}: at most "
                f"{self.steps_per_epoch_max} rows of {self.batch_units}")
        self._plan_idx[:n].copy_(idx)
        self._plan_w[:n].copy_(w)
        self._k.zero_()
        self._losses.zero_()
        self._skipped.zero_()
        if self._graph is None:
            for _ in range(n):
                self._body()
            return n
        for _ in range(n):
            self._graph.replay()
        EpochEngine.replays += n
        return n

    def _val_mean(self, params) -> torch.Tensor:
        """Mean of the per-unit mean validation losses, on the device
        (with a mesh every rank validates every unit)."""
        n_val = int(self.val_units["tokens"].shape[0])
        with torch.no_grad():
            per_unit = [self.bundle.per_example_loss(
                params, {k: v[i] for k, v in self.val_units.items()}).mean()
                for i in range(n_val)]
        return torch.stack(per_unit).to(torch.float32).mean()

    # -- epochs ------------------------------------------------------------
    def run_epoch(self, params, opt_state, lr, plan):
        """Every row of ``plan`` -> (params, opt_state, each row's loss as
        a float64 host array, 0 on padding rows), read back once.  The
        returned trees are the engine's buffers (see the class)."""
        idx = _plan_tensor(plan[0], torch.int32, self.device)
        w = _plan_tensor(plan[1], torch.float32, self.device)
        self._load(params, opt_state)
        self._set_lr(lr)
        self.init_compress_state_once(self.params)
        self._ensure_graph()
        self._n_skipped.zero_()
        n = self._run_rows(idx, w)
        losses = self._losses[:n].cpu().numpy().astype(np.float64)
        if self.guard:
            self.last_skipped = self._skipped[:n].clone()
            self.last_n_skipped = self._n_skipped.clone()
        return self.params, self.opt_state, losses

    def run_epochs(self, params, opt_state, lr, prev_loss, plans):
        """A chunk of epochs, the reference's ``chunk_epoch_body``: each
        epoch's rows, then validation and ``newbob_step`` on the device
        (the next epoch reads the annealed lr from the buffer); one read
        back for the whole chunk.  ``plans`` share one shape.  ->
        (params, opt_state, losses (E, n), val losses (E,), lrs (E,) after
        each epoch's update, lr_out, prev_loss_out); val losses are NaN
        without ``val_units``."""
        shapes = {tuple(np.shape(p[0])) for p in plans}
        if len(shapes) != 1:
            raise ValueError(f"chunked plans must share one shape, got "
                             f"{sorted(shapes)}")
        dev = self.device
        idx_all = torch.stack([_plan_tensor(p[0], torch.int32, dev)
                               for p in plans])
        w_all = torch.stack([_plan_tensor(p[1], torch.float32, dev)
                             for p in plans])
        prev = torch.tensor(prev_loss, dtype=torch.float32, device=dev)
        self._load(params, opt_state)
        self._set_lr(lr)
        self.init_compress_state_once(self.params)
        self._ensure_graph()
        E, n = int(idx_all.shape[0]), int(idx_all.shape[1])
        losses = torch.zeros((E, n), device=dev)
        skipped = torch.zeros((E, n), device=dev)
        vls = torch.full((E,), float("nan"), device=dev)
        lrs = torch.zeros((E,), device=dev)
        self._n_skipped.zero_()
        cfg = self.cfg
        for e in range(E):
            self._run_rows(idx_all[e], w_all[e])
            losses[e].copy_(self._losses[:n])
            skipped[e].copy_(self._skipped[:n])
            if self.val_units is not None:
                vl = self._val_mean(self.params)
                lr_n, prev = newbob_step(self._lr, prev, vl,
                                         cfg.anneal_factor,
                                         cfg.improvement_threshold)
                self._lr.copy_(lr_n)
                vls[e].copy_(vl)
            lrs[e].copy_(self._lr)
        host = torch.cat([losses.reshape(-1), vls, lrs, self._lr.reshape(1),
                          prev.reshape(1)]).cpu().numpy().astype(np.float64)
        if self.guard:
            self.last_skipped = skipped
            self.last_n_skipped = self._n_skipped.clone()
        return (self.params, self.opt_state, host[:E * n].reshape(E, n),
                host[E * n:E * n + E], host[E * n + E:E * n + 2 * E],
                float(host[-2]), float(host[-1]))

    def validate(self, params) -> float:
        """Mean per-unit validation loss (NaN without ``val_units``)."""
        if self.val_units is None:
            return float("nan")
        return float(self._val_mean(params))


class HostEngine(_MeshState):
    """The per-batch host loop: one step per host-assembled batch, one
    evaluation per validation unit.  Units are kept on the host (to
    assemble batches) and on the device (for selection rounds).

    ``plan_salt`` re-keys the batch plans: the divergence watchdog bumps
    it so that a rolled-back run replays on other batch orders
    (``seed + 1_000_003 * plan_salt``).  With the guard on,
    ``last_skipped`` holds the last epoch's per-step skip flags and
    ``last_n_skipped`` their count."""

    kind = "host"

    def __init__(self, bundle, cfg: TrainConfig, units: Dict[str, np.ndarray],
                 val_units: Optional[Dict[str, np.ndarray]] = None,
                 batch_units: int = 1,
                 device: torch.device = torch.device("cpu"), mesh=None,
                 spec_mode: str = "tp"):
        if cfg.compress_mode != "none":
            raise ValueError(
                f"compress_mode={cfg.compress_mode!r} is scan-engine-only "
                f"(the host loop trains dense); use engine='scan' with a "
                f"data x {cfg.pod_axis} mesh")
        bundle, self.loss_vocab_chunk = autotune_loss_vocab_chunk(
            bundle, units, batch_units)
        self.bundle = bundle
        self.cfg = cfg
        self.device = device
        self.batch_units = int(batch_units)
        self._mesh_setup(mesh, cfg, bundle, spec_mode, units)
        self.units_host = {k: np.asarray(v) for k, v in units.items()}
        self.units = to_device(self.units_host, device)
        self.val_units = (None if val_units is None
                          else to_device(val_units, device))
        self.n_units = int(self.units_host["tokens"].shape[0])
        self.unit_size = int(self.units_host["tokens"].shape[1])
        self.guard = bool(cfg.nonfinite_guard)
        self.plan_salt = 0
        self.last_skipped: Optional[np.ndarray] = None
        self.last_n_skipped: Optional[int] = None
        self._step = make_step_core(bundle, cfg, ctx=self.ctx)

    def _plan_seed(self) -> int:
        return self.cfg.seed + 1_000_003 * self.plan_salt

    def full_plan(self, epoch: int):
        idx = epoch_plan(self.n_units, self._plan_seed(), epoch,
                         self.batch_units)
        return idx, np.ones(idx.shape, np.float32)

    def subset_plan(self, indices, weights, epoch: int):
        return subset_epoch_plan(np.asarray(indices), np.asarray(weights),
                                 self._plan_seed(), epoch, self.batch_units)

    plan_live_steps = staticmethod(plan_live_steps)

    def epoch_cost(self, plan, use_full: bool = False,
                   n_selected: Optional[int] = None) -> float:
        """Paper-style charge: the fraction of units trained on."""
        if use_full or n_selected is None:
            return 1.0
        return float(n_selected) / self.n_units

    def run_epoch(self, params, opt_state, lr, plan):
        """Every plan row, padding rows included (a row of ids -1 runs on
        the last unit with weight 0, as the reference's host loop runs
        it) -> (params, opt_state, each row's loss)."""
        losses, skipped = [], []
        for sel, w in zip(*plan):
            batch = {k: v[sel].reshape((-1,) + v.shape[2:])
                     for k, v in self.units_host.items()}
            batch["weights"] = batch["weights"] * np.repeat(w, self.unit_size)
            params, opt_state, metrics = self._step(
                params, opt_state, to_device(batch, self.device), lr)
            losses.append(float(metrics["loss"]))  # repro_torch: noqa[host-sync-loop] -- HostEngine is the parity oracle: a read a step, as the reference's host loop
            if self.guard:
                skipped.append(float(metrics["skipped"]))  # repro_torch: noqa[host-sync-loop] -- the same step's skip flag
        if self.guard:
            self.last_skipped = np.asarray(skipped, np.float32)
            self.last_n_skipped = int(sum(skipped))
        return params, opt_state, np.asarray(losses, np.float64)

    def validate(self, params) -> float:
        if self.val_units is None:
            return float("nan")
        n_val = int(self.val_units["tokens"].shape[0])
        with torch.no_grad():
            return float(np.mean([
                float(self.bundle.per_example_loss(
                    params, {k: v[i] for k, v in self.val_units.items()}
                ).mean()) for i in range(n_val)]))


def make_engine(name: str, bundle, cfg: TrainConfig, units,
                val_units=None, batch_units: int = 1,
                device: torch.device = torch.device("cpu"), mesh=None,
                spec_mode: str = "tp"):
    """The engine factory the training loop consumes: ``"scan"`` (the
    default of ``train_with_selection``) or ``"host"``, each on ``mesh``
    when one is given."""
    kw = dict(val_units=val_units, batch_units=batch_units, device=device,
              mesh=mesh, spec_mode=spec_mode)
    if name == "scan":
        return EpochEngine(bundle, cfg, units, **kw)
    if name == "host":
        return HostEngine(bundle, cfg, units, **kw)
    raise ValueError(f"unknown engine {name!r}; 'scan' or 'host'")
