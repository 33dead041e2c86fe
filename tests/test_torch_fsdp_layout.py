"""PyTorch port, sharded storage (``repro_torch/sharding/specs.py``
``shard`` / ``unshard`` / ``err_spec``, the layout the engines store,
``train/engine.py:MeshContext``) against the JAX reference's
``EpochEngine.state_shardings`` / ``err_shardings`` on the CPU.

For every arch's ``-smoke`` config (the port's own draws, AdamW moments
and error-feedback residuals of random values) on the meshes (2,) data,
(4,) data, 2 x 2 data x model and 2 x 2 data x pod: the block each mesh
coordinate stores of every params, moments and ``err`` leaf is byte for
byte the reference's addressable shard on that coordinate's device of
``jax.device_put(leaf, state_shardings(...))`` (``err_shardings`` for
``err``) on 4 JAX host devices (one subprocess for the file; each
shard's sha256, shape and dtype are compared), the reference's meshes
built with ``Auto`` axes as ``tests/test_torch_dist_pod.py`` builds
them.  ``unshard`` of every coordinate's block is bitwise the leaf.
"""
import hashlib
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.common import flatten_with_path, tree_map  # noqa: E402
from repro_torch.sharding.specs import (SpecBuilder, err_spec, shard,  # noqa: E402
                                        unshard)

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = tuple(f"{a}-smoke" for a in ASSIGNED_ARCHS) + ("rnnt-crdnn-smoke",)
MESHES = (((2,), ("data",)), ((4,), ("data",)),
          ((2, 2), ("data", "model")), ((2, 2), ("data", "pod")))

_REF = """
import hashlib, pickle, sys, types
import numpy as np, jax
from jax.sharding import AxisType
from repro.sharding.specs import SpecBuilder
from repro.train.engine import EpochEngine
assert jax.device_count() == 4
cases, meshes = pickle.load(open(sys.argv[1], "rb"))
out = {}
for (shape, names) in meshes:
    n = int(np.prod(shape))
    mesh = jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape),
                         devices=jax.devices()[:n])
    pod = "pod" if "pod" in names else None
    for arch, trees in cases.items():
        eng = types.SimpleNamespace(
            spec=SpecBuilder(mesh, mode="tp", pod_axis=pod, arch=arch),
            pod_axis=pod, mesh=mesh)
        for name, tree in trees.items():
            if name == "err" and pod is None:
                continue
            fn = EpochEngine.err_shardings if name == "err" else \\
                EpochEngine.state_shardings
            placed = jax.device_put(tree, fn(eng, tree))
            for p, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
                for s in leaf.addressable_shards:
                    where = np.argwhere(mesh.devices == s.device)[0]
                    coord = tuple(int(c) for c in where)
                    a = np.ascontiguousarray(np.asarray(s.data))
                    out[(arch, shape, names, name, jax.tree_util.keystr(p),
                         coord)] = (hashlib.sha256(a.tobytes()).hexdigest(),
                                    a.shape, str(a.dtype))
pickle.dump(out, open(sys.argv[2], "wb"))
print("LAYOUT-REF-OK")
"""


def _digest(a):
    a = np.ascontiguousarray(a)
    return hashlib.sha256(a.tobytes()).hexdigest(), a.shape, str(a.dtype)


def _trees(arch):
    """The port's params of ``arch`` and AdamW moments and per-pod
    residuals of random values (numpy)."""
    gen = torch.Generator().manual_seed(0)
    params = tree_map(lambda t: t.numpy(), build_model(get_config(arch))
                      .init_params(gen, torch.device("cpu")))
    rng = np.random.default_rng(1)
    rand = lambda lead: lambda a: rng.standard_normal(  # noqa: E731
        lead + a.shape).astype(np.float32)
    opt = {"m": tree_map(rand(()), params), "v": tree_map(rand(()), params),
           "step": np.asarray(3, np.int32)}
    err = tree_map(rand((2,)), params)
    return {"params": params, "opt": opt, "err": err}


@pytest.fixture(scope="module")
def cases():
    return {arch: _trees(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def reference(cases, tmp_path_factory):
    d = tmp_path_factory.mktemp("layout_ref")
    with open(d / "in.pkl", "wb") as f:
        pickle.dump((cases, MESHES), f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF),
                        str(d / "in.pkl"), str(d / "out.pkl")],
                       capture_output=True, text=True, env=env, timeout=400)
    assert p.returncode == 0 and "LAYOUT-REF-OK" in p.stdout, \
        p.stderr[-3000:]
    with open(d / "out.pkl", "rb") as f:
        return pickle.load(f)


def _coords(shape, names):
    idx = np.indices(shape).reshape(len(shape), -1).T
    return [dict(zip(names, (int(i) for i in c))) for c in idx]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(m[1]) + "-" +
                         "x".join(map(str, m[0])))
def test_stored_blocks_are_the_reference_shards(cases, reference, arch,
                                                mesh):
    shape, names = mesh
    sizes = dict(zip(names, shape))
    pod = "pod" if "pod" in names else None
    spec = SpecBuilder(sizes, mode="tp", pod_axis=pod, arch=arch)
    n_cut = 0
    for name, tree in cases[arch].items():
        if name == "err" and pod is None:
            continue
        for path, leaf in flatten_with_path(tree):
            if name == "err":
                s = err_spec(pod, spec.param_spec(path, leaf.shape[1:]))
            else:
                s = spec.param_spec(path, leaf.shape)
            for coord in _coords(shape, names):
                got = shard(leaf, s, sizes, coord)
                key = (arch, shape, names, name, path, tuple(coord[a] for a
                                                             in names))
                assert _digest(got) == reference[key], (key, s)
                n_cut += got.size < leaf.size
            back = unshard(lambda c: shard(leaf, s, sizes, c), s,
                           leaf.shape, sizes)
            assert back.dtype == leaf.dtype and np.array_equal(back, leaf)
    assert n_cut > 0            # the mesh cuts some leaf of every arch


def test_dry_run_stores_quarters_and_saves_no_gathered_weight(tmp_path):
    """The dry run on a fake (4,) data mesh (``launch/dryrun.py``, the
    real ``MeshContext``): params, gradients and AdamW moments a rank are
    the blocks of the specs, a quarter of each leaf the axis divides and
    the whole of the rest; no saved tensor is a gathered weight (S2).
    The count sees one where a weight gathered outside a unit is saved
    (a one-rank gloo group)."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import build_and_count, saved_bytes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import fsdp

    arch = "starcoder2-3b-smoke"
    shape = ShapeConfig(name="t", seq_len=32, global_batch=8, kind="train")
    one = build_and_count(arch, shape, step="train", mesh={}, device="cpu")
    four = build_and_count(arch, shape, step="train", mesh={"data": 4},
                           device="cpu")
    spec = SpecBuilder({"data": 4}, mode="tp")
    gen = torch.Generator().manual_seed(0)
    params = build_model(get_config(arch)).init_params(
        gen, torch.device("cpu"))
    want = whole_only = 0
    for path, leaf in flatten_with_path(params):
        cut = any(spec.param_spec(path, leaf.shape))
        want += leaf.numel() * 4 // (4 if cut else 1)
        whole_only += 0 if cut else leaf.numel() * 4
    m1, m4 = one["memory"], four["memory"]
    assert m4["params"] == m4["grads"] == want
    assert m4["opt_state"] == 2 * want + 4          # m, v and the step
    assert 0 < whole_only < m4["params"] < m1["params"] / 2
    assert (m1["params"] - whole_only) == 4 * (m4["params"] - whole_only)
    assert four["saved_gathered"] == 0 and one["saved_gathered"] == 0
    # the count's control: a weight gathered outside a unit and saved
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "s"), 1))
    try:
        mesh = make_mesh((1,), ("data",), "cpu")
        w = torch.ones((4, 4), requires_grad=True)
        lay = fsdp.Store(mesh, ("data",)).layout(("data", None), (4, 4))
        with fsdp.gathering([(w, lay)]), saved_bytes() as s:
            x = torch.ones((2, 4), dtype=torch.float64,
                           requires_grad=True)
            (x @ fsdp.gather(w).to(torch.float64)).sum()
        assert s.gathered == 1
    finally:
        dist.destroy_process_group()


def test_a_unit_saves_its_gathered_weights_as_shards(tmp_path, monkeypatch):
    """S2 outside remat (``fsdp.run_unit``): a unit's products save a
    whole cast of its gathered weight, transposed and not; the hooks
    keep the shard (the dry run's count, the outer hooks, sees the
    unit's activations but no gathered weight), the backward gathers it
    once for both saved uses and drops it after the last, and the
    gradients are bitwise those of the same unit on the whole weight (a
    one-rank gloo group)."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import saved_bytes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import fsdp

    gen = torch.Generator().manual_seed(0)
    w0 = torch.randn((8, 4), generator=gen)
    x0 = torch.randn((3, 4), dtype=torch.float64, generator=gen)

    def unit(p, x):
        wt = p["w"].t().to(torch.float64)
        return torch.tanh(x @ wt) @ wt.t()

    def grads(run):
        w, x = w0.clone().requires_grad_(True), x0.clone().requires_grad_(True)
        run(w, x)
        return w.grad, x.grad

    def plain(w, x):
        unit({"w": w}, x).sum().backward()

    nodes = []
    unpack = fsdp._SavedAsShards.unpack

    def seen(self, packed):
        if packed[0] is fsdp._SHARD:
            nodes.append(packed[1])
        return unpack(self, packed)
    monkeypatch.setattr(fsdp._SavedAsShards, "unpack", seen)
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "s"), 1))
    try:
        lay = fsdp.Store(make_mesh((1,), ("data",), "cpu"),
                         ("data",)).layout(("data", None), (8, 4))
        counts = {}

        def sharded(w, x):
            with fsdp.gathering([(w, lay)]):
                with saved_bytes() as s:
                    y = fsdp.run_unit(unit, {"w": w}, x)
                counts.update(gathered=s.gathered, saved=s.total)
                y.sum().backward()
        got, want = grads(sharded), grads(plain)
    finally:
        dist.destroy_process_group()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert counts["gathered"] == 0 and counts["saved"] > 0
    assert len(nodes) == 2 and nodes[0] is nodes[1]
    assert nodes[0].packed == 0 and nodes[0].whole == {}
