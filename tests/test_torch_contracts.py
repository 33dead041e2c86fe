"""PyTorch port, the level-2 contracts (``repro_torch/analysis/
contracts.py``): each checker passes on the port's engines and fails on
a deliberate violation, as ``tests/test_analysis.py`` shows the
reference's.

- in place: ``EpochEngine.run_epochs``' params and optimizer buffers and
  ``SlotEngine``'s cache pool keep their storage; a copied tree fails;
- ``no_host_sync``: every host read raises inside it on the CPU, and the
  scan engine's captured step body (run eagerly on the CPU) reads
  nothing back;
- ``track_captures`` / ``assert_recapture_free`` through a stand-in for
  ``torch.cuda.CUDAGraph``;
- ``record_collectives`` on two gloo ranks: the pod step's reductions at
  bf16 in ``bf16`` mode and at fp32 in ``none``, over the pod axis's
  groups;
- ``expected_groups`` equal to the reference's on the same (2, 2)
  ``data x pod`` and (1, 4) meshes (built as ``tests/test_torch_dist_pod
  .py`` builds them, in a subprocess with 4 host devices);
- ``graph_nodes`` and ``assert_graph_device_only`` on the card (marker
  ``cuda``), the node-type table against a ``cuda.h`` enum.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

from repro_torch.analysis import contracts  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import PGMConfig, TrainConfig  # noqa: E402
from repro_torch.data.pipeline import lm_units  # noqa: E402
from repro_torch.data.synthetic import make_lm_corpus  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from torch_dist_helpers import spawn  # noqa: E402
from torch_contract_ranks import pod_step_collectives  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCH = "starcoder2-3b-smoke"
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def lm_engine():
    from repro_torch.train.engine import EpochEngine
    from repro_torch.train.optim import make_update_for
    cfg = get_config(ARCH)
    bundle = build_model(cfg)
    units = lm_units(make_lm_corpus(0, 16, 12, cfg.vocab_size), 2)
    tc = TrainConfig(lr=0.5, optimizer="sgd", momentum=0.9, epochs=2,
                     pgm=PGMConfig())
    eng = EpochEngine(bundle, tc, units, device=CPU)
    params = bundle.init_params(torch.Generator().manual_seed(0), CPU)
    eng.adopt(params, make_update_for(tc)[0](params))
    return eng, tc


def test_run_epochs_updates_the_engine_state_in_place(lm_engine):
    eng, tc = lm_engine
    state = (eng.params, eng.opt_state)
    before = contracts.pointers(state)
    plans = [eng.full_plan(e) for e in (0, 1)]
    eng.run_epochs(eng.params, eng.opt_state, tc.lr, float("inf"), plans)
    assert len(before) > 10
    contracts.assert_in_place(before, (eng.params, eng.opt_state),
                              "run_epochs")
    copied = tree_map(lambda x: x.clone(), state)
    with pytest.raises(AssertionError, match="replaced"):
        contracts.assert_in_place(before, copied, "a copied state")


def test_the_captured_step_body_reads_nothing_back(lm_engine):
    """``EpochEngine._run_rows`` runs ``_body`` once a row on the CPU,
    the function the card captures after its warm-up steps: after one
    warm-up row, rows under ``no_host_sync`` pass."""
    eng, tc = lm_engine
    idx, w = (torch.as_tensor(a[:4]) for a in eng.full_plan(2))
    eng._set_lr(tc.lr)
    eng._run_rows(idx[:1], w[:1])                 # the warm-up
    with contracts.no_host_sync("the step body"):
        n = eng._run_rows(idx[1:], w[1:])
    assert n == 3
    assert bool((eng._losses[:3] > 0).all())


@pytest.mark.parametrize("read", ["item", "tolist", "cpu", "numpy", "bool",
                                  "int", "float", "asarray", "index"])
def test_no_host_sync_raises_on_a_host_read(read):
    x = torch.arange(4.0)
    fn = {"item": lambda: x.sum().item(), "tolist": x.tolist,
          "cpu": x.cpu, "numpy": x.numpy, "bool": lambda: bool(x[1]),
          "int": lambda: int(x[1]), "float": lambda: float(x[1]),
          "asarray": lambda: np.asarray(x),
          "index": lambda: [0, 1, 2][x[1].long()]}[read]
    with pytest.raises(contracts.HostSyncError):
        with contracts.no_host_sync("test"):
            fn()
    fn()                                  # the guard is gone after it
    with contracts.no_host_sync("shape reads"):
        assert x.shape[0] == 4 and (x * 2).sum().shape == ()


def test_slot_engine_decodes_into_its_pool_in_place():
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve.engine import SlotEngine
    cfg = get_config(ARCH)
    bundle = build_model(cfg)
    params = bundle.init_params(torch.Generator().manual_seed(0), CPU)
    eng = SlotEngine(bundle, params, n_slots=2, max_new_tokens=8,
                     max_prompt_len=16)
    before = contracts.pointers(eng._state["cache"])
    eng._admit(0, make_requests(cfg, 1, 8, 8, seed=9)[0])
    eng._decode_scan()
    assert int(eng._state["n_out"][0]) > 1
    contracts.assert_in_place(before, eng._state["cache"], "the slot pool")
    eng._state["cache"] = tree_map(lambda x: x.clone(), eng._state["cache"])
    with pytest.raises(AssertionError):
        contracts.assert_in_place(before, eng._state["cache"], "a copy")


class _StandInGraph:
    """What ``torch.cuda.graph`` calls on its graph, without a card."""

    def __init__(self):
        self.begun = 0

    def capture_begin(self, *a, **kw):
        self.begun += 1


def test_track_captures_counts_each_capture_with_its_site():
    g = _StandInGraph()
    with contracts.track_captures(_StandInGraph) as log:
        g.capture_begin()
        _StandInGraph().capture_begin(pool=None)
    assert log.count == 2 and g.begun == 1
    assert all("test_torch_contracts.py" in s for s in log.sites)
    g.capture_begin()                      # outside the block: unseen
    assert log.count == 2
    assert _StandInGraph.capture_begin.__name__ == "capture_begin"
    assert "capture_begin" in vars(_StandInGraph)


def test_assert_recapture_free_passes_and_raises():
    with contracts.assert_recapture_free("no capture", graph_cls=_StandInGraph):
        pass
    with contracts.assert_recapture_free("one allowed", allowed=1,
                                         graph_cls=_StandInGraph):
        _StandInGraph().capture_begin()
    with pytest.raises(AssertionError, match="recaptured: 2"):
        with contracts.assert_recapture_free("a new bucket", allowed=1,
                                             graph_cls=_StandInGraph):
            _StandInGraph().capture_begin()
            _StandInGraph().capture_begin()


def test_track_captures_patches_the_class_torch_cuda_graph_uses():
    cls = torch.cuda.graphs.CUDAGraph
    orig = vars(cls)["capture_begin"]
    with contracts.track_captures() as log:
        assert vars(cls)["capture_begin"] is not orig
    assert vars(cls)["capture_begin"] is orig and log.count == 0


def test_record_collectives_on_two_gloo_ranks(tmp_path):
    """The pod step's compressed all-reduce at bf16 in ``bf16`` mode, one
    a step, beside its fp32 weight and metric sums; every reduction fp32
    in ``none``; all over the pod axis's group."""
    (logs, groups), (logs1, _) = spawn(pod_step_collectives, 2, tmp_path)
    mesh = {"data": 1, "pod": 2}
    assert groups == contracts.expected_groups(mesh, "pod") == [[0, 1]]
    for log in (logs["bf16"], logs1["bf16"]):
        contracts.assert_collective_width(log, dtype=torch.bfloat16,
                                          n_expected=1)
        with pytest.raises(AssertionError, match="reductions at"):
            contracts.assert_collective_width(log, dtype="float32")
    contracts.assert_collective_width(logs["none"], dtype=torch.float32)
    with pytest.raises(AssertionError, match="0 reductions at"):
        contracts.assert_collective_width(logs["none"], dtype="bf16",
                                          n_expected=1)
    assert logs["none"].count == logs["bf16"].count >= 3
    assert logs["none"].captured == 0
    contracts.assert_replica_groups(logs["none"], mesh, "pod",
                                    min_count=logs["none"].count)
    with pytest.raises(AssertionError, match="grouped over mesh axis"):
        contracts.assert_replica_groups(logs["none"], mesh, "data")
    grads = [c for c in logs["bf16"].calls if c.dtype == torch.bfloat16]
    assert contracts.wire_bytes(grads[0]) == grads[0].nbytes   # 2 (g-1)/g


_REF_GROUPS = """
import json
import jax
from jax.sharding import AxisType
from repro.analysis.contracts import expected_groups
assert jax.device_count() == 4
out = {}
for shape, axes in (((2, 2), ("data", "pod")), ((1, 4), ("data", "pod"))):
    mesh = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * 2)
    out["x".join(map(str, shape))] = {a: expected_groups(mesh, a)
                                      for a in axes}
print(json.dumps(out))
"""


def test_expected_groups_equal_the_reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF_GROUPS)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    ref = json.loads(run.stdout.strip().splitlines()[-1])
    for key, (d, p) in (("2x2", (2, 2)), ("1x4", (1, 4))):
        mesh = {"data": d, "pod": p}
        for axis in ("data", "pod"):
            assert contracts.expected_groups(mesh, axis) == ref[key][axis]


def test_node_types_match_the_driver_header_enum():
    header = textwrap.dedent("""
        typedef enum CUgraphNodeType_enum {
            CU_GRAPH_NODE_TYPE_KERNEL           = 0,
            CU_GRAPH_NODE_TYPE_MEMCPY           = 1,
            CU_GRAPH_NODE_TYPE_MEMSET           = 2,
            CU_GRAPH_NODE_TYPE_HOST             = 3,
            CU_GRAPH_NODE_TYPE_GRAPH            = 4,
            CU_GRAPH_NODE_TYPE_EMPTY            = 5,
            CU_GRAPH_NODE_TYPE_WAIT_EVENT       = 6,
            CU_GRAPH_NODE_TYPE_EVENT_RECORD     = 7,
        } CUgraphNodeType;""")
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"cuda_h_{os.getpid()}.h")
    with open(path, "w") as f:
        f.write(header)
    try:
        got = contracts.header_node_types(path)
    finally:
        os.remove(path)
    assert got == {k: v for k, v in contracts.NODE_TYPES.items() if k in got}
    assert got["GRAPH"] == 4 and got["WAIT_EVENT"] == 6 and len(got) == 8


@pytest.mark.cuda
def test_graph_device_only_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    dev = torch.device("cuda")
    x = torch.randn(1024, device=dev)
    y = torch.empty_like(x)
    host = torch.empty(1024, pin_memory=True)
    x * 2                                          # warm up the kernel
    torch.cuda.synchronize()
    g_dev = torch.cuda.CUDAGraph(keep_graph=True)
    with contracts.track_captures() as log:
        with torch.cuda.graph(g_dev):
            y.copy_(x * 2)
    assert log.count == 1
    kinds = [k for k, _ in contracts.graph_nodes(g_dev)]
    assert "KERNEL" in kinds
    contracts.assert_graph_device_only(g_dev, "a device copy")
    g_host = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g_host):
        host.copy_(x, non_blocking=True)
    assert ("MEMCPY", ("device", "host")) in contracts.graph_nodes(g_host)
    with pytest.raises(AssertionError, match="host"):
        contracts.assert_graph_device_only(g_host, "a copy to the host")
