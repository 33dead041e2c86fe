"""PyTorch port, partition specs (``repro_torch/sharding/specs.py``)
against the JAX reference's ``sharding/specs.py:SpecBuilder``, leaf for
leaf, on the CPU.

The reference's builder runs on ``jax.sharding.AbstractMesh`` (no
devices), the port's on the same ``{axis: size}`` mapping, at (8,)
data, (4, 2) data x model, (2, 2) data x pod, (2, 2, 2) pod x data x
model (both with ``pod_axis="pod"``) and (2, 4) data x expert, in all
four modes.  Inputs:

- params: the shapes of the ten assigned archs and ``rnnt-crdnn`` at
  full size (``jax.eval_shape``; on the port's side as tensors on
  ``torch.device("meta")``) and at their ``-smoke`` sizes, where the
  port's own ``init_params`` tree is first held to the reference's
  (same key paths and shapes);
- batches of 8, 6 and 1 examples; the reference's decode caches of the
  smoke archs (``init_cache``) at batch 8 and 1.

Where the reference raises (a spec naming ``model`` on a mesh without
it), the port raises the same type.  The expert-indivisible
``ValueError`` names the arch in both.
"""
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.sharding.specs import SpecBuilder as JaxSpecBuilder  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.sharding.specs import SpecBuilder  # noqa: E402
from repro_torch.train.checkpoint import _flatten  # noqa: E402

ARCHS = tuple(ASSIGNED_ARCHS) + ("rnnt-crdnn",)
MESHES = (((8,), ("data",)), ((4, 2), ("data", "model")),
          ((2, 2), ("data", "pod")), ((2, 2, 2), ("pod", "data", "model")),
          ((2, 4), ("data", "expert")))
MODES = ("tp", "expert", "fsdp_sp", "fsdp_batch")


def _builders(shape, names, mode, arch):
    pod = "pod" if "pod" in names else None
    ref = JaxSpecBuilder(AbstractMesh(shape, names), mode=mode,
                         pod_axis=pod, arch=arch)
    port = SpecBuilder(dict(zip(names, shape)), mode=mode, pod_axis=pod,
                       arch=arch)
    return ref, port


def _outcome(fn):
    """``("ok", spec tuple)`` or ``("raise", exception type)``."""
    try:
        return "ok", tuple(fn())
    except (KeyError, ValueError) as e:
        return "raise", type(e)


def _ref_shapes(arch):
    return jax.eval_shape(jax_build(jax_get_config(arch)).init_params,
                          jax.random.PRNGKey(0))


def _meta(shapes):
    return jax.tree.map(lambda s: torch.empty(s.shape, device="meta"),
                        shapes)


def _compare_params(arch, ref_tree, port_tree):
    ref_flat = [(jax.tree_util.keystr(p), tuple(l.shape)) for p, l in
                jax.tree_util.tree_flatten_with_path(ref_tree)[0]]
    port_flat = [(k, tuple(l.shape)) for k, l in _flatten(port_tree)]
    assert port_flat == ref_flat
    n = 0
    for shape, names in MESHES:
        for mode in MODES:
            ref, port = _builders(shape, names, mode, arch)
            for key, s in ref_flat:
                want = _outcome(lambda: ref.param_spec(key, s))
                got = _outcome(lambda: port.param_spec(key, s))
                assert got == want, (arch, names, mode, key, s)
                n += want[0] == "ok"
    return n


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch):
    """Every leaf of the full-size tree (as meta tensors) and of the
    smoke tree (the port's own init) on every mesh and in every mode."""
    full = _ref_shapes(arch)
    assert _compare_params(arch, full, _meta(full)) > 0
    smoke = arch + "-smoke"
    port_tree = build_model(get_config(smoke)).init_params(
        torch.Generator().manual_seed(0), torch.device("cpu"))
    assert _compare_params(smoke, _ref_shapes(smoke), port_tree) > 0


def test_param_specs_tree_keeps_structure():
    """``param_specs`` returns the specs in the params' tree layout, each
    leaf the reference's ``param_specs`` leaf."""
    port_tree = build_model(get_config("starcoder2-3b-smoke")).init_params(
        torch.Generator().manual_seed(0), torch.device("cpu"))
    specs = SpecBuilder({"data": 4, "model": 2}).param_specs(port_tree)
    want = JaxSpecBuilder(AbstractMesh((4, 2), ("data", "model"))
                          ).param_specs(_ref_shapes("starcoder2-3b-smoke"))
    flat_want = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    assert set(specs) == set(want)
    for path, spec in flat_want:
        node = specs
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        assert node == tuple(spec), jax.tree_util.keystr(path)


@pytest.mark.parametrize("shape,names", MESHES)
def test_batch_and_cache_specs_match_reference(shape, names):
    batches = [(f"['{k}']", s) for B in (8, 6, 1)
               for k, s in (("tokens", (B, 12)), ("loss_mask", (B, 12)),
                            ("weights", (B,)), ("feats", (B, 64, 8)))]
    caches = []
    for arch in ARCHS:
        m = jax_build(jax_get_config(arch + "-smoke"))
        if not hasattr(m, "init_cache"):
            continue
        for B in (8, 1):
            try:
                tree = jax.eval_shape(lambda: m.init_cache(B, 16))
            except Exception:       # a family without a KV cache
                continue
            caches += [(jax.tree_util.keystr(p), tuple(l.shape), B)
                       for p, l in
                       jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert caches
    for mode in MODES:
        ref, port = _builders(shape, names, mode, None)
        for key, s in batches:
            assert _outcome(lambda: port.batch_spec(key, s)) == \
                _outcome(lambda: ref.batch_spec(key, s)), (mode, key, s)
        for key, s, B in caches:
            assert _outcome(lambda: port.cache_spec(key, s, B)) == \
                _outcome(lambda: ref.cache_spec(key, s, B)), (mode, key, s)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "olmoe-1b-7b"])
def test_expert_indivisible_raises_naming_the_arch(arch):
    """In ``expert`` mode an expert dim that does not divide over the
    expert axis is a ``ValueError`` naming the arch, with the
    reference's message; routers replicate."""
    full = _ref_shapes(arch)
    key, s = next((jax.tree_util.keystr(p), tuple(l.shape)) for p, l in
                  jax.tree_util.tree_flatten_with_path(full)[0]
                  if "'w_in'" in jax.tree_util.keystr(p)
                  and "'moe'" in jax.tree_util.keystr(p))
    ref, port = _builders((2, 3), ("data", "expert"), "expert", arch)
    with pytest.raises(ValueError) as want:
        ref.param_spec(key, s)
    with pytest.raises(ValueError, match=arch) as got:
        port.param_spec(key, s)
    assert str(got.value) == str(want.value)
    router = next((jax.tree_util.keystr(p), tuple(l.shape)) for p, l in
                  jax.tree_util.tree_flatten_with_path(full)[0]
                  if "'router'" in jax.tree_util.keystr(p))
    ref, port = _builders((2, 4), ("data", "expert"), "expert", arch)
    assert port.param_spec(*router) == tuple(ref.param_spec(*router)) == \
        (None,) * len(router[1])
