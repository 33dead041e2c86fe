"""Rank function of ``tests/test_torch_contracts.py``, run by
``torch_dist_helpers.spawn`` in every rank of a gloo group.  It imports
no JAX."""
import torch


def pod_step_collectives(rank, world):
    """One ``starcoder2-3b-smoke`` step through ``MeshContext`` on a
    ``(1, world)`` data x pod mesh in the ``none`` and ``bf16`` compress
    modes, under ``record_collectives`` -> ({mode: the log}, the pod
    axis's expected groups read off the ``DeviceMesh``)."""
    from repro_torch.analysis import contracts
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.train.engine import MeshContext, make_step_core
    from repro_torch.train.optim import make_update_for

    mesh = make_mesh((1, world), ("data", "pod"), "cpu")
    bundle = build_model(get_config("starcoder2-3b-smoke"))
    cpu = torch.device("cpu")
    params = bundle.init_params(torch.Generator().manual_seed(0), cpu)
    B, S = 2 * world, 12
    batch = bundle.make_batch(torch.Generator().manual_seed(1), B, S)
    logs = {}
    for mode in ("none", "bf16"):
        tc = TrainConfig(lr=0.1, optimizer="sgd", compress_mode=mode)
        ctx = MeshContext(mesh, tc, bundle, "tp", B, 1, S)
        step = make_step_core(bundle, tc, ctx=ctx)
        with contracts.record_collectives() as log:
            step(params, make_update_for(tc)[0](params), batch, 0.1)
        logs[mode] = log
    return logs, contracts.expected_groups(mesh, "pod")
