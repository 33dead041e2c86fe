"""Config registry of the port: ``get_config(name)``, and the dry run's
shapes and cells (``get_shape``, ``cells``), the reference's."""
from __future__ import annotations

from repro_torch.configs.base import (  # noqa: F401 (public re-exports)
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    TRAIN_4K,
    ModelConfig,
    MoEConfig,
    PGMConfig,
    RNNTConfig,
    ShapeConfig,
    TrainConfig,
    reduce_for_smoke,
)
from repro_torch.configs.gemma3_27b import CONFIG as GEMMA3_27B
from repro_torch.configs.gemma_7b import CONFIG as GEMMA_7B
from repro_torch.configs.minitron_8b import CONFIG as MINITRON_8B
from repro_torch.configs.mixtral_8x7b import CONFIG as MIXTRAL_8X7B
from repro_torch.configs.olmoe_1b_7b import CONFIG as OLMOE_1B_7B
from repro_torch.configs.paligemma_3b import CONFIG as PALIGEMMA_3B
from repro_torch.configs.recurrentgemma_9b import CONFIG as RECURRENTGEMMA_9B
from repro_torch.configs.rnnt_crdnn import CONFIG as RNNT_CRDNN
from repro_torch.configs.rwkv6_3b import CONFIG as RWKV6_3B
from repro_torch.configs.seamless_m4t_medium import \
    CONFIG as SEAMLESS_M4T_MEDIUM
from repro_torch.configs.starcoder2_3b import CONFIG as STARCODER2_3B

_ARCHS = {"rnnt-crdnn": RNNT_CRDNN, "starcoder2-3b": STARCODER2_3B,
          "rwkv6-3b": RWKV6_3B, "gemma-7b": GEMMA_7B,
          "gemma3-27b": GEMMA3_27B, "minitron-8b": MINITRON_8B,
          "mixtral-8x7b": MIXTRAL_8X7B, "olmoe-1b-7b": OLMOE_1B_7B,
          "recurrentgemma-9b": RECURRENTGEMMA_9B,
          "seamless-m4t-medium": SEAMLESS_M4T_MEDIUM,
          "paligemma-3b": PALIGEMMA_3B}


def get_config(name: str) -> ModelConfig:
    """A ported arch (``rnnt-crdnn``, ``starcoder2-3b``, ``rwkv6-3b``,
    ``gemma-7b``, ``gemma3-27b``, ``minitron-8b``, ``mixtral-8x7b``,
    ``olmoe-1b-7b``, ``recurrentgemma-9b``, ``seamless-m4t-medium``,
    ``paligemma-3b``) or its ``-smoke`` reduction."""
    smoke = name.endswith("-smoke")
    base = name[: -len("-smoke")] if smoke else name
    if base not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port knows "
                       f"{sorted(_ARCHS)} (and their -smoke variants)")
    cfg = _ARCHS[base]
    return reduce_for_smoke(cfg) if smoke else cfg


#: the reference's assigned archs (every arch but the paper's RNN-T), in
#: the reference's order
ASSIGNED_ARCHS = ["mixtral-8x7b", "olmoe-1b-7b", "minitron-8b",
                  "starcoder2-3b", "gemma3-27b", "gemma-7b",
                  "seamless-m4t-medium", "rwkv6-3b", "recurrentgemma-9b",
                  "paligemma-3b"]


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cells(include_skips: bool = False):
    """Every (arch, shape) dry-run cell, the reference's: ``long_500k``
    is skipped for pure full-attention archs (listed with ``"skip"`` when
    ``include_skips``)."""
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not cfg.is_subquadratic():
                if include_skips:
                    yield arch, shape.name, "skip"
                continue
            yield (arch, shape.name, "run") if include_skips \
                else (arch, shape.name)
