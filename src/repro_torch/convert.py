"""Weights across the two packages.

The reference's params are a nested dict of arrays (``rnnt.init_params``
output, turned into numpy by the caller); the port's are a nested dict of
tensors with the same keys and the same (in, out) layouts, so the
conversion is a leafwise copy through numpy and nothing is transposed.
The round trip is bit-exact.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def from_numpy(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """Nested dict of numpy arrays -> nested dict of tensors on
    ``device`` (dtypes kept)."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Nested dict of tensors -> nested dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
