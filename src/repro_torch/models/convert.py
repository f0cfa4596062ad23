"""Carry params from the JAX package's layout into the port's: a leaf copy,
since both keep the same nested dict with stacked leading L axes."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device


def _leaf(a, device: torch.device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy does not take: widening
        # to f32 and narrowing back is exact
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        # a copy: jax hands out read-only buffers, which a CPU tensor would alias
        t = torch.from_numpy(np.array(a))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: dict, *, device, dtype: Optional[torch.dtype] = None) -> dict:
    """Nested dict of numpy arrays (e.g. ``jax.device_get`` of the JAX
    package's params) -> the same dict of tensors on ``device``; floating
    leaves cast to ``dtype`` when given."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device, dtype=dtype) for k, v in tree.items()}
    return _leaf(tree, device, dtype)
