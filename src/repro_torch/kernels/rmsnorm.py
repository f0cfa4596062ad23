"""RMSNorm forward: the CUDA kernel ``csrc/rmsnorm.cu`` on the card, its plain
version (``ref.rmsnorm``) on the CPU.

Counterpart of the TPU kernel ``repro/kernels/rmsnorm.py:rmsnorm_fwd``.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels import ref

_DTYPES = (torch.float32, torch.bfloat16)


def rmsnorm_fwd(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim of ``x`` (any leading shape), weight ``(D,)``.

    A CUDA tensor launches the kernel (counted in ``rmsnorm_fwd.launches``,
    and by (rows, D) in ``rmsnorm_fwd.shapes``) or raises; a CPU tensor runs
    the plain version."""
    if weight.dim() != 1 or x.dim() == 0 or x.shape[-1] != weight.shape[0]:
        raise ValueError(f"rmsnorm: x {tuple(x.shape)} vs weight {tuple(weight.shape)}")
    if x.device.type == "cpu" and weight.device.type == "cpu":
        return ref.rmsnorm(x, weight, eps=eps)
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, weight on {weight.device}")
    if x.dtype not in _DTYPES or weight.dtype != x.dtype:
        raise TypeError(f"rmsnorm kernel takes f32/bf16 x and weight of x's dtype, "
                        f"got {x.dtype} and {weight.dtype}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rmsnorm kernel needs contiguous x and weight")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    from repro_torch.kernels._build import load_kernels

    load_kernels().rmsnorm_fwd(x, weight, y, float(eps))
    rmsnorm_fwd.launches += 1
    rmsnorm_fwd.shapes[(x.numel() // x.shape[-1], x.shape[-1])] += 1
    return y


rmsnorm_fwd.launches = 0
rmsnorm_fwd.shapes = collections.Counter()
