"""RMSNorm forward: the CUDA kernels ``csrc/rmsnorm.cu`` on the card, their
plain version (``ref.rmsnorm``) on the CPU.

Counterpart of the TPU kernel ``repro/kernels/rmsnorm.py:rmsnorm_fwd``. On the
card, rows of whole 16-byte vectors on the 16-byte grid take the vector
kernel, which also reads strided views (the q and k heads of the fused qkv
product, in place); any other contiguous x takes the scalar kernel.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels import ref

_DTYPES = (torch.float32, torch.bfloat16)
_ALIGN_BYTES = 16  # the vector kernel reads rows in 16-byte vectors
MAX_VECTORS = 4096  # most vectors a row of the vector kernel (csrc/launch.h)


def row_layout(x: torch.Tensor) -> tuple[int, int, int, int]:
    """Where the rows of ``x`` (over its leading dims) lie: ``(n_outer,
    n_inner, s_outer, s_inner)``, row r starting ``(r // n_inner) * s_outer +
    (r % n_inner) * s_inner`` elements after x's first. Leading dims of size 1
    are dropped, and a dim merges into the one before it where that one steps
    over it whole. Raises ValueError when the last dim is not contiguous or
    more than two levels remain: the kernel takes no other view, and nothing
    here copies."""
    if x.dim() == 0:
        raise ValueError("rmsnorm: x needs at least one dim")
    if x.shape[-1] > 1 and x.stride(-1) != 1:
        raise ValueError(f"rmsnorm kernel needs a contiguous last dim, got strides {x.stride()}")
    levels: list[list[int]] = []
    for n, s in zip(x.shape[:-1], x.stride()[:-1]):
        if n == 1:
            continue
        if levels and levels[-1][1] == n * s:
            levels[-1] = [levels[-1][0] * n, s]
        else:
            levels.append([n, s])
    if len(levels) > 2:
        raise ValueError(f"rmsnorm kernel takes rows in at most two levels of strides; "
                         f"shape {tuple(x.shape)}, strides {x.stride()} give {len(levels)}")
    (n0, s0), (n1, s1) = [[1, 0]] * (2 - len(levels)) + levels
    return n0, n1, s0, s1


def _plan(x: torch.Tensor, weight: torch.Tensor) -> tuple[str, tuple[int, int, int, int]]:
    """Which kernel takes x, "vector" or "scalar", and x's ``row_layout``, or
    raise. The vector kernel takes rows of whole 16-byte vectors (at most
    ``MAX_VECTORS``) with x and the weight 16-byte aligned and both row
    strides multiples of the vector; the scalar kernel takes any other x whose
    rows lie one after the other. A strided view off that grid is refused."""
    layout = row_layout(x)
    n0, n1, s0, s1 = layout
    D = x.shape[-1]
    elems = _ALIGN_BYTES // x.element_size()
    if (D % elems == 0 and D // elems <= MAX_VECTORS and s0 % elems == 0 and s1 % elems == 0
            and x.data_ptr() % _ALIGN_BYTES == 0 and weight.data_ptr() % _ALIGN_BYTES == 0):
        return "vector", layout
    if n0 == 1 and (n1 == 1 or s1 == D):
        return "scalar", layout
    raise ValueError(f"rmsnorm kernel reads a strided view only in whole 16-byte vectors on "
                     f"the 16-byte grid; got shape {tuple(x.shape)}, strides {x.stride()}, "
                     f"{x.data_ptr() % _ALIGN_BYTES} bytes past the grid")


def rmsnorm_fwd(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim of ``x`` (any leading shape, any view that
    ``row_layout`` takes), weight ``(D,)``. Returns a contiguous tensor.

    A CUDA tensor launches a kernel (counted in ``rmsnorm_fwd.launches``, by
    (rows, D) in ``rmsnorm_fwd.shapes`` and by kernel in
    ``rmsnorm_fwd.paths``) or raises; a CPU tensor runs the plain version."""
    if weight.dim() != 1 or x.dim() == 0 or x.shape[-1] != weight.shape[0]:
        raise ValueError(f"rmsnorm: x {tuple(x.shape)} vs weight {tuple(weight.shape)}")
    if x.device.type == "cpu" and weight.device.type == "cpu":
        return ref.rmsnorm(x, weight, eps=eps)
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, weight on {weight.device}")
    if x.dtype not in _DTYPES or weight.dtype != x.dtype:
        raise TypeError(f"rmsnorm kernel takes f32/bf16 x and weight of x's dtype, "
                        f"got {x.dtype} and {weight.dtype}")
    if not weight.is_contiguous():
        raise ValueError("rmsnorm kernel needs a contiguous weight")
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)  # not empty_like: x's strides
    if x.numel() == 0:
        return y
    path, (_, n_inner, s_outer, s_inner) = _plan(x, weight)
    from repro_torch.kernels._build import load_kernels

    load_kernels().rmsnorm_fwd(x, weight, y, float(eps), n_inner, s_outer, s_inner)
    rmsnorm_fwd.launches += 1
    rmsnorm_fwd.shapes[(x.numel() // x.shape[-1], x.shape[-1])] += 1
    rmsnorm_fwd.paths[path] += 1
    return y


rmsnorm_fwd.launches = 0
rmsnorm_fwd.shapes = collections.Counter()
rmsnorm_fwd.paths = collections.Counter()
