"""Mamba-2 SSD chunked scan, forward: the CUDA kernels ``csrc/ssd.cu`` on the
card, their plain version (``ref.ssd_scan``) on the CPU.

Counterpart of the TPU kernel ``repro/kernels/ssd.py:ssd_scan_fwd``. On the
card, bf16 runs on the tensor cores and f32 (the parity type) on the CUDA
cores; ``_plan`` picks the kernel by dtype.
"""
from __future__ import annotations

import collections
from typing import Optional

import torch

from repro_torch.kernels import ref

_DTYPES = (torch.float32, torch.bfloat16)
# The TPU kernel's default chunk is 128. Both kernels here take 64: the
# quadratic part inside a chunk (C B^T and S x) grows with the chunk while the
# state update's share per step does not, so 64 does fewer operations, and the
# bf16 kernel's two chunk stages at 128 take 179 KB of shared memory at N=128,
# one block an SM instead of two: it took twice as long on an H100 (PERF.md).
# The f32 kernel's chunk of 128 would need 260 KB at N=128, above the 227 KB a
# block can have. The chunk changes only the rounding, not the function.
DEFAULT_CHUNK = 64
TC_MAX_CHUNK = 128  # longest chunk of the bf16 kernel (csrc/launch.h)
TC_MAX_N = 128
_ALIGN_BYTES = 16  # the bf16 kernel copies rows in 16-byte chunks


def _plan(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor, C: torch.Tensor,
          chunk: int) -> str:
    """Which kernel takes these operands, "tensor_cores" (bf16) or "cuda_cores"
    (f32), or raise: dtype (f32 or bf16, one for x, dt, Bm and C), a
    contiguous last dim of x, Bm and C, and for bf16 the shapes the kernel
    takes (P % 16 == 0, N % 8 == 0 and N <= 128, a chunk of at most 128
    steps) and x, Bm and C with base pointers and the strides of dims longer
    than 1 on 16-byte boundaries."""
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (dt, Bm, C)):
        raise TypeError(f"ssd kernel takes f32/bf16 x, dt, Bm, C of one dtype, got "
                        f"{x.dtype}, {dt.dtype}, {Bm.dtype}, {C.dtype}")
    if any(t.stride(-1) != 1 for t in (x, Bm, C)):
        raise ValueError("ssd kernel needs x, Bm and C with a contiguous last dim")
    if x.dtype == torch.float32:
        return "cuda_cores"
    S, P, N = x.shape[1], x.shape[3], Bm.shape[-1]
    L = min(chunk, S)
    if L > TC_MAX_CHUNK:
        raise ValueError(f"bf16 ssd kernel takes a chunk of at most {TC_MAX_CHUNK} steps, "
                         f"got {L}")
    if P % 16 or N % 8 or N > TC_MAX_N:
        raise ValueError(f"bf16 ssd kernel takes P % 16 == 0 and N % 8 == 0 with N <= "
                         f"{TC_MAX_N}, got P={P}, N={N}")
    elems = _ALIGN_BYTES // x.element_size()
    for name, t in (("x", x), ("Bm", Bm), ("C", C)):
        if t.data_ptr() % _ALIGN_BYTES:
            raise ValueError(f"bf16 ssd kernel needs a 16-byte aligned {name}")
        if any(n > 1 and s % elems for n, s in zip(t.shape[:-1], t.stride()[:-1])):
            raise ValueError(f"bf16 ssd kernel needs {name}'s strides in multiples of "
                             f"{elems} elements, got {t.stride()}")
    return "tensor_cores"


def ssd_scan_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                 C: torch.Tensor, D: Optional[torch.Tensor] = None, *,
                 chunk: int = DEFAULT_CHUNK):
    """SSD scan from a zero state. x ``(B, S, H, P)``, dt ``(B, S, H)``, A
    ``(H,)``, Bm/C ``(B, S, N)``, D ``(H,)`` or None.

    Returns ``(y (B, S, H, P) in x's dtype, final state (B, H, P, N) f32)``.
    x, Bm and C may be strided views whose last dim is contiguous (the kernel
    takes their strides); A and D go to the kernel as f32. The kernel's chunk
    is ``min(chunk, S)``. A CUDA tensor launches the kernel that ``_plan``
    picks (counted in ``ssd_scan_fwd.launches``, and by path in
    ``ssd_scan_fwd.paths``) or raises; a CPU tensor runs the plain version."""
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 3 or C.shape != Bm.shape:
        raise ValueError(f"ssd: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"Bm {tuple(Bm.shape)}, C {tuple(C.shape)}")
    B, S, H, P = x.shape
    if (tuple(dt.shape) != (B, S, H) or tuple(Bm.shape[:2]) != (B, S)
            or tuple(A.shape) != (H,) or (D is not None and tuple(D.shape) != (H,))):
        raise ValueError(f"ssd: x {tuple(x.shape)} vs dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, Bm {tuple(Bm.shape)}, "
                         f"D {None if D is None else tuple(D.shape)}")
    if chunk < 1:
        raise ValueError(f"ssd: chunk must be >= 1, got {chunk}")
    operands = (x, dt, A, Bm, C) + (() if D is None else (D,))
    devices = {t.device for t in operands}
    if devices == {torch.device("cpu")}:
        return ref.ssd_scan(x, dt, A, Bm, C, D, return_state=True)
    if len(devices) != 1 or x.device.type != "cuda":
        raise ValueError(f"ssd: operands on {sorted(map(str, devices))}")
    if not (A.is_floating_point() and (D is None or D.is_floating_point())):
        raise TypeError("ssd: A and D must be floating")
    path = _plan(x, dt, Bm, C, chunk)
    if x.numel() == 0 or Bm.shape[-1] == 0:
        raise ValueError(f"ssd: empty operands x {tuple(x.shape)}, Bm {tuple(Bm.shape)}")
    A32 = A.float().contiguous()
    D32 = (torch.zeros(H, dtype=torch.float32, device=x.device) if D is None
           else D.float().contiguous())
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((B, H, P, Bm.shape[-1]), dtype=torch.float32, device=x.device)
    from repro_torch.kernels._build import load_kernels

    load_kernels().ssd_scan_fwd(x, dt, A32, Bm, C, D32, y, state, min(int(chunk), S))
    ssd_scan_fwd.launches += 1
    ssd_scan_fwd.paths[path] += 1
    return y, state


ssd_scan_fwd.launches = 0
ssd_scan_fwd.paths = collections.Counter()
