"""Mamba-2 SSD chunked scan, forward: the CUDA kernel ``csrc/ssd.cu`` on the
card, its plain version (``ref.ssd_scan``) on the CPU.

Counterpart of the TPU kernel ``repro/kernels/ssd.py:ssd_scan_fwd``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref

_DTYPES = (torch.float32, torch.bfloat16)
# The TPU kernel's default chunk is 128. The CUDA kernel runs its products in
# f32 on the CUDA cores, where 64 does fewer operations (the quadratic
# intra-chunk part halves, the state update runs twice as often), and at N=128
# a chunk of 128 would need 260 KB of shared memory, above the 227 KB a block
# can have. The chunk changes only the rounding, not the function.
DEFAULT_CHUNK = 64


def ssd_scan_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                 C: torch.Tensor, D: Optional[torch.Tensor] = None, *,
                 chunk: int = DEFAULT_CHUNK):
    """SSD scan from a zero state. x ``(B, S, H, P)``, dt ``(B, S, H)``, A
    ``(H,)``, Bm/C ``(B, S, N)``, D ``(H,)`` or None.

    Returns ``(y (B, S, H, P) in x's dtype, final state (B, H, P, N) f32)``.
    x, Bm and C may be strided views whose last dim is contiguous (the kernel
    takes their strides); A and D go to the kernel as f32. The kernel's chunk
    is ``min(chunk, S)``. A CUDA tensor launches the kernel (counted in
    ``ssd_scan_fwd.launches``) or raises; a CPU tensor runs the plain
    version."""
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
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (dt, Bm, C)):
        raise TypeError(f"ssd kernel takes f32/bf16 x, dt, Bm, C of one dtype, got "
                        f"{x.dtype}, {dt.dtype}, {Bm.dtype}, {C.dtype}")
    if not (A.is_floating_point() and (D is None or D.is_floating_point())):
        raise TypeError("ssd: A and D must be floating")
    if any(t.stride(-1) != 1 for t in (x, Bm, C)):
        raise ValueError("ssd kernel needs x, Bm and C with a contiguous last dim")
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
    return y, state


ssd_scan_fwd.launches = 0
