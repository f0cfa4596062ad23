"""Flash-attention forward: the CUDA kernels ``csrc/flash_attention.cu`` on the
card, their plain version (``ref.flash_attention_fwd_ref``) on the CPU.

Counterpart of the TPU kernel
``repro/kernels/flash_attention.py:flash_attention_fwd``. On the card, bf16
runs on the tensor cores and f32 (the parity type) on the CUDA cores, both for
every head size in ``HEAD_DIMS``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ref

HEAD_DIMS = (16, 24, 32, 64, 80, 128, 160)
BQ = 64  # query rows of one block, in either kernel
_ALIGN_BYTES = 16  # the bf16 kernel copies rows in 16-byte chunks


def scored_pairs(S: int, T: int, q_offset: int) -> int:
    """The (query, key) pairs the causal kernel scores for one head: each
    tile of ``BQ`` query rows against the keys before its ``kv_end``, the
    last row's position + 1 (``key_tiles`` in flash_attention.cu); the
    columns of the last key tile past ``kv_end`` are masked, not counted."""
    return sum(min(BQ, S - q0) * min(T, q_offset + min(q0 + BQ, S)) for q0 in range(0, S, BQ))


def _plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Which kernel takes these operands, "tensor_cores" (bf16) or "cuda_cores"
    (f32), or raise: dtype (f32 or bf16, one for all three), head size, a
    contiguous last dim, and for bf16 base pointers and the strides of dims
    longer than 1 on 16-byte boundaries."""
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash attention kernel takes f32/bf16 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    D = q.shape[-1]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head_dim in {HEAD_DIMS}, got {D}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash attention kernel needs a contiguous last dim")
    if q.dtype == torch.float32:
        return "cuda_cores"
    elems = _ALIGN_BYTES // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % _ALIGN_BYTES:
            raise ValueError(f"bf16 flash attention needs a 16-byte aligned {name}")
        if any(n > 1 and s % elems for n, s in zip(t.shape[:-1], t.stride()[:-1])):
            raise ValueError(f"bf16 flash attention needs {name}'s strides in multiples "
                             f"of {elems} elements, got {t.stride()}")
    return "tensor_cores"


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, sm_scale: Optional[float] = None,
                        q_offset: Optional[int] = None):
    """GQA attention forward. q ``(B, Hq, S, D)``, k/v ``(B, Hkv, T, D)``.

    Returns ``(out (B, Hq, S, D) in q's dtype, lse (B, Hq, S) f32)``. Causal
    with query i at absolute position ``q_offset + i`` (default ``T - S``),
    which must be >= 0. Operands may be strided views whose last dim is
    contiguous (the kernel takes their strides). A CUDA tensor launches the
    kernel (counted in ``flash_attention_fwd.launches``) or raises; a CPU
    tensor runs the plain version."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k/v {tuple(k.shape)}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if q_offset is None:
        q_offset = T - S
    if causal and q_offset < 0:
        raise ValueError(f"causal flash attention needs q_offset >= 0, got {q_offset}")
    devices = {q.device, k.device, v.device}
    if devices == {torch.device("cpu")}:
        return ref.flash_attention_fwd_ref(q, k, v, causal=causal, sm_scale=sm_scale,
                                           q_offset=q_offset)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash_attention: operands on {sorted(map(str, devices))}")
    _plan(q, k, v)
    if q.numel() == 0 or T == 0:
        raise ValueError(f"flash_attention: empty operands q {tuple(q.shape)}, k {tuple(k.shape)}")
    out = torch.empty((B, Hq, S, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    from repro_torch.kernels._build import load_kernels

    load_kernels().flash_attention_fwd(q, k, v, out, lse, bool(causal), float(sm_scale),
                                       int(q_offset))
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
