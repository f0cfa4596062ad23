"""Flash attention: the CUDA kernels ``csrc/flash_attention.cu`` on the card,
their plain versions (``ref.flash_attention_fwd_ref``,
``ref.flash_attention_bwd_ref``) on the CPU.

The forward is the counterpart of the TPU kernel
``repro/kernels/flash_attention.py:flash_attention_fwd``. On the card, bf16
runs on the tensor cores and f32 (the parity type) on the CUDA cores, both for
every head size in ``HEAD_DIMS``. The backward (``flash_attention_bwd``) has no
TPU counterpart: it takes bf16 on the tensor cores only, from the forward's
``out`` and ``lse``.
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


def _misaligned(name: str, t: torch.Tensor) -> Optional[str]:
    """Why the bf16 kernels, which copy rows in 16-byte chunks, cannot read
    ``t``: its base pointer or the stride of a dim longer than 1 off the
    16-byte grid; None where they can."""
    elems = _ALIGN_BYTES // t.element_size()
    if t.data_ptr() % _ALIGN_BYTES:
        return f"bf16 flash attention needs a 16-byte aligned {name}"
    if any(n > 1 and s % elems for n, s in zip(t.shape[:-1], t.stride()[:-1])):
        return (f"bf16 flash attention needs {name}'s strides in multiples of {elems} "
                f"elements, got {t.stride()}")
    return None


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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if fault := _misaligned(name, t):
            raise ValueError(fault)
    return "tensor_cores"


def _plan_bwd(q, k, v, out, lse, dout) -> torch.Tensor:
    """The backward kernel's operand checks: ``_plan``'s, with bf16 the only
    dtype, out and dout of q's dtype, out aligned as q, lse contiguous f32.
    Returns dout as the kernel reads it: made contiguous where its last dim
    is strided or its rows are off the 16-byte grid."""
    if _plan(q, k, v) != "tensor_cores":
        raise TypeError(f"the flash attention backward kernel takes bf16 q, k, v, got {q.dtype}")
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise TypeError(f"flash attention backward: out {out.dtype} and dout {dout.dtype} "
                        f"must be q's {q.dtype}")
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise TypeError(f"flash attention backward needs a contiguous f32 lse, got {lse.dtype}")
    if out.stride(-1) != 1:
        raise ValueError("flash attention backward needs out with a contiguous last dim")
    if fault := _misaligned("out", out):
        raise ValueError(fault)
    if dout.stride(-1) != 1 or _misaligned("dout", dout):
        dout = dout.contiguous()
    return dout


def _dims(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, what: str):
    """``(B, Hq, S, D, Hkv, T)`` of q ``(B, Hq, S, D)`` and k/v ``(B, Hkv, T, D)``,
    or raise."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{what}: q {tuple(q.shape)} vs k/v {tuple(k.shape)}")
    return B, Hq, S, D, Hkv, T


def _defaults(D: int, S: int, T: int, causal: bool, sm_scale, q_offset):
    """``(sm_scale, q_offset)``: 1 / sqrt(D) and T - S where not given;
    causal attention needs q_offset >= 0."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if q_offset is None:
        q_offset = T - S
    if causal and q_offset < 0:
        raise ValueError(f"causal flash attention needs q_offset >= 0, got {q_offset}")
    return sm_scale, q_offset


def _device(what: str, *tensors):
    """None when every operand lies on the CPU, the one CUDA device they share
    otherwise, or raise."""
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return None
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{what}: operands on {sorted(map(str, devices))}")
    return next(iter(devices))


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
    B, Hq, S, D, Hkv, T = _dims(q, k, v, "flash_attention")
    sm_scale, q_offset = _defaults(D, S, T, causal, sm_scale, q_offset)
    if _device("flash_attention", q, k, v) is None:
        return ref.flash_attention_fwd_ref(q, k, v, causal=causal, sm_scale=sm_scale,
                                           q_offset=q_offset)
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


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                        causal: bool = True, sm_scale: Optional[float] = None,
                        q_offset: Optional[int] = None):
    """Gradients of ``flash_attention_fwd`` against ``dout``, from the
    forward's ``out`` and ``lse``: ``(dq, dk, dv)`` in the operands' dtype,
    shaped as q, k and v. Shapes, ``causal``, ``sm_scale`` and ``q_offset``
    as the forward's; ``out`` and ``dout`` laid out as q, ``lse`` ``(B, Hq,
    S)`` f32. A CUDA tensor launches the bf16 kernel (counted in
    ``flash_attention_bwd.launches``, one a call) or raises, f32 included;
    a CPU tensor runs the plain version. It never runs the forward."""
    B, Hq, S, D, Hkv, T = _dims(q, k, v, "flash_attention_bwd")
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (B, Hq, S):
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, out {tuple(out.shape)}, "
                         f"dout {tuple(dout.shape)}, lse {tuple(lse.shape)}")
    sm_scale, q_offset = _defaults(D, S, T, causal, sm_scale, q_offset)
    if _device("flash_attention_bwd", q, k, v, out, lse, dout) is None:
        return ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                                           sm_scale=sm_scale, q_offset=q_offset)
    dout = _plan_bwd(q, k, v, out, lse, dout)
    if q.numel() == 0 or T == 0:
        raise ValueError(f"flash_attention_bwd: empty operands q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    dq = torch.empty((B, Hq, S, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Hkv, T, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    from repro_torch.kernels._build import load_kernels

    load_kernels().flash_attention_bwd(q, k, v, out, lse, dout, dq, dk, dv, bool(causal),
                                       float(sm_scale), int(q_offset))
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
