"""Public wrappers over the kernels, the counterparts of
``repro/kernels/ops.py`` (``flash_attention``, ``fused_rmsnorm``).

Each op takes ``impl``:
  * ``"cuda"``  - the hand-written kernel (its wrapper runs the plain version
                  for a tensor on the CPU);
  * ``"torch"`` - the plain PyTorch version (``ref``), on any device.

The kernel path is a ``torch.autograd.Function`` whose backward raises: the
backward kernels belong to the training slice, and a cpp-extension output
would otherwise carry no ``grad_fn`` and silently detach.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.rmsnorm import rmsnorm_fwd

IMPLS = ("cuda", "torch")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def _no_backward(ctx, *grads):
    raise NotImplementedError("backward kernel: training slice")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, _ = flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale)
        return out

    backward = staticmethod(_no_backward)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps):
        return rmsnorm_fwd(x, weight, eps=eps)

    backward = staticmethod(_no_backward)


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: Optional[float] = None, impl: str = "cuda"):
    """GQA flash attention. q ``(B, Hq, S, D)``, k/v ``(B, Hkv, T, D)``."""
    _check_impl(impl)
    if impl == "cuda":
        return _FlashAttention.apply(q, k, v, causal, sm_scale)
    return ref.attention(q, k, v, causal=causal, sm_scale=sm_scale)


def fused_rmsnorm(x, weight, *, eps: float = 1e-6, impl: str = "cuda"):
    _check_impl(impl)
    if impl == "cuda":
        return _RMSNorm.apply(x, weight, eps)
    return ref.rmsnorm(x, weight, eps=eps)
