"""Public wrappers over the kernels, the counterparts of
``repro/kernels/ops.py`` (``flash_attention``, ``fused_rmsnorm``, ``ssd``,
``ssd_with_state``).

Each op takes ``impl``:
  * ``"cuda"``  - the hand-written kernel (its wrapper runs the plain version
                  for a tensor on the CPU);
  * ``"torch"`` - the plain PyTorch version (``ref``), on any device: the JAX
                  package's "naive" path, which the kernels are held against;
  * ``"xla"``   - the JAX package's "xla" path: attention through
                  ``xla_flash.flash_xla_train`` (blockwise, with a
                  blockwise-recompute backward), the norm and the SSD scan
                  through their plain versions.

The kernel path is a ``torch.autograd.Function``. Its backward is the JAX
package's: the VJP of the plain version, recomputed from the saved inputs
(``repro/kernels/ops.py`` ``_fa_bwd``, ``_rn_bwd``, ``_ssd_bwd``). The JAX
package has no backward kernel, so neither has the port.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.rmsnorm import rmsnorm_fwd
from repro_torch.kernels.ssd import ssd_scan_fwd
from repro_torch.kernels.xla_flash import flash_xla_train

IMPLS = ("cuda", "torch", "xla")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def _plain_vjp(ctx, plain, grad_out):
    """Gradients of ``plain`` at the saved inputs against ``grad_out``, for
    the inputs that need one (None for the rest)."""
    saved = ctx.saved_tensors
    wanted = ctx.needs_input_grad[:len(saved)]
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(w) for t, w in zip(saved, wanted)]
        out = plain(*inputs)
        grads = torch.autograd.grad(out, [t for t, w in zip(inputs, wanted) if w],
                                    grad_out)
    it = iter(grads)
    return [next(it) if w else None for w in wanted]


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        out, _ = flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale)
        return out

    @staticmethod
    def backward(ctx, g):
        def plain(q, k, v):
            return ref.attention(q, k, v, causal=ctx.causal, sm_scale=ctx.sm_scale)

        return (*_plain_vjp(ctx, plain, g), None, None)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return rmsnorm_fwd(x, weight, eps=eps)

    @staticmethod
    def backward(ctx, g):
        return (*_plain_vjp(ctx, lambda x, w: ref.rmsnorm(x, w, eps=ctx.eps), g), None)


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, C, D):
        ctx.save_for_backward(x, dt, A, Bm, C, D)
        y, _ = ssd_scan_fwd(x, dt, A, Bm, C, D)
        return y

    @staticmethod
    def backward(ctx, g):
        return tuple(_plain_vjp(ctx, ref.ssd_scan, g))


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: Optional[float] = None, impl: str = "cuda"):
    """GQA flash attention. q ``(B, Hq, S, D)``, k/v ``(B, Hkv, T, D)``."""
    _check_impl(impl)
    if impl == "cuda":
        return _FlashAttention.apply(q, k, v, causal, sm_scale)
    if impl == "xla":
        return flash_xla_train(q, k, v, causal, sm_scale, 512)
    return ref.attention(q, k, v, causal=causal, sm_scale=sm_scale)


def fused_rmsnorm(x, weight, *, eps: float = 1e-6, impl: str = "cuda"):
    _check_impl(impl)
    if impl == "cuda":
        return _RMSNorm.apply(x, weight, eps)
    return ref.rmsnorm(x, weight, eps=eps)


def _zeros_d(x, D):
    return torch.zeros(x.shape[2], dtype=torch.float32, device=x.device) if D is None else D


def ssd(x, dt, A, Bm, C, D=None, *, impl: str = "cuda"):
    """Mamba-2 SSD mixer, training form (zero initial state, no state out).
    x ``(B, S, H, P)``, dt ``(B, S, H)``, A ``(H,)``, Bm/C ``(B, S, N)``;
    D None means f32 zeros."""
    _check_impl(impl)
    D = _zeros_d(x, D)
    if impl == "cuda":
        return _SSD.apply(x, dt, A, Bm, C, D)
    return ref.ssd_scan(x, dt, A, Bm, C, D)


def ssd_with_state(x, dt, A, Bm, C, D=None, *, init_state=None, impl: str = "torch"):
    """Prefill/decode form: returns ``(y, final_state)``. The kernel starts
    from a zero state, so an ``init_state`` always takes the plain version."""
    _check_impl(impl)
    D = _zeros_d(x, D)
    if impl == "cuda" and init_state is None:
        return ssd_scan_fwd(x, dt, A, Bm, C, D)
    return ref.ssd_scan(x, dt, A, Bm, C, D, init_state=init_state, return_state=True)
