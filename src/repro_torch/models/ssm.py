"""Mamba-2 mixer block: projections + depthwise conv + SSD scan (counterpart
of ``repro/models/ssm.py``).

Single-group (G=1) SSD as in the Mamba-2 370m config: per-head scalar decay
A, shared B/C streams of width ssm_state, headdim = d_inner / nheads.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

CONV_K = 4


def ssm_dims(arch) -> tuple[int, int, int, int]:
    """(d_inner, heads H, head dim P, state N) of the mixer."""
    d_inner = arch.ssm_expand * arch.hidden
    H = arch.ssm_heads or max(d_inner // 64, 1)
    return d_inner, H, d_inner // H, arch.ssm_state


def _depthwise_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv along seq. x: (B, S, C), w: (K, C).

    The same K shifted products summed as the JAX package, not ``F.conv1d``:
    a float32 convolution would go through cuDNN, in TF32 by default and
    summed in another order."""
    K = w.shape[0]
    pad = F.pad(x, (0, 0, K - 1, 0))
    return sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(K))


def ssm_block(p: dict, x: torch.Tensor, arch, *, ssm_impl: str = "cuda",
              cache: Optional[tuple[torch.Tensor, torch.Tensor]] = None):
    """x: (B, S, d). cache: None (full sequence from a zero state) or
    (conv (B, CONV_K - 1, conv_dim), state (B, H, P, N)) of one layer.

    Returns ``(out (B, S, d), new_cache)``; new_cache is None without a cache,
    else (the last CONV_K - 1 raw conv inputs, the state after the last
    step). With a cache the scan is the plain version, as the JAX package's
    ``impl="xla"`` there."""
    B, S, d = x.shape
    d_inner, H, P, N = ssm_dims(arch)

    zxbcdt = x @ p["in_proj"]  # (B, S, 2*d_inner + 2N + H)
    z, xbc, dt_raw = torch.split(zxbcdt, [d_inner, d_inner + 2 * N, H], dim=-1)

    new_cache = None
    if cache is None:
        xbc = _depthwise_conv(xbc, p["conv_w"]) + p["conv_b"]
    else:
        conv_cache, state_in = cache
        hist = torch.cat([conv_cache, xbc], dim=1)  # (B, K-1+S, C)
        xbc = _depthwise_conv(hist, p["conv_w"])[:, CONV_K - 1:] + p["conv_b"]
        new_conv = hist[:, -(CONV_K - 1):]
    xbc = F.silu(xbc)
    # views of one tensor with a contiguous last dim: the kernel takes strides
    xs, Bm, C = torch.split(xbc, [d_inner, N, N], dim=-1)
    xs = xs.reshape(B, S, H, P)
    dt = F.softplus(dt_raw + p["dt_bias"])  # (B, S, H)
    A = -torch.exp(p["A_log"])  # (H,)

    if cache is None:
        y = ops.ssd(xs, dt, A, Bm, C, p["D"], impl=ssm_impl)
    else:
        y, state_out = ops.ssd_with_state(xs, dt, A, Bm, C, p["D"], init_state=state_in,
                                          impl="torch")
        new_cache = (new_conv, state_out)

    y = y.reshape(B, S, d_inner)
    y = y * F.silu(z)  # gate
    return y @ p["out_proj"], new_cache
