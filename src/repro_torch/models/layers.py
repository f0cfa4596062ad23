"""Shared building blocks: RoPE, norms, SwiGLU (counterparts of
``repro/models/layers.py``). Plain functions over explicit param dicts."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: (B, H, S, D), positions: (B, S) or (S,). Angles in
    f32, the result cast back to x's dtype."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[:, None, :, None].float() * freqs  # (B, 1, S, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def norm(x: torch.Tensor, w: torch.Tensor, impl: str = "cuda") -> torch.Tensor:
    return ops.fused_rmsnorm(x, w, impl=impl)


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Gated MLP: wi packs [gate; up] on the output dim."""
    gate, up = (x @ p["wi"]).chunk(2, dim=-1)
    return (F.silu(gate) * up) @ p["wo"]
