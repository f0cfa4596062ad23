"""Shared building blocks: RoPE, norms, SwiGLU (counterparts of
``repro/models/layers.py``). Plain functions over explicit param dicts."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import ops
from repro_torch.parallel.sharding import (gather_fsdp, local_apply, split_over_model,
                                           whole_over_model)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: (B, H, S, D), positions: (B, S) or (S,). Angles in
    f32, the result cast back to x's dtype.

    A DTensor x (positions a plain tensor, the same on every rank) is roped
    shard by shard: the rotation is elementwise over its (b, h) rows, so B
    and H keep their sharding and S and D are made whole. DTensor's own
    propagation through the strided halves of a transposed x labels some
    grads with strides their local tensors do not have, and a later view of
    them fails."""
    if isinstance(x, DTensor):
        px = tuple(p if isinstance(p, Shard) and p.dim < 2 else Replicate()
                   for p in x.placements)
        return local_apply(lambda t: rope(t, positions, theta), (x,), (px,), px)
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


def swiglu(p: dict, x: torch.Tensor, constrain=None) -> torch.Tensor:
    """Gated MLP: wi packs [gate; up] on the output dim.

    ``constrain(x, dims)`` (optional, ModelCfg.constrain) pins the FFN
    intermediate's sharding, as the JAX package pins it. Sharded weights are
    gathered over the batch axes first (``gather_fsdp``), and the product is
    made whole over "model" before its halves are taken
    (``whole_over_model``) and the hidden split over it again before the down
    projection (``split_over_model``)."""
    gate_up = x @ gather_fsdp(p["wi"])  # (B, S, 2F)
    if constrain is not None:
        gate_up = constrain(gate_up, ("b", None, "m"))
    gate, up = whole_over_model(gate_up).chunk(2, dim=-1)
    hidden = F.silu(gate) * up
    if constrain is not None:
        hidden = constrain(hidden, ("b", None, "m"))
    return split_over_model(hidden, -1) @ gather_fsdp(p["wo"])
