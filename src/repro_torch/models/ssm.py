"""Mamba-2 mixer block: projections + depthwise conv + SSD scan (counterpart
of ``repro/models/ssm.py``).

Single-group (G=1) SSD as in the Mamba-2 370m config: per-head scalar decay
A, shared B/C streams of width ssm_state, headdim = d_inner / nheads.

Sharded (params, activations and caches as DTensors, placed by
``repro_torch.parallel.sharding``): the fused ``in_proj`` product is cut over
"model" where its width divides, and those cuts fall inside z, x, B, C and
dt, not on head boundaries. So the product is made whole over "model" before
the split; the depthwise conv runs on each rank's channels (``local_apply``,
as ``conv_w``, ``conv_b`` and the conv cache lie), and its output is made
whole again before the x | B | C split; the scan runs on each rank's heads
(``ops.ssd``); y and the gate z are split over "model" along d_inner, so
that ``out_proj``, sharded on its rows, gives a partial sum.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels import ops
from repro_torch.parallel.sharding import (MODEL_AXIS, gather_fsdp, local_apply,
                                           split_over_model, whole_over_model)

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


def _conv_silu(x, w, b, conv_cache=None):
    """silu of the causal depthwise conv plus its bias over x ``(B, S, C)``;
    with ``conv_cache`` ``(B, CONV_K - 1, C)`` in front of x, also the new
    cache (the last CONV_K - 1 raw inputs). On DTensors each rank convolves
    its own channels (see ``_sharded_conv``)."""
    if isinstance(x, DTensor):
        return _sharded_conv(x, w, b, conv_cache)
    return _local_conv(x, w, b, conv_cache)


def _local_conv(x, w, b, conv_cache=None):
    if conv_cache is None:
        return F.silu(_depthwise_conv(x, w) + b)
    hist = torch.cat([conv_cache, x], dim=1)  # (B, K-1+S, C)
    out = F.silu(_depthwise_conv(hist, w)[:, CONV_K - 1:] + b)
    return out, hist[:, -(CONV_K - 1):]


def _sharded_conv(x, w, b, conv_cache):
    """The conv on DTensors: x keeps its rows over the batch axes and is
    split over "model" by channels where "model" divides them, as ``conv_w``,
    ``conv_b`` and the conv cache lie; the weight's grads are partial sums
    over the mesh dims that split the rows. The new cache comes back in x's
    placements."""
    mesh = x.device_mesh
    C = x.shape[-1]
    tp = dict(zip(mesh.mesh_dim_names, mesh.shape)).get(MODEL_AXIS, 1)
    split_c = tp > 1 and C % tp == 0
    px, pw, pb, gw, gb = [], [], [], [], []  # x, w, b and the grads of w and b
    for name, place in zip(mesh.mesh_dim_names, x.placements):
        if name == MODEL_AXIS and split_c:
            places = (Shard(2), Shard(1), Shard(0), Shard(1), Shard(0))
        elif name != MODEL_AXIS and place == Shard(0):
            places = (Shard(0), Replicate(), Replicate(), Partial(), Partial())
        else:
            places = (Replicate(),) * 5
        for out, p in zip((px, pw, pb, gw, gb), places):
            out.append(p)
    if conv_cache is None:
        return local_apply(_local_conv, (x, w, b), (px, pw, pb), px, (px, gw, gb))
    return local_apply(_local_conv, (x, w, b, conv_cache), (px, pw, pb, px), (px, px),
                       out_shape=(x.shape, conv_cache.shape))


def _settled(x):
    """``x`` with its partial sums settled. Over a batch axis of size 1
    ``gather_fsdp`` leaves the weight's rows sharded, and the in_proj product
    comes out a partial sum there; left so, DTensor settles it inside the
    elementwise ops after the split by a reduce-scatter onto B, and a one-row
    B sharded there fails the product's backward view."""
    if isinstance(x, DTensor) and any(p.is_partial() for p in x.placements):
        return x.redistribute(x.device_mesh, tuple(Replicate() if p.is_partial() else p
                                                   for p in x.placements))
    return x


def ssm_block(p: dict, x: torch.Tensor, arch, *, ssm_impl: str = "cuda",
              cache: Optional[tuple[torch.Tensor, torch.Tensor]] = None):
    """x: (B, S, d). cache: None (full sequence from a zero state) or
    (conv (B, CONV_K - 1, conv_dim), state (B, H, P, N)) of one layer.

    Returns ``(out (B, S, d), new_cache)``; new_cache is None without a cache,
    else (the last CONV_K - 1 raw conv inputs, the state after the last
    step). With a cache the scan is the plain version, as the JAX package's
    ``impl="xla"`` there. The same code runs on DTensors (module docstring);
    ``whole_over_model``, ``split_over_model`` and ``gather_fsdp`` are the
    identity on plain tensors."""
    B, S, d = x.shape
    d_inner, H, P, N = ssm_dims(arch)

    # (B, S, 2*d_inner + 2N + H)
    zxbcdt = _settled(whole_over_model(x @ gather_fsdp(p["in_proj"])))
    z, xbc, dt_raw = torch.split(zxbcdt, [d_inner, d_inner + 2 * N, H], dim=-1)

    new_cache = None
    if cache is None:
        xbc = _conv_silu(xbc, p["conv_w"], p["conv_b"])
    else:
        conv_cache, state_in = cache
        xbc, new_conv = _conv_silu(xbc, p["conv_w"], p["conv_b"], conv_cache)
    # views of one tensor with a contiguous last dim: the kernel takes strides
    xs, Bm, C = torch.split(whole_over_model(xbc), [d_inner, N, N], dim=-1)
    xs = xs.reshape(B, S, H, P)
    dt = F.softplus(dt_raw + p["dt_bias"])  # (B, S, H)
    A = -torch.exp(p["A_log"])  # (H,)

    if cache is None:
        y = ops.ssd(xs, dt, A, Bm, C, p["D"], impl=ssm_impl)
    else:
        y, state_out = ops.ssd_with_state(xs, dt, A, Bm, C, p["D"], init_state=state_in,
                                          impl="torch")
        new_cache = (new_conv, state_out)

    y = split_over_model(y.reshape(B, S, d_inner), -1)
    y = y * F.silu(split_over_model(z, -1))  # gate
    return y @ gather_fsdp(p["out_proj"]), new_cache
