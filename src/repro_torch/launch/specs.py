"""Stand-ins for every model input of the dry-run, the counterpart of
``repro/launch/specs.py``: tensors of the JAX package's shapes and dtypes
that hold no memory. On the default ``"meta"`` device nothing is allocated;
the dry-run calls these inside a ``FakeTensorMode`` on its device, which
makes them fake tensors there.

``position`` is a Python int: the port's cached path takes the position as
one (the JAX program's is a traced int32 scalar). The dry-run lowers a decode
step at ``seq_len - 1``, a full cache, which is what the JAX program's fixed
shapes compute at any position.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.arch import InputShape, ModelArch
from repro_torch.models.lm import ModelCfg, init_caches


def _struct(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def text_len(arch: ModelArch, seq_len: int) -> int:
    """Frontend-stub archs prepend embeddings; text gets the remainder."""
    if arch.frontend_stub and arch.frontend_seq:
        return max(seq_len - arch.frontend_seq, 1)
    return seq_len


def _extra_inputs(arch: ModelArch, B: int, cfg: ModelCfg, device) -> dict:
    if arch.family == "encdec":
        return {"enc_features": _struct((B, arch.encoder_seq, arch.hidden), cfg.dtype, device)}
    if arch.frontend_stub and arch.frontend_seq:
        return {"frontend": _struct((B, arch.frontend_seq, arch.hidden), cfg.dtype, device)}
    return {}


def train_batch_specs(arch: ModelArch, shape: InputShape, cfg: ModelCfg,
                      device="meta") -> dict:
    B, S = shape.global_batch, shape.seq_len
    out = {"tokens": _struct((B, text_len(arch, S)), torch.int32, device)}
    out.update(_extra_inputs(arch, B, cfg, device))
    return out


def cache_structs(arch: ModelArch, cfg: ModelCfg, batch: int, max_len: int,
                  device="meta") -> dict:
    """``init_caches``'s tensors without their contents. encdec's cross K/V
    are tensors of their shape: the dry-run never runs the encoder."""
    if arch.family != "encdec":
        return init_caches(arch, cfg, batch, max_len, device=device)
    caches = init_caches(dataclasses.replace(arch, family="dense"), cfg, batch, max_len,
                         device=device)
    T = arch.encoder_seq
    kv = (arch.num_layers, batch, arch.kv_heads, T, arch.head_dim)
    caches["enc_k"] = _struct(kv, cfg.dtype, device)
    caches["enc_v"] = _struct(kv, cfg.dtype, device)
    return caches


def prefill_specs(arch: ModelArch, shape: InputShape, cfg: ModelCfg, device="meta") -> dict:
    """Inputs for the prefill step: tokens + empty caches sized to seq_len."""
    B, S = shape.global_batch, shape.seq_len
    out = {
        "tokens": _struct((B, text_len(arch, S)), torch.int32, device),
        "caches": cache_structs(arch, cfg, B, S, device),
    }
    out.update(_extra_inputs(arch, B, cfg, device))
    return out


def decode_specs(arch: ModelArch, shape: InputShape, cfg: ModelCfg, device="meta") -> dict:
    """Inputs for one decode step against a seq_len-sized cache, at its last
    position."""
    B, S = shape.global_batch, shape.seq_len
    return {
        "tokens": _struct((B, 1), torch.int32, device),
        "caches": cache_structs(arch, cfg, B, S, device),
        "position": S - 1,
    }
