"""Blockwise online-softmax attention in plain PyTorch.

Counterpart of ``repro/kernels/xla_flash.py:flash_xla`` (a ``jnp`` scan, not a
Pallas kernel, so it stays plain PyTorch here; the module keeps its name so a
reader finds the counterpart). It is the serving path's attention against a
(partially filled) KV cache: ``q_start`` places the queries, ``kv_valid_len``
hides the cache slots not written yet.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

_NEG = -1e30


def flash_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              q_start: Optional[int] = None, kv_valid_len: Optional[int] = None,
              ring: bool = False, causal: bool = True,
              sm_scale: Optional[float] = None, block: int = 512) -> torch.Tensor:
    """q ``(B, Hq, S, D)`` at absolute positions ``q_start + i`` (default
    ``T - S``); k/v ``(B, Hkv, T, D)`` of which slots ``< kv_valid_len`` are
    live (default all). Returns ``(B, Hq, S, D)`` in q's dtype."""
    if ring:
        raise NotImplementedError("ring-buffer KV caches belong to the hybrid family")
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    if q_start is None:
        q_start = T - S
    valid = T if kv_valid_len is None else kv_valid_len
    qf = q.float().reshape(B, Hkv, group, S, D)
    qpos = q_start + torch.arange(S, device=q.device)

    bk = min(block, T)
    m = torch.full((B, Hkv, group, S), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, group, S, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, T, bk):
        kpos = torch.arange(k0, min(k0 + bk, T), device=q.device)
        kblk = k[:, :, k0:k0 + bk].float()
        vblk = v[:, :, k0:k0 + bk].float()
        s = torch.einsum("bhgsd,bhtd->bhgst", qf, kblk) * scale
        mask = (kpos < valid)[None, :]
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        s = torch.where(mask, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgst,bhtd->bhgsd", p, vblk)
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l[..., None]).reshape(B, Hq, S, D).to(q.dtype)
