"""Blockwise online-softmax attention in plain PyTorch.

Counterparts of ``repro/kernels/xla_flash.py`` (``jnp`` scans, not Pallas
kernels, so they stay plain PyTorch here; the module keeps its name so a
reader finds them):

  * ``flash_xla_train`` - the training path's ``impl="xla"`` attention: a
    forward over KV blocks with a blockwise-recompute backward;
  * ``flash_xla``       - attention against a (partially filled) KV cache:
    ``q_start`` places the queries, ``kv_valid_len`` hides the cache slots
    not written yet, ``ring`` marks a sliding-window cache that wraps around;
    ``flash_xla_lse`` gives its output over one part of the keys with its
    log-sum-exp, for a cache split over its sequence. The serving path takes
    it for a ring, an int8 cache, the ``"xla"`` and ``"torch"`` impls and a
    sharded cache split over its sequence; any other cache goes to the flash
    kernel (``models/lm.py`` ``_flash_cached_attention``);
  * ``banded_flash_xla`` - causal sliding-window attention over Q blocks,
    each against the ``window + block_q`` keys it can see, with a
    blockwise-recompute backward.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import spans

_NEG = -1e30


def _kv_blocks(k: torch.Tensor, group: int, block: int):
    """k ``(B, Hkv, T, D)`` repeated to the query-head count (head h reads kv
    head h // group, as the JAX package's ``_kv_repeat``), padded with zeros
    to whole blocks of ``min(block, T)`` keys and cast to f32: ``(B, Hq, nb,
    bk, D)``."""
    B, Hkv, T, D = k.shape
    bk = min(block, T)
    nb = -(-T // bk)
    kx = k.repeat_interleave(group, dim=1) if group > 1 else k
    kx = torch.nn.functional.pad(kx, (0, 0, 0, nb * bk - T))
    return kx.float().reshape(B, Hkv * group, nb, bk, D)


def _block_scores(qf, kblk, ib: int, bk: int, T: int, qpos, causal: bool, scale: float):
    """Masked f32 scores of block ib: padding past T and, when causal, keys
    after the query are _NEG."""
    s = torch.einsum("bhsd,bhtd->bhst", qf, kblk) * scale
    kpos = ib * bk + torch.arange(bk, device=qf.device)
    mask = (kpos < T)[None, :]
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    return torch.where(mask, s, _NEG)


class _FlashXlaTrain(torch.autograd.Function):
    """The forward keeps only (q, k, v, out, lse); the backward recomputes
    each block's probabilities from lse, as the JAX package's
    ``_flash_train_bwd``. Autograd
    through the forward loop would keep every block's probabilities, O(S*T)
    per head, which is what flash attention exists to avoid."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: Optional[float], block: int):
        B, Hq, S, D = q.shape
        group, T = Hq // k.shape[1], k.shape[2]
        scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
        kb, vb = _kv_blocks(k, group, block), _kv_blocks(v, group, block)
        nb, bk = kb.shape[2], kb.shape[3]
        qf = q.float()
        qpos = (T - S) + torch.arange(S, device=q.device)
        m = torch.full((B, Hq, S), _NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hq, S, D), dtype=torch.float32, device=q.device)
        for ib in range(nb):
            s = _block_scores(qf, kb[:, :, ib], ib, bk, T, qpos, causal, scale)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bhst,bhtd->bhsd", p, vb[:, :, ib])
            m = m_new
        l_safe = torch.where(l == 0.0, 1.0, l)
        out = (acc / l_safe[..., None]).to(q.dtype)
        lse = m + torch.log(l_safe)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.block = causal, scale, block
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        B, Hq, S, D = q.shape
        Hkv, T = k.shape[1], k.shape[2]
        group = Hq // Hkv
        scale = ctx.scale
        kb, vb = _kv_blocks(k, group, ctx.block), _kv_blocks(v, group, ctx.block)
        nb, bk = kb.shape[2], kb.shape[3]
        qf = q.float()
        qpos = (T - S) + torch.arange(S, device=q.device)
        do = dout.float()
        delta = torch.sum(do * out.float(), dim=-1)  # (B, Hq, S)
        dq = torch.zeros((B, Hq, S, D), dtype=torch.float32, device=q.device)
        dks, dvs = [], []
        for ib in range(nb):
            kblk, vblk = kb[:, :, ib], vb[:, :, ib]
            s = _block_scores(qf, kblk, ib, bk, T, qpos, ctx.causal, scale)
            p = torch.exp(s - lse[..., None])
            dvs.append(torch.einsum("bhst,bhsd->bhtd", p, do))
            dp = torch.einsum("bhsd,bhtd->bhst", do, vblk)
            ds = p * (dp - delta[..., None]) * scale
            dq = dq + torch.einsum("bhst,bhtd->bhsd", ds, kblk)
            dks.append(torch.einsum("bhst,bhsd->bhtd", ds, qf))
        # fold the repeated kv heads back: sum over each group
        dk = torch.cat(dks, dim=2)[:, :, :T].reshape(B, Hkv, group, T, D).sum(dim=2)
        dv = torch.cat(dvs, dim=2)[:, :, :T].reshape(B, Hkv, group, T, D).sum(dim=2)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def flash_xla_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    sm_scale: Optional[float] = None, block: int = 512) -> torch.Tensor:
    """Differentiable GQA attention over KV blocks of ``block`` keys, the
    queries as the last S of the T keys. q ``(B, Hq, S, D)``, k/v ``(B, Hkv,
    T, D)``; returns ``(B, Hq, S, D)`` in q's dtype. Math in f32."""
    return _FlashXlaTrain.apply(q, k, v, causal, sm_scale, block)


def live_pairs(q_start: int, S: int, T: int, valid: int, causal: bool) -> int:
    """The (query, key) pairs ``_flash_xla_parts``'s mask leaves for one
    head, the ring not wrapped: query ``q_start + i`` sees the slots ``j <
    min(valid, T)`` and, when causal, ``j <= q_start + i``."""
    cap = max(0, min(valid, T))
    if not causal:
        return S * cap

    def upto(n):  # sum over x = 1 .. n of min(x, cap)
        n = max(n, 0)
        return n * (n + 1) // 2 if n <= cap else cap * (cap + 1) // 2 + (n - cap) * cap

    return upto(q_start + S) - upto(q_start)


def _flash_xla_parts(q, k, v, q_start, kv_valid_len, ring, causal, sm_scale, block):
    """``flash_xla``'s online softmax: the normalised f32 output ``(B, Hkv,
    g, S, D)``, the running max m and the sum l ``(B, Hkv, g, S)``, l = 1
    where no key was live. Counts the pairs it scores, every query against
    every key slot (``attn.pairs_scored``), and those its mask leaves
    (``attn.pairs_live``; all once a ring has wrapped)."""
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    if q_start is None:
        q_start = T - S
    valid = T if kv_valid_len is None else kv_valid_len
    wrapped = ring and q_start + S - 1 >= T
    if spans.counting():
        spans.count("attn.pairs_scored", B * Hq * S * T)
        spans.count("attn.pairs_live",
                    B * Hq * (S * T if wrapped else live_pairs(q_start, S, T, valid, causal)))
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
        if not wrapped:
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
    return acc / l[..., None], m, l


def flash_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              q_start: Optional[int] = None, kv_valid_len: Optional[int] = None,
              ring: bool = False, causal: bool = True,
              sm_scale: Optional[float] = None, block: int = 512) -> torch.Tensor:
    """q ``(B, Hq, S, D)`` at absolute positions ``q_start + i`` (default
    ``T - S``); k/v ``(B, Hkv, T, D)`` of which slots ``< kv_valid_len`` are
    live (default all). ``ring``: k/v is a ring buffer of the last T
    positions; once it has wrapped (``q_start + S - 1 >= T``) every slot is
    live and no causal mask applies. Returns ``(B, Hq, S, D)`` in q's
    dtype."""
    out, _, _ = _flash_xla_parts(q, k, v, q_start, kv_valid_len, ring, causal, sm_scale, block)
    return out.reshape(q.shape).to(q.dtype)


def flash_xla_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_start: int,
                  kv_valid_len: int, causal: bool = True, sm_scale: Optional[float] = None,
                  block: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """``flash_xla`` (no ring) over one part of the keys, for a merge with
    the other parts: the f32 output ``(B, Hq, S, D)`` normalised over this
    part and its log-sum-exp ``(B, Hq, S)``. ``q_start`` is relative to the
    part's first key and may be negative; a query that sees no key of the
    part gets a log-sum-exp near -1e30, which weighs nothing in a merge.
    ``causal=False`` with ``kv_valid_len`` the part's length: every key
    live, as in a ring that has wrapped."""
    out, m, l = _flash_xla_parts(q, k, v, q_start, kv_valid_len, False, causal, sm_scale,
                                 block)
    B, Hq, S, D = q.shape
    return out.reshape(B, Hq, S, D), (m + torch.log(l)).reshape(B, Hq, S)


# ---------------------------------------------------------------------------
# sliding window: Q blocks against the keys each can see
# ---------------------------------------------------------------------------

def _banded_block(qblk, kblk, vblk, start: int, window: int, S: int, scale: float):
    """Queries ``start .. start + bq - 1`` ``(B, Hkv, g, bq, D)`` f32 against
    the keys ``start - window .. start + bq - 1`` ``(B, Hkv, span, D)`` f32:
    key j is seen by query i when ``i - window < j <= i`` and ``0 <= j < S``."""
    bq, span = qblk.shape[3], kblk.shape[2]
    s = torch.einsum("bhgsd,bhtd->bhgst", qblk, kblk) * scale
    qpos = start + torch.arange(bq, device=qblk.device)
    kpos = start - window + torch.arange(span, device=qblk.device)
    mask = ((kpos[None, :] <= qpos[:, None]) & (kpos[None, :] > qpos[:, None] - window)
            & (kpos[None, :] >= 0) & (kpos[None, :] < S))
    p = torch.softmax(torch.where(mask, s, _NEG), dim=-1)
    return torch.einsum("bhgst,bhtd->bhgsd", p, vblk)


def _banded_operands(q, k, v, window: int, block_q: int):
    """Q padded to whole blocks of ``bq = min(block_q, S)`` queries, in f32
    ``(B, Hkv, g, nq, bq, D)``; k/v padded by ``window`` zero keys in front
    and to the padded length behind, f32 ``(B, Hkv, window + nq bq, D)``."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    bq = min(block_q, S)
    nq = -(-S // bq)
    pad = nq * bq - S
    qb = torch.nn.functional.pad(q, (0, 0, 0, pad)).float().reshape(
        B, Hkv, Hq // Hkv, nq, bq, D)
    kpad = torch.nn.functional.pad(k, (0, 0, window, pad)).float()
    vpad = torch.nn.functional.pad(v, (0, 0, window, pad)).float()
    return qb, kpad, vpad, bq, nq


class _BandedFlashXla(torch.autograd.Function):
    """Forward block by block (``_banded_impl``); the backward recomputes
    each block's probabilities and takes their VJP, adding each block's dk/dv
    into the window it read, as the JAX package's ``_banded_bwd``. Only q, k
    and v are kept between the two."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, block_q: int, scale: float):
        B, Hq, S, D = q.shape
        qb, kpad, vpad, bq, nq = _banded_operands(q, k, v, window, block_q)
        span = window + bq
        outs = [_banded_block(qb[:, :, :, ib], kpad[:, :, ib * bq:ib * bq + span],
                              vpad[:, :, ib * bq:ib * bq + span], ib * bq, window, S, scale)
                for ib in range(nq)]
        out = torch.stack(outs, dim=3).reshape(B, Hq, nq * bq, D)[:, :, :S]
        ctx.save_for_backward(q, k, v)
        ctx.window, ctx.block_q, ctx.scale = window, block_q, scale
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        window, scale = ctx.window, ctx.scale
        B, Hq, S, D = q.shape
        qb, kpad, vpad, bq, nq = _banded_operands(q, k, v, window, ctx.block_q)
        dob = torch.nn.functional.pad(dout, (0, 0, 0, nq * bq - S)).float().reshape(qb.shape)
        span = window + bq
        dk, dv = torch.zeros_like(kpad), torch.zeros_like(vpad)
        dqs = []
        for ib in range(nq):
            start = ib * bq
            with torch.enable_grad():
                blk = [t.detach().requires_grad_() for t in
                       (qb[:, :, :, ib], kpad[:, :, start:start + span],
                        vpad[:, :, start:start + span])]
                out = _banded_block(*blk, start, window, S, scale)
                dq_b, dk_b, dv_b = torch.autograd.grad(out, blk, dob[:, :, :, ib])
            dqs.append(dq_b)
            dk[:, :, start:start + span] += dk_b
            dv[:, :, start:start + span] += dv_b
        dq = torch.stack(dqs, dim=3).reshape(B, Hq, nq * bq, D)[:, :, :S]
        return (dq.to(q.dtype), dk[:, :, window:window + S].to(k.dtype),
                dv[:, :, window:window + S].to(v.dtype), None, None, None)


def banded_flash_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int,
                     block_q: int = 512, sm_scale: Optional[float] = None) -> torch.Tensor:
    """Causal sliding-window GQA attention: query i sees keys ``i - window <
    j <= i``. q ``(B, Hq, S, D)``, k/v ``(B, Hkv, S, D)``; returns ``(B, Hq,
    S, D)`` in q's dtype, math in f32. Work and memory O(S (window +
    block_q)); differentiable, with a blockwise-recompute backward."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _BandedFlashXla.apply(q, k, v, window, block_q, scale)
