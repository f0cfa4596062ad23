"""The yardstick: the H100's published peaks, the model FLOPs of a step, and
the least time of the K1 (RMSNorm) and K2 (flash attention forward) work of a
step, all from a configuration's shapes and never from the program's counters.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit.
"""
from __future__ import annotations

import collections

from portbench.harness.spec import Shape

BF16_FLOPS = 989e12  # tensor cores, bf16 / fp16
F32_FLOPS = 67e12  # CUDA cores, float32
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, ops: float, peak_ops: float) -> float:
    """The least time of a kernel: its bytes once at HBM speed, or its
    operations at the peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak_ops)


def matmul_params(s: Shape) -> float:
    """Parameters that a token multiplies: the layers' weight products and
    the head. Of a mixture of experts, the router and the ``top_k`` experts
    the token is routed to; the capacity's padded slots are not model
    work."""
    d, D = s.hidden, s.head_dim
    attn = d * (s.heads + 2 * s.kv_heads) * D + s.heads * D * d
    mlp = d * s.experts + s.top_k * 3 * d * s.expert_ffn if s.experts else 3 * d * s.ffn
    return float(s.layers * (attn + mlp) + d * s.vocab)


def causal_pairs(S: int, T: int) -> int:
    """The (query, key) pairs a causal mask leaves, the S queries being the
    last S of the T keys."""
    return sum(min(T - S + i + 1, T) for i in range(S))


def window_pairs(S: int, T: int, W: int) -> int:
    """The pairs a causal mask with the window W leaves (query i sees keys
    i - W < j <= i), the S queries being the last S of the T keys; W = 0 is
    the causal mask."""
    if not W:
        return causal_pairs(S, T)
    return sum(min(T - S + i + 1, W) for i in range(S))


def attn_pairs(s: Shape, S: int, T: int) -> int:
    """The pairs of every layer together, each under its own window."""
    return sum(n * window_pairs(S, T, W) for W, n in collections.Counter(s.windows).items())


def train_flops(s: Shape, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: 6 x matmul params x tokens, plus
    attention's QK^T and PV (2 x 2 x head_dim FLOPs a pair and head, over the
    pairs each layer's mask leaves), x3 for the forward and the backward.
    Recompute is not model FLOPs."""
    tokens = batch * seq
    attn = 4.0 * s.heads * s.head_dim * attn_pairs(s, seq, seq) * batch
    return 6.0 * matmul_params(s) * tokens + 3.0 * attn


def serve_batch_flops(s: Shape, batch: int, prompt: int, new_tokens: int) -> float:
    """Model FLOPs of one served batch: the prefill of ``prompt`` tokens a
    request, then the ``new_tokens - 1`` decode steps whose logits give the
    2nd to last served token (the first comes from the prefill), each at its
    position p in the cache, reading p + 1 keys a layer, or min(p + 1, W)
    under a window W."""
    per_token = 2.0 * matmul_params(s)
    attn_pair = 4.0 * s.heads * s.head_dim
    flops = batch * (prompt * per_token + attn_pair * attn_pairs(s, prompt, prompt))
    for i in range(new_tokens - 1):
        flops += batch * (per_token + attn_pair * attn_pairs(s, 1, prompt + i + 1))
    return flops


def rmsnorm_bound_s(rows: int, D: int, elem: int = 2) -> float:
    """K1 on (rows, D): x read and y written once, the weight read once."""
    return bound_s((2 * rows * D + D) * elem, 4.0 * rows * D, F32_FLOPS)


def attn_fwd_bound_s(B: int, Hq: int, Hkv: int, S: int, T: int, D: int,
                     causal: bool = True, elem: int = 2) -> float:
    """K2's forward: q, k, v read and out written once in bf16, the f32
    log-sum-exp written once; 4 x D FLOPs a (q, k) pair and head, over the
    pairs the mask leaves."""
    nbytes = (2 * B * Hq * S * D + 2 * B * Hkv * T * D) * elem + B * Hq * S * 4
    pairs = causal_pairs(S, T) if causal else S * T
    return bound_s(nbytes, 4.0 * B * Hq * D * pairs, BF16_FLOPS)


def train_norm_launches(s: Shape) -> int:
    """K1 launches a train step's forward makes: ln1 and ln2 a layer and the
    final norm (the backward is the plain version's VJP)."""
    return 2 * s.layers + 1


def train_attn_launches(s: Shape, seq: int) -> int:
    """K2 launches a train step's forward makes: one a layer that the port
    sends to it at S = ``seq``, every layer but those whose window is
    shorter than S (``banded_flash_xla``'s, ``lm._attn_sublayer``)."""
    return sum(not W or W >= seq for W in s.windows)
