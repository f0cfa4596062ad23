"""Plain PyTorch versions of the kernels: the ground truth they are held
against, and what a kernel wrapper runs for a tensor that lies on the CPU.

Counterparts of ``repro/kernels/ref.py`` (same layouts: q ``(B, Hq, S, D)``,
k/v ``(B, Hkv, T, D)``, SSD x ``(B, S, H, P)``; math in float32, cast back to
the input dtype).
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def _causal_mask(S: int, T: int, q_offset: int, device) -> torch.Tensor:
    """(S, T) bool: query i sits at absolute position q_offset + i."""
    q_pos = torch.arange(S, device=device) + q_offset
    return q_pos[:, None] >= torch.arange(T, device=device)[None, :]


def _gqa_logits(q, k, sm_scale: Optional[float]) -> torch.Tensor:
    """f32 logits (B, Hkv, group, S, T); q-head h reads kv-head h // group."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if Hq % Hkv:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads {Hkv}")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Hkv, Hq // Hkv, S, D)
    return torch.einsum("bhgsd,bhtd->bhgst", qf, k.float()) * scale


def attention(q, k, v, *, causal: bool = True,
              sm_scale: Optional[float] = None) -> torch.Tensor:
    """Reference GQA attention; causal with the queries as the last S of the
    T keys. Returns (B, Hq, S, D) in q's dtype."""
    B, Hq, S, D = q.shape
    T = k.shape[2]
    logits = _gqa_logits(q, k, sm_scale)
    if causal:
        mask = _causal_mask(S, T, T - S, q.device)
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bhtd->bhgsd", probs, v.float())
    return out.reshape(B, Hq, S, D).to(q.dtype)


def flash_attention_fwd_ref(q, k, v, *, causal: bool = True,
                            sm_scale: Optional[float] = None,
                            q_offset: Optional[int] = None):
    """What the flash-attention kernel returns: ``(out, lse)``, out in q's
    dtype, lse float32 ``(B, Hq, S)``. ``q_offset`` defaults to T - S and
    must be >= 0 when causal, so that every query row sees key 0."""
    B, Hq, S, D = q.shape
    T = k.shape[2]
    if q_offset is None:
        q_offset = T - S
    logits = _gqa_logits(q, k, sm_scale)
    if causal:
        if q_offset < 0:
            raise ValueError(f"causal attention needs q_offset >= 0, got {q_offset}")
        mask = _causal_mask(S, T, q_offset, q.device)
        logits = logits.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhgst,bhtd->bhgsd", probs, v.float())
    return out.reshape(B, Hq, S, D).to(q.dtype), lse.reshape(B, Hq, S)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True,
                            sm_scale: Optional[float] = None,
                            q_offset: Optional[int] = None):
    """What the flash-attention backward kernel returns: ``(dq, dk, dv)`` of
    ``flash_attention_fwd_ref``'s out against ``dout``, in the operands'
    dtypes, by the flash formulas in f32: P = exp(S - lse) from the saved
    ``lse``, delta = rowsum(dout * out) from the saved ``out``,
    dS = P (dP - delta), and dk, dv summed over each kv head's group of q
    heads."""
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    if q_offset is None:
        q_offset = T - S
    qf = q.float().reshape(B, Hkv, G, S, D)
    kf, vf = k.float(), v.float()
    do = dout.float().reshape(B, Hkv, G, S, D)
    logits = _gqa_logits(q, k, scale)
    if causal:
        if q_offset < 0:
            raise ValueError(f"causal attention needs q_offset >= 0, got {q_offset}")
        logits = logits.masked_fill(~_causal_mask(S, T, q_offset, q.device), float("-inf"))
    p = torch.exp(logits - lse.float().reshape(B, Hkv, G, S)[..., None])
    delta = (do * out.float().reshape(B, Hkv, G, S, D)).sum(-1)
    dv = torch.einsum("bhgst,bhgsd->bhtd", p, do)
    dp = torch.einsum("bhgsd,bhtd->bhgst", do, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhgst,bhtd->bhgsd", ds, kf) * scale
    dk = torch.einsum("bhgst,bhgsd->bhtd", ds, qf) * scale
    return dq.reshape(B, Hq, S, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Reference RMSNorm over the last dim."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def ssd_scan(x, dt, A, Bm, C, D=None, *, init_state=None, return_state: bool = False):
    """Reference Mamba-2 SSD recurrence, a sequential scan over time:

        h_t = exp(A * dt_t) * h_{t-1} + dt_t * x_t (outer) B_t
        y_t = h_t . C_t + D * x_t

    x ``(B, S, H, P)``, dt ``(B, S, H)`` (already softplus'd), A ``(H,)``
    (negative), Bm/C ``(B, S, N)``, D ``(H,)`` or None, init_state
    ``(B, H, P, N)`` or None (zeros). Math in f32; y cast back to x's dtype,
    the final state ``(B, H, P, N)`` f32 when ``return_state``."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    xf, dtf, Bf, Cf, Af = x.float(), dt.float(), Bm.float(), C.float(), A.float()
    h = (init_state.float() if init_state is not None
         else torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device))
    y, h = scan_steps(xf, dtf, Af, Bf, Cf, h)
    if D is not None:
        y = y + D.float()[None, None, :, None] * xf
    y = y.to(x.dtype)
    if return_state:
        return y, h
    return y


def scan_step(xf, dtf, Af, Bf, Cf, h, t: int):
    """Step t of the recurrence from state h: ``(h_t, y_t (B, H, P))``, f32."""
    decay = torch.exp(Af[None, :] * dtf[:, t])  # (B, H)
    dx = dtf[:, t, :, None] * xf[:, t]  # (B, H, P)
    h = h * decay[..., None, None] + dx[..., None] * Bf[:, t, None, None, :]
    return h, torch.einsum("bhpn,bn->bhp", h, Cf[:, t])


def _scan_steps(xf, dtf, Af, Bf, Cf, h):
    """The S steps of the recurrence from state h, one after another:
    ``(y (B, S, H, P), the last state)``, f32."""
    ys = []
    for t in range(xf.shape[1]):
        h, y = scan_step(xf, dtf, Af, Bf, Cf, h, t)
        ys.append(y)
    return torch.stack(ys, dim=1), h


# What ssd_scan runs its steps with. The dry-run's op accountant
# (launch/op_account.py) puts a counted loop in its place while it is active,
# which traces fake tensors in a few steps instead of S; real tensors always
# take the loop above.
scan_steps = _scan_steps
