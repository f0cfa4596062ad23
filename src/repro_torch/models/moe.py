"""Mixture-of-Experts with sort-based capacity dispatch (counterpart of
``repro/models/moe.py``): the "dropping" MoE.

  1. route: each token's top-k experts from f32 router logits, the gates a
     softmax over those k logits;
  2. sort the token-assignments stably by expert id;
  3. give each assignment one of C capacity slots of its expert, in sorted
     order; those past C go to the drop slot and contribute nothing;
  4. one grouped product over the (E, C, d) buffer against the stacked
     expert weights (E, d, 2F) and (E, F, d);
  5. scatter the results back, weighted by the gates, and add the optional
     shared expert.

Plain PyTorch, as the JAX package computes it outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def capacity(tokens: int, top_k: int, capacity_factor: float, experts: int) -> int:
    """Slots per expert, in Python floats as the JAX package computes them."""
    return max(int(tokens * top_k * capacity_factor / experts), 1)


def select(p: dict, xt: torch.Tensor, top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each token's top_k experts (T, k), from the largest router logit down
    as ``lax.top_k``, and their gates in xt's dtype: a softmax over those k
    f32 logits."""
    logits = xt.float() @ p["router"].float()  # (T, E)
    gates, experts = torch.topk(logits, top_k, dim=-1)
    return torch.softmax(gates, dim=-1).to(xt.dtype), experts


def route(p: dict, xt: torch.Tensor, top_k: int, capacity_factor: float):
    """The dispatch of tokens ``xt`` (T, d): ``(dest, token, gate)`` per
    assignment in expert order, ``dest`` the slot ``e * C + i`` it takes or
    ``E * C`` (dropped), and C."""
    T = xt.shape[0]
    E = p["router"].shape[-1]
    gates, experts = select(p, xt, top_k)
    A = T * top_k
    expert_flat = experts.reshape(A)
    token_flat = torch.arange(T, device=xt.device).repeat_interleave(top_k)
    order = torch.sort(expert_flat, stable=True).indices
    e_sorted = expert_flat[order]
    C = capacity(T, top_k, capacity_factor, E)
    counts = torch.bincount(expert_flat, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_expert = torch.arange(A, device=xt.device) - starts[e_sorted]
    dest = torch.where(pos_in_expert < C, e_sorted * C + pos_in_expert, E * C)
    return dest, token_flat[order], gates.reshape(A)[order], C


def moe_block(p: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25) -> torch.Tensor:
    """p: router (d, E), wi (E, d, 2F), wo (E, F, d), optionally shared_wi
    (d, 2F) and shared_wo (F, d). x: (B, S, d); returns (B, S, d)."""
    B, S, d = x.shape
    E = p["router"].shape[-1]
    xt = x.reshape(B * S, d)
    dest, t_sorted, g_sorted, C = route(p, xt, top_k, capacity_factor)

    # row E*C is the drop slot: several assignments may write it, and it is
    # cut off before the product, so which write lands there does not matter
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((dest,), xt[t_sorted])
    grouped = buf[:E * C].reshape(E, C, d)

    g_act, up = torch.bmm(grouped, p["wi"]).chunk(2, dim=-1)
    out_grouped = torch.bmm(F.silu(g_act) * up, p["wo"])  # (E, C, d)

    out_flat = torch.cat([out_grouped.reshape(E * C, d),
                          torch.zeros((1, d), dtype=out_grouped.dtype, device=x.device)])
    per_assignment = out_flat[dest] * g_sorted[:, None]  # dropped -> the zero row
    y = torch.zeros((B * S, d), dtype=x.dtype, device=x.device).index_add(
        0, t_sorted, per_assignment)

    if "shared_wi" in p:
        g_act, up = (xt @ p["shared_wi"]).chunk(2, dim=-1)
        y = y + (F.silu(g_act) * up) @ p["shared_wo"]
    return y.reshape(B, S, d)


def aux_load_balance_loss(p: dict, x: torch.Tensor, *, top_k: int) -> torch.Tensor:
    """Switch-style load-balancing loss: sum_e f_e * P_e * E / top_k, f_e the
    share of assignments to expert e (times top_k), P_e its mean router
    probability."""
    d = x.shape[-1]
    E = p["router"].shape[-1]
    logits = x.reshape(-1, d).float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    experts = torch.topk(logits, top_k, dim=-1).indices
    frac = F.one_hot(experts, E).float().sum(dim=1).mean(dim=0)
    return torch.sum(frac * probs.mean(dim=0)) * E / top_k
