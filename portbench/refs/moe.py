"""The plain reference of a mixture-of-experts layer in an LM's MLP place
(granite-moe's), and its load-balancing term.

Plain PyTorch in float32, from the sizes of a ``Shape``; it imports nothing
of the program, and ``q_ops`` rounds the operands of each product as
``refs/lm.py`` does (the fp8 control).

  * routing: the router's logits (T, E) and each token's top k experts, its
    gates a softmax over those k logits. Where the benchmark hands it the
    experts a run chose (``Routing.given``), the layer takes those, with the
    gates still a softmax over its own logits at them;
  * capacity: each expert has C = int(T k cf / E) slots (at least one),
    given to its assignments in token order; an assignment past C is
    dropped and contributes nothing;
  * experts: SwiGLU, ``wi`` (E, d, 2F) with the gate's F columns before the
    up's, ``wo`` (E, F, d); a token's output is the sum of its kept
    assignments' outputs, each times its gate;
  * the load-balancing term: sum_e f_e P_e E / k from layer 0's router over
    the embedded tokens, f_e the share of the assignments that go to e
    (times k), P_e the mean router probability of e.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass
class Routing:
    """The mixture's options for one pass of the reference, and what the
    layers read of the routing. ``given``: per step, each layer's (T, k)
    experts that a run chose, in the order of its calls (None: the layers
    route themselves). ``reads``: per step, each layer's ``read`` of
    :func:`layer`."""

    capacity_factor: float
    aux_weight: float
    given: list | None = None
    reads: list = dataclasses.field(default_factory=list)

    def start_step(self) -> None:
        self.reads.append({})

    def choices(self, i: int):
        return None if self.given is None else self.given[len(self.reads) - 1][i]

    def summary(self) -> dict:
        """Over every step and layer: ``gap``, the widest of :func:`layer`'s
        per-token gaps; ``differed``, the share of token-layers whose given
        experts are not the reference's own top k; ``dropped``, the share of
        assignments past their expert's capacity."""
        reads = [r for step in self.reads for r in step.values()]
        tokens = sum(r["tokens"] for r in reads)
        return {"gap": max(float(r["gap"]) for r in reads),
                "differed": sum(int(r["differed"]) for r in reads) / tokens,
                "dropped": sum(int(r["dropped"]) for r in reads) / (tokens * reads[0]["k"])}


def slots(chosen: torch.Tensor, experts: int) -> torch.Tensor:
    """Each assignment's place among the assignments to its expert, in
    token order: (T, k) from the experts ``chosen`` (T, k), distinct in a
    row."""
    flat = chosen.reshape(-1)
    hot = torch.zeros(flat.shape[0], experts, dtype=torch.int64, device=flat.device)
    hot.scatter_(1, flat[:, None], 1)
    return ((hot.cumsum(0) * hot).sum(-1) - 1).reshape(chosen.shape)


def layer(x, lw: dict, s, q_ops, capacity_factor: float, given=None):
    """The layer on x (B, S, d), the norm's output, with ``lw`` its
    ``router``, ``wi`` and ``wo``: ``(y (B, S, d), read)``. ``read`` (no
    grad): ``gap``, the widest over tokens of the reference's k-th largest
    logit less its logit of the lowest-ranked given expert, over the spread
    (standard deviation) of the token's logits, 0 where the given experts
    are its own; the counts ``differed`` and ``dropped``."""
    B, S, d = x.shape
    T, E, k = B * S, s.experts, s.top_k
    xt = x.reshape(T, d)
    logits = q_ops(xt) @ q_ops(lw["router"])
    own = torch.topk(logits.detach(), k, dim=-1)
    chosen = own.indices if given is None else given.long()
    gates = torch.softmax(logits.gather(-1, chosen), dim=-1)
    C = max(int(T * k * capacity_factor / E), 1)
    pos = slots(chosen, E).reshape(-1)
    flat = chosen.reshape(-1)
    kept = pos < C
    token = torch.arange(T, device=x.device).repeat_interleave(k)
    buf = xt.new_zeros(E, C, d).index_put((flat[kept], pos[kept]), xt[token[kept]])
    gate, up = (q_ops(buf) @ q_ops(lw["wi"])).chunk(2, dim=-1)
    out = q_ops(F.silu(gate) * up) @ q_ops(lw["wo"])  # (E, C, d)
    per = out[flat, pos.clamp(max=C - 1)] * kept[:, None]
    y = (per * gates.reshape(-1, 1)).reshape(T, k, d).sum(1)
    with torch.no_grad():
        lg = logits.detach()
        low = lg.gather(-1, chosen).min(-1).values
        read = {"gap": ((own.values[:, -1] - low) / lg.std(-1)).max(),
                "differed": (own.indices.sort(-1).values != chosen.sort(-1).values).any(-1).sum(),
                "dropped": (~kept).sum(), "tokens": T, "k": k}
    return y.reshape(B, S, d), read


def aux_loss(x, router, s, q_ops):
    """The load-balancing term of ``router`` (d, E) over the embedded tokens
    x (B, S, d)."""
    E, k = s.experts, s.top_k
    logits = q_ops(x.reshape(-1, x.shape[-1])) @ q_ops(router)
    T = logits.shape[0]
    chosen = torch.topk(logits.detach(), k, dim=-1).indices.reshape(-1)
    frac = torch.zeros(E, device=x.device).index_add_(
        0, chosen, torch.ones(chosen.shape, device=x.device)) / T
    return (frac * torch.softmax(logits, dim=-1).mean(0)).sum() * E / k
