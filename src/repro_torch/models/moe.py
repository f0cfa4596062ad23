"""Mixture-of-Experts with sort-based capacity dispatch (counterpart of
``repro/models/moe.py``): the "dropping" MoE.

  1. route: each token's top-k experts from f32 router logits, the gates a
     softmax over those k logits;
  2. sort the token-assignments stably by expert id;
  3. give each assignment one of C capacity slots of its expert, in sorted
     order; those past C go to the drop slot and contribute nothing;
  4. one grouped product over the (E, C, d) buffer against the stacked
     expert weights (E, d, 2F) and (E, F, d);
  5. put the results back, weighted by the gates, summed over each token's
     k assignments, and add the optional shared expert.

Plain PyTorch, as the JAX package computes it outside any Pallas kernel. The
assignments to each expert are counted with a static shape
(``expert_counts``), so nothing on the path reads a value back to the host.
Steps 3 and 5 run through two integer maps (``_maps``): each assignment's
slot and each slot's assignment. Every kept slot holds one assignment and
every assignment one slot at most, so the backward of each step is a gather
through the other map (``_Dispatch``, ``_Combine``): no index backward, no
accumulation, and no cost that grows with the drops.

Sharded (params and x as DTensors, placed by ``repro_torch.parallel``), the
block is still the global program: C comes from the global token count, and
an assignment is kept when its position among all the assignments to its
expert, in the global token order, is below C. Each rank routes its own rows
(x's rows lie over the batch axes, row-major as ``batch_spec`` places them),
gathers every rank's per-expert counts, and places its assignments at their
global positions: the counts of the ranks before it plus its own position.
Then, through ``local_apply``:

  * experts over "data" (the rules' expert parallelism): each rank writes its
    kept rows into an (E, C, d) buffer at their global slots, zeros
    elsewhere; a sum reduce-scatter over "data" along E hands each owner its
    experts' whole (E/dp, C, d) (the ranks' slots are disjoint: the sum adds
    zeros), summed over "pod" too, whose ranks hold the same experts; the
    products come back by an all-gather along E;
  * experts whole over "data": each rank multiplies its own kept rows, at
    most min(C, its tokens) of an expert, in an (E, min(C, T_rank), d)
    buffer; the only collective is the gather of the counts.

The F of ``wi``'s 2F columns is cut contiguously over "model", so a rank's
columns are not pairs of gate and up: the product is gathered over "model"
and each rank takes the gate and up columns of its F / tp, multiplies them
with its rows of ``wo``, and its output is a partial sum over "model"; the
shared expert, replicated, runs on the same F / tp of its columns.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import spans
from repro_torch.parallel.sharding import (BATCH_AXES, MODEL_AXIS, batch_groups,
                                           constrain_batch_sharding, gather_over, gather_rows,
                                           local_apply, row_block, sum_over, sum_scatter_over)


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


def expert_counts(experts: torch.Tensor, num_experts: int) -> torch.Tensor:
    """The assignments to each expert, (E,) int64: ``bincount``'s integers
    with a static shape (bincount's shape depends on the data, which reads
    its largest id back to the host and cannot run on a fake tensor)."""
    flat = experts.reshape(-1)
    return torch.zeros(num_experts, dtype=torch.long, device=flat.device).index_add_(
        0, flat, torch.ones_like(flat))


def sorted_slots(experts: torch.Tensor, counts: torch.Tensor, before=None):
    """The assignments ``experts`` (T, k), token-major, sorted stably by
    expert: the permutation, each sorted assignment's expert, its position
    among these assignments to its expert, and its global position: that
    plus ``before[e]``, the assignments to e ahead of these in the global
    order (None: none)."""
    flat = experts.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    e_sorted = flat[order]
    starts = torch.cumsum(counts, 0) - counts
    local = torch.arange(flat.shape[0], device=flat.device) - starts[e_sorted]
    return order, e_sorted, local, local if before is None else local + before[e_sorted]


def global_route(router: torch.Tensor, xt: torch.Tensor, top_k: int,
                 capacity_factor: float, tokens: int, groups=(), model=None):
    """This rank's part of the global dispatch: its tokens ``xt`` (T_r, d)
    are the rank's block of the global order over ``groups``
    (``sharding.batch_groups``; () for the whole batch on one rank), of
    ``tokens`` in all. Returns ``(order, e_sorted, local_pos, pos, t_sorted,
    g_sorted, C)``: the sorted assignments' permutation, experts, positions
    among the rank's own and among all assignments to their expert, tokens
    and gates; C from ``tokens``, whatever share of them this rank holds (a
    batch the ranks do not divide leaves them blocks of unequal size). An
    assignment is kept where ``pos < C``. The tuple's ``gates`` holds the
    gates token-major (T_r, k).

    ``model`` (m, tp, group): the ranks of "model" hold the same tokens;
    where tp divides T_r, rank m routes the m-th T_r / tp of them and the
    choices are gathered over ``group``, so that no rank runs the router on
    every token."""
    T_r = xt.shape[0]
    E = router.shape[-1]
    m, tp, model_group = model or (0, 1, None)
    if tp > 1 and T_r % tp == 0:
        n = T_r // tp
        gates, experts = select({"router": router}, xt[m * n:(m + 1) * n], top_k)
        gates, experts = gather_over(gates, 0, model_group), gather_over(experts, 0, model_group)
    else:
        gates, experts = select({"router": router}, xt, top_k)
    counts = expert_counts(experts, E)
    before = None
    if groups:
        with torch.no_grad():
            every = gather_rows(counts, groups)  # (ranks, E)
            before = every[:row_block(groups)].sum(0)
    C = capacity(tokens, top_k, capacity_factor, E)
    order, e_sorted, local, pos = sorted_slots(experts, counts, before)
    t_sorted = torch.arange(T_r, device=xt.device).repeat_interleave(top_k)[order]
    return _Route((order, e_sorted, local, pos, t_sorted, gates.reshape(-1)[order], C), gates)


class _Route(tuple):
    """``global_route``'s 7-tuple with the gates token-major beside it: the
    dispatch takes them so, which leaves the sorted gates, and the index
    backward of their permutation, off its graph."""

    def __new__(cls, fields, gates):
        out = super().__new__(cls, fields)
        out.gates = gates
        return out


def _maps(order, dest, top_k: int, rows: int):
    """The dispatch's two maps, from the sorted assignments' permutation
    ``order`` and their slots ``dest`` (``rows`` where dropped): ``slot``
    (T, top_k), each token-major assignment's slot, ``rows`` where dropped;
    ``assign`` (rows,), the token-major assignment t * top_k + j in each
    slot, T * top_k where the slot is empty. Static shapes, no read back to
    the host. Row ``rows`` of ``assign``'s buffer is the drop slot: every
    dropped assignment writes it, and it is cut off, so which write lands
    there does not matter."""
    with torch.no_grad():
        n = order.shape[0]
        slot = torch.empty_like(dest).scatter_(0, order, dest).view(-1, top_k)
        assign = torch.full((rows + 1,), n, dtype=order.dtype, device=order.device)
        return slot, assign.scatter_(0, dest, order)[:rows]


def _rows_at(src, index):
    """src's rows (n, d) at ``index`` (any shape), zero rows where the index
    is a map's sentinel (n or past it): ``index.shape + (d,)``. A gather,
    whatever the index holds; no sum, so no order to keep."""
    n, d = src.shape
    flat = index.reshape(-1)
    rows = src.index_select(0, flat.clamp(max=n - 1))
    return rows.masked_fill_(flat.ge(n).unsqueeze(1), 0).view(*index.shape, d)


class _Dispatch(torch.autograd.Function):
    """The tokens' rows ``xt`` (T, d) at their slots: (rows, d), the row of
    token ``assign[s] // top_k`` in slot s, zeros in the empty ones. The
    backward gathers each token's k slots through ``slot`` (T, top_k) and
    sums them in a fixed order; a dropped assignment adds nothing. No
    atomic adds, whose order on a card would change the last bits from run
    to run, and no sort of the indices."""

    @staticmethod
    def forward(ctx, xt, slot, assign):
        ctx.save_for_backward(slot)
        return _rows_at(xt, assign // slot.shape[1])

    @staticmethod
    def backward(ctx, g):
        (slot,) = ctx.saved_tensors
        with spans.span("moe.dispatch_backward", device=g.is_cuda):
            return _rows_at(g, slot).sum(dim=1), None, None


class _Combine(torch.autograd.Function):
    """Each token's k product rows ``out_flat[slot[t, j]]`` times their
    gates (T, top_k), summed over k in a fixed order: (T, d); a dropped
    assignment adds nothing. The JAX package scatter-adds them. The
    backward gathers too: a slot's grad is its token's grad times its
    assignment's gate (through ``assign``), a gate's grad its row's product
    with its token's grad, summed over d."""

    @staticmethod
    def forward(ctx, out_flat, gates, slot, assign):
        rows = _rows_at(out_flat, slot)  # (T, k, d)
        ctx.save_for_backward(rows, gates, assign)
        return (rows * gates.unsqueeze(-1)).sum(dim=1)

    @staticmethod
    def backward(ctx, g):
        rows, gates, assign = ctx.saved_tensors
        with spans.span("moe.dispatch_backward", device=g.is_cuda):
            flat = gates.reshape(-1)
            gate = flat.index_select(0, assign.clamp(max=flat.shape[0] - 1))
            grad_out = _rows_at(g, assign // gates.shape[1]) * gate.unsqueeze(1)
            grad_gates = (rows * g.unsqueeze(1)).sum(dim=-1)
        return grad_out, grad_gates, None, None


def _experts(grouped, wi, wo, part=(0, 1), model_group=None):
    """The grouped products over ``grouped`` (E', C', d). ``part`` (m, tp):
    wi holds the m-th contiguous block of the 2F columns and wo the m-th of
    the F rows; the product is gathered over ``model_group`` and the gate
    and up columns of the m-th F / tp taken, so the result is this rank's
    partial sum over "model"."""
    gate_up = gather_over(torch.bmm(grouped, wi), 2, model_group)
    m, tp = part
    Fh = gate_up.shape[-1] // 2
    f = Fh // tp
    g_act, up = gate_up[..., m * f:(m + 1) * f], gate_up[..., Fh + m * f:Fh + (m + 1) * f]
    return torch.bmm(F.silu(g_act) * up, wo)


def _shared(xt, wi, wo, part=(0, 1)):
    """The shared expert on the m-th F / tp of its hidden units (``part``
    (m, tp)): a partial sum over "model" where tp > 1."""
    m, tp = part
    if tp > 1:
        Fh = wo.shape[0]
        f = Fh // tp
        wi = torch.cat([wi[:, m * f:(m + 1) * f], wi[:, Fh + m * f:Fh + (m + 1) * f]], dim=1)
        wo = wo[m * f:(m + 1) * f]
    g_act, up = (xt @ wi).chunk(2, dim=-1)
    return (F.silu(g_act) * up) @ wo


class _Ranks(NamedTuple):
    """Where one rank's dispatch talks to the others: the batch groups its
    rows lie over (``sharding.batch_groups``), its part (m, tp) of "model"
    and that group, and whether the experts lie over "data" (``split``),
    with the "data" and "pod" groups that sum their slots (None: one rank).
    The default is the whole batch on one rank."""
    groups: tuple = ()
    part: tuple = (0, 1)
    model_group: Any = None
    split: bool = True
    data_group: Any = None
    pod_group: Any = None


def _dispatch(xt, router, wi, wo, shared, *, top_k: int, capacity_factor: float,
              tokens: int, ranks: _Ranks = _Ranks()) -> torch.Tensor:
    """The block on one rank's tokens ``xt`` (T_r, d), ``tokens`` in the
    global batch: route, place the kept assignments at their slots, the
    grouped products, back in token order, plus the shared expert
    (``shared``: its (wi, wo), or ()). On one rank the slots are (E, C, d);
    across ranks, the two layouts of the module docstring."""
    T_r, d = xt.shape
    E = router.shape[-1]
    m, tp = ranks.part
    route = global_route(router, xt, top_k, capacity_factor, tokens, ranks.groups,
                         (m, tp, ranks.model_group))
    order, e_sorted, local_pos, pos, _, _, C = route
    # experts over "data": the global slots, which their owners multiply;
    # else this rank's own kept rows, at most min(C, T_r) an expert
    cap, at = (C, pos) if ranks.split else (min(C, T_r), local_pos)
    rows = E * cap
    slot, assign = _maps(order, torch.where(pos < C, e_sorted * cap + at, rows), top_k, rows)
    grouped = _Dispatch.apply(xt, slot, assign).reshape(E, cap, d)
    if ranks.split:
        grouped = sum_over(sum_scatter_over(grouped, 0, ranks.data_group), ranks.pod_group)
        out = gather_over(_experts(grouped, wi, wo, ranks.part, ranks.model_group), 0,
                          ranks.data_group)
    else:
        out = _experts(grouped, wi, wo, ranks.part, ranks.model_group)
    y = _Combine.apply(out.reshape(-1, d), route.gates, slot, assign)
    if shared:
        y = y + _shared(xt, *shared, ranks.part)
    return y


def moe_block(p: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25) -> torch.Tensor:
    """p: router (d, E), wi (E, d, 2F), wo (E, F, d), optionally shared_wi
    (d, 2F) and shared_wo (F, d). x: (B, S, d); returns (B, S, d). On
    DTensors, see the module docstring."""
    if isinstance(x, DTensor):
        return _sharded_moe_block(p, x, top_k, capacity_factor)
    B, S, d = x.shape
    shared = (p["shared_wi"], p["shared_wo"]) if "shared_wi" in p else ()
    y = _dispatch(x.reshape(B * S, d), p["router"], p["wi"], p["wo"], shared, top_k=top_k,
                  capacity_factor=capacity_factor, tokens=B * S)
    return y.reshape(B, S, d)


def _rows_over_batch(x):
    """x with its rows pinned over the batch axes of more than one rank
    where they divide them (``constrain_batch_sharding``), and which of
    those mesh dims split them: a dim 0 they do not divide (an uneven
    microbatch) stays whole there, every rank of those dims holding the same
    rows, which the dispatch then routes as one group (its counts gathered
    from no other rank)."""
    mesh = x.device_mesh
    batch = [name for name, n in zip(mesh.mesh_dim_names, mesh.shape)
             if name in BATCH_AXES and n > 1]
    if any(x.placements[mesh.mesh_dim_names.index(a)] != Shard(0) for a in batch):
        x = constrain_batch_sharding(x)
    return x, {a for a in batch if x.placements[mesh.mesh_dim_names.index(a)] == Shard(0)}


def _sharded_moe_block(p: dict, x, top_k: int, capacity_factor: float):
    """``moe_block`` on DTensors (module docstring). x's rows lie over the
    batch axes, whole over "model"; the output is a partial sum over
    "model". C comes from x's global B x S, whatever block of rows each rank
    holds. Grads: x's a partial sum over "model"; the router's and the
    shared expert's partial sums everywhere; the experts' split as they are,
    partial sums over the batch dims that do not split them. Over a batch
    dim that does not split x's rows (``_rows_over_batch``) every rank runs
    the same block on the same rows: x, the weights (the experts gathered
    whole there) and the output are replicated, and so are their grads."""
    x, split_rows = _rows_over_batch(x)
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    B, S, d = x.shape
    E = p["router"].shape[-1]
    Fh = p["wo"].shape[1]
    groups = [g for g in batch_groups(mesh) if g[0] in split_rows]
    shared = ("shared_wi", "shared_wo") if "shared_wi" in p else ()
    tp = dict(zip(names, mesh.shape)).get(MODEL_AXIS, 1)
    m = mesh.get_local_rank(MODEL_AXIS) if tp > 1 else 0
    model_group = mesh.get_group(MODEL_AXIS) if tp > 1 else None
    if tp > 1 and Fh % tp:
        raise NotImplementedError(f"the sharded MoE takes F ({Fh}) split over \"model\" "
                                  f"({tp} ranks)")
    split = ("data" in names and p["wi"].placements[names.index("data")] == Shard(0)
             and (mesh.shape[names.index("data")] == 1 or "data" in split_rows))

    # per mesh dim: x, router, wi, wo, shared, y; and the grads of the inputs
    px, pr, pi, po, ps, py = [], [], [], [], [], []
    gx, gr, gi, go, gs = [], [], [], [], []
    for i, (name, n) in enumerate(zip(names, mesh.shape)):
        wi_p, wo_p = p["wi"].placements[i], p["wo"].placements[i]
        if n == 1:
            places = (x.placements[i], Replicate(), wi_p, wo_p, Replicate(), x.placements[i])
            grads = places[:5]
        elif name == MODEL_AXIS:
            if (wi_p, wo_p) != (Shard(2), Shard(1)):
                raise NotImplementedError(f"the sharded MoE takes wi's 2F and wo's F over "
                                          f"\"model\", not {wi_p}, {wo_p}")
            places = (Replicate(), Replicate(), Shard(2), Shard(1), Replicate(), Partial())
            grads = (Partial(), Partial(), Shard(2), Shard(1), Partial())
        elif name in BATCH_AXES and name not in split_rows:
            places = (Replicate(),) * 6
            grads = places[:5]
        elif name in BATCH_AXES:
            experts = Shard(0) if name == "data" and split else Replicate()
            places = (Shard(0), Replicate(), experts, experts, Replicate(), Shard(0))
            grads = (Shard(0), Partial(),
                     *((experts, experts) if split and name == "data" else (Partial(),) * 2),
                     Partial())
        else:
            raise NotImplementedError(f"the sharded MoE has no rule for mesh dim {name!r}")
        for out, place in zip((px, pr, pi, po, ps, py), places):
            out.append(place)
        for out, place in zip((gx, gr, gi, go, gs), grads):
            out.append(place)

    data_group = mesh.get_group("data") if split and mesh.shape[names.index("data")] > 1 \
        else None
    pod_group = mesh.get_group("pod") if split and "pod" in split_rows else None

    ranks = _Ranks(tuple(groups), (m, tp), model_group, split, data_group, pod_group)

    def local(x, router, wi, wo, *shared_w):
        Br = x.shape[0]
        y = _dispatch(x.reshape(Br * S, d), router, wi, wo, shared_w, top_k=top_k,
                      capacity_factor=capacity_factor, tokens=B * S, ranks=ranks)
        return y.reshape(Br, S, d)

    args = (x, p["router"], p["wi"], p["wo"], *(p[k] for k in shared))
    ins = (px, pr, pi, po) + (ps,) * len(shared)
    grads = (gx, gr, gi, go) + (gs,) * len(shared)
    return local_apply(local, args, ins, py, grads)


def aux_load_balance_loss(p: dict, x: torch.Tensor, *, top_k: int) -> torch.Tensor:
    """Switch-style load-balancing loss: sum_e f_e * P_e * E / top_k, f_e the
    share of assignments to expert e (times top_k), P_e its mean router
    probability. On DTensors the means run over the global tokens: each
    rank's sums over its rows, divided by the global token count, summed
    over the batch axes (the ranks may hold unequal blocks of rows)."""
    E = p["router"].shape[-1]
    tokens = x.shape[0] * x.shape[1]
    if not isinstance(x, DTensor):
        frac, probs = _aux_means(x, p["router"], top_k, tokens)
        return torch.sum(frac * probs) * E / top_k
    x, split = _rows_over_batch(x)
    mesh = x.device_mesh
    px, pr, pm, gr = [], [], [], []  # x, the router, the means, the router's grad
    for name, n, place in zip(mesh.mesh_dim_names, mesh.shape, x.placements):
        split_rows = name in split
        px.append(Shard(0) if split_rows else place if n == 1 else Replicate())
        pr.append(Replicate())
        pm.append(Partial() if split_rows else Replicate())
        gr.append(Partial() if split_rows else Replicate())

    def local(x, router):
        return torch.stack(_aux_means(x, router, top_k, tokens))

    both = local_apply(local, (x, p["router"]), (px, pr), pm, (px, gr), out_shape=(2, E))
    both = both.redistribute(mesh, (Replicate(),) * mesh.ndim)
    return torch.sum(both[0] * both[1]) * E / top_k


def _aux_means(x, router, top_k: int, tokens: int):
    """Each expert's assignments and router probability summed over x's
    tokens, over ``tokens``: their means over a batch of ``tokens`` of which x
    holds a part. The assignments are counted (the JAX package sums one-hot
    rows: ``F.one_hot`` reads the ids back to the host on the CPU)."""
    d = x.shape[-1]
    logits = x.reshape(-1, d).float() @ router.float()
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    experts = torch.topk(logits, top_k, dim=-1).indices
    frac = expert_counts(experts, router.shape[-1]).float() / tokens
    return frac, probs.sum(dim=0) / tokens
