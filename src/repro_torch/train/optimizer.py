"""AdamW with f32 state, global-norm clipping and a warmup + cosine schedule:
the counterpart of ``repro/train/optimizer.py``.

Same arithmetic in the same order as the JAX package, but in place: at full
width a stacked leaf is gigabytes (qwen3-8b's ``mlp.wi`` over 8 layers is
3.2 GB in f32), and every temporary of the functional form would cost that
again. ``adamw_update`` overwrites the params, mu and nu it is given (and
returns them); it leaves the grads as they are.

Sharded params (DTensors) keep mu and nu in their placements, and take grads
in them too (``make_train_step`` redistributes the grads first): the update is
elementwise, so it runs on each rank's local shards. The global norm counts
every element once, a replicated leaf's too.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Union

import torch
from torch.distributed.tensor import DTensor


class OptState(NamedTuple):
    mu: dict
    nu: dict
    step: int


def _zip_leaves(*trees):
    """The leaves of trees of one structure, side by side, walked by the
    first tree's keys."""
    if isinstance(trees[0], dict):
        for key in trees[0]:
            yield from _zip_leaves(*(t[key] for t in trees))
    else:
        yield trees


def _zeros_like_f32(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_f32(v) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        return torch.zeros_like(tree, dtype=torch.float32)
    return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)


def adamw_init(params: dict) -> OptState:
    return OptState(mu=_zeros_like_f32(params), nu=_zeros_like_f32(params), step=0)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-dim tensor on
    the leaves' device; a plain one, the same on every rank, for DTensors).

    A DTensor leaf's sum is partial over the mesh dims that shard it. The
    leaves whose sums have the same placements are reduced together, in one
    collective, and every leaf's whole sum is then added in the leaves'
    order, as for plain tensors."""
    sums = [torch.sum(g.float() ** 2) for (g,) in _zip_leaves(tree)]
    groups: dict = {}
    for i, s in enumerate(sums):
        if isinstance(s, DTensor):
            groups.setdefault((s.device_mesh, s.placements), []).append(i)
    for (mesh, places), idx in groups.items():
        local = torch.stack([sums[i].to_local() for i in idx])
        whole = DTensor.from_local(local, mesh, places, run_check=False).full_tensor()
        for i, v in zip(idx, whole):
            sums[i] = v
    return torch.sqrt(sum(sums))


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1) -> Callable[[int], float]:
    """lr(step): linear warmup to ``base_lr``, then a cosine down to
    ``min_ratio * base_lr`` at ``total_steps``; computed in f32, as the JAX
    schedule."""

    def lr(step) -> float:
        step = _f32(float(step))
        warm = base_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return float(torch.where(step < warmup_steps, warm, cos))

    return lr


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: OptState, *,
                 lr: Union[float, Callable[[int], float]], b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1, clip_norm: float = 1.0):
    """One AdamW step on every leaf. ``lr`` is a schedule (of the step after
    the increment) or a float. Decoupled weight decay on leaves of 2 or more
    dims: the matrices, and also the norms and ssm vectors stacked over
    layers, as the JAX package's ``p.ndim >= 2``. Returns ``(params,
    OptState, {"grad_norm" (before clipping), "lr"})``."""
    step = state.step + 1
    lr_t = lr(step) if callable(lr) else lr

    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    bc1 = float(1 - b1 ** _f32(step))
    bc2 = float(1 - b2 ** _f32(step))

    for p, g, m, v in _zip_leaves(params, grads, state.mu, state.nu):
        if isinstance(p, DTensor):
            if not all(isinstance(t, DTensor) and t.placements == p.placements
                       for t in (g, m, v)):
                raise ValueError(f"adamw_update: a DTensor param in {p.placements} needs its "
                                 f"grad, mu and nu in the same placements")
            p, g, m, v = (t.to_local() for t in (p, g, m, v))
        g = g.float() * scale
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        den = torch.div(v, bc2).sqrt_().add_(eps)
        delta = torch.div(m, bc1, out=g).div_(den)  # g is spent: its buffer takes delta
        del den
        pf = p.float()
        if p.dim() >= 2:
            delta.add_(pf, alpha=weight_decay)
        pf.sub_(delta.mul_(lr_t))
        if pf is not p:
            p.copy_(pf)
    return params, OptState(mu=state.mu, nu=state.nu, step=step), {"grad_norm": gnorm,
                                                                   "lr": lr_t}
