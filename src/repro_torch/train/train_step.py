"""Train-step factory: microbatched grad accumulation + AdamW, the
counterpart of ``repro/train/train_step.py``.

One Astra strategy maps to one ``TrainStepCfg``: micro_batch_size /
num_microbatches -> the accumulation loop, recompute_granularity ->
``ModelCfg.remat``, use_distributed_optimizer -> ``ShardingPlan.fsdp``, bf16
grad accumulation -> ``accum_dtype``.

Params, optimizer state and batch may be DTensors (``repro_torch.parallel``):
the grads, which come back as DTensor's propagation leaves them (partial sums
over "data" and "model"), are redistributed to their params' placements (the
reduce-scatter GSPMD inserts) before they are accumulated and handed to
AdamW.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch import spans
from repro_torch.core.arch import ModelArch
from repro_torch.models.lm import ModelCfg, cast_params, forward_train
from repro_torch.parallel.sharding import P, axis_sizes, placements
from repro_torch.train.optimizer import OptState, adamw_update, cosine_schedule


@dataclasses.dataclass(frozen=True)
class TrainStepCfg:
    num_microbatches: int = 1
    base_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    accum_dtype: torch.dtype = torch.float32  # bf16 => compressed accumulation
    # mesh axes sharding the batch dim: with grad accumulation the reshape
    # (GB, ...) -> (K, GB/K, ...) keeps dim 1 (not K) sharded over them
    batch_axes: tuple = ()
    # cast the f32 master weights to the compute dtype once per step instead
    # of in every microbatch's forward; grads are taken with respect to the
    # cast weights and widened back to f32
    pre_cast: bool = False


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _unflatten(tree, leaves):
    """``tree``'s structure with the leaves taken in ``_leaves`` order from
    the iterator ``leaves``. Module-level: a recursive closure would hold the
    iterator, and with it every leaf, in a reference cycle that outlives the
    step (11 GB of grads at the full-width train step on the card)."""
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves) for k, v in tree.items()}
    return next(leaves)


def make_train_step(arch: ModelArch, model_cfg: ModelCfg, cfg: TrainStepCfg) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``. ``batch["tokens"]``: (global_batch, seq); K microbatches are
    the K consecutive slices of global_batch / K rows. The params and the
    optimizer state are updated in place and returned."""
    lr = cosine_schedule(cfg.base_lr, cfg.warmup_steps, cfg.total_steps)
    fwd_cfg = (dataclasses.replace(model_cfg, cast_params_in_forward=False)
               if cfg.pre_cast else model_cfg)
    steps = itertools.count()

    def value_and_grad(fwd_params: dict, batch: dict):
        inputs = [t.detach().requires_grad_() for t in _leaves(fwd_params)]
        on_card = batch["tokens"].is_cuda
        with spans.span("train.forward", device=on_card):
            loss, metrics = forward_train(_unflatten(fwd_params, iter(inputs)), arch, fwd_cfg,
                                          batch)
        with spans.span("train.backward", device=on_card):
            grads = [g.redistribute(t.device_mesh, t.placements) if isinstance(g, DTensor)
                     else g for g, t in zip(torch.autograd.grad(loss, inputs), inputs)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def split(x, K: int):
        """The K microbatches of a batch leaf: consecutive row slices. A
        DTensor is reshaped to (K, GB/K, ...) with dim 1 over ``batch_axes``,
        as the JAX step pins it, and its microbatches are the slices of dim 0.
        A microbatch that the batch axes do not divide stays whole over
        them, every batch rank running all its rows (where the JAX step's
        constraint leaves GSPMD to place it): its ranks would otherwise hold
        blocks of unequal size, which DTensor cannot flatten in the model's
        first product. So does a one-row microbatch (one data replica): a
        sharded dim of size 1 is one DTensor's views cannot merge into the
        next."""
        n = x.shape[0] // K
        if not isinstance(x, DTensor):
            return [x[i * n:(i + 1) * n] for i in range(K)]
        y = x.reshape((K, n) + tuple(x.shape[1:]))
        mesh = y.device_mesh
        ranks = 1
        if cfg.batch_axes:  # a batch axis the mesh lacks is refused here
            pinned = placements(mesh, P(None, cfg.batch_axes, *([None] * (y.dim() - 2))))
            ranks = math.prod(axis_sizes(mesh)[a] for a in cfg.batch_axes)
        if n == 1 or n % ranks:
            y = y.redistribute(mesh, placements(mesh, P()))
        elif cfg.batch_axes:
            y = y.redistribute(mesh, pinned)
        return [y[i] for i in range(K)]

    def train_step(params: dict, opt_state: OptState, batch: dict):
        with spans.span("train.step", ident=next(steps)):
            return one_step(params, opt_state, batch)

    def one_step(params: dict, opt_state: OptState, batch: dict):
        K = cfg.num_microbatches
        if cfg.pre_cast:
            with torch.no_grad():
                fwd_params = cast_params(params, model_cfg.dtype)
        else:
            fwd_params = params
        if K == 1:
            loss, metrics, grads = value_and_grad(fwd_params, batch)
            if cfg.pre_cast:
                grads = [g.float() for g in grads]
        else:
            micro = {k: split(x, K) for k, x in batch.items()}
            g_sum, l_sum = None, 0.0
            for i in range(K):
                l, _, g = value_and_grad(fwd_params, {k: x[i] for k, x in micro.items()})
                if g_sum is None:
                    g_sum = [gi.to(cfg.accum_dtype) for gi in g]
                else:
                    for a, b in zip(g_sum, g):
                        a.add_(b.to(cfg.accum_dtype))
                l_sum = l_sum + l
                del g
            grads = [(g / K).float() for g in g_sum]
            del g_sum
            loss = l_sum / K
            metrics = {"loss": loss}
        # through the module's global, which the benchmark's train driver wraps
        with spans.span("train.optimizer", device=batch["tokens"].is_cuda):
            params, opt_state, opt_metrics = adamw_update(
                params, _unflatten(params, iter(grads)), opt_state,
                lr=lr, weight_decay=cfg.weight_decay, clip_norm=cfg.clip_norm)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step
