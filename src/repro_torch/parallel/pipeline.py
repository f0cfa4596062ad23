"""GPipe pipeline parallelism over a "stage" mesh dim: the counterpart of
``repro/parallel/pipeline.py``.

The JAX package runs every stage in SPMD under ``shard_map`` and streams
microbatches with ``ppermute``; here every rank of the stage dim runs the same
tick loop eagerly:

  tick t (of K + P - 1):
    stage 0 injects microbatch t (while t < K),
    every stage applies its local layer chunk,
    activations rotate one stage forward (send to the next stage, receive
    from the previous one),
    the last stage emits microbatch t - (P - 1).

A final sum broadcasts the last stage's outputs to every stage. Both
collectives are autograd Functions, so the pipeline is differentiable: the
rotation's backward rotates the cotangents one stage back, and the sum's is
that of ``shard_map`` for an output replicated over the axis (``out_specs=P()``):
the cotangents summed over the stages and divided by their count, which is
each stage's own cotangent when every stage computes the same loss.
``torch.distributed.nn.functional.all_reduce`` would sum without the division
and give each stage P times its gradient.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _send_recv(x: torch.Tensor, group, to: int, frm: int) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, to, group),
                                       dist.P2POp(dist.irecv, out, frm, group)]):
        req.wait()
    return out


class _Rotate(torch.autograd.Function):
    """``ppermute`` one stage on: forward sends to ``nxt`` and receives from
    ``prv`` (global ranks), backward the reverse."""

    @staticmethod
    def forward(ctx, x, group, nxt, prv):
        ctx.group, ctx.nxt, ctx.prv = group, nxt, prv
        return _send_recv(x, group, nxt, prv)

    @staticmethod
    def backward(ctx, g):
        return _send_recv(g, ctx.group, ctx.prv, ctx.nxt), None, None, None


class _ReplicatedSum(torch.autograd.Function):
    """``psum`` over the stages of an output replicated over them: the
    cotangents' mean flows back (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g / ctx.n, None, None


def gpipe_spmd(apply_stage: Callable, mesh: DeviceMesh, axis_name: str = "stage"):
    """Returns ``run(stage_params_local, x (K, mbs, ...)) -> y (K, mbs, ...)``,
    to be called on every rank of ``mesh``'s ``axis_name`` dim, each with its
    own stage's params (a leading singleton stage dim on every leaf)."""
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis_name))
    group = mesh.get_group(axis_name)
    stage = mesh.get_local_rank(axis_name)
    nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
    prv = dist.get_global_rank(group, (stage - 1) % n_stages)

    def rotate(h: torch.Tensor) -> torch.Tensor:
        # one stage rotates onto itself: the identity, and no send to itself
        return h if n_stages == 1 else _Rotate.apply(h, group, nxt, prv)

    def run(stage_params, x: torch.Tensor) -> torch.Tensor:
        stage_params = _tree_map(lambda p: p[0], stage_params)
        K = x.shape[0]
        first = torch.tensor(stage == 0, device=x.device)
        last = torch.tensor(stage == n_stages - 1, device=x.device)
        buf = torch.zeros_like(x[0])
        outs = [None] * K
        for t in range(K + n_stages - 1):
            # selects, as the JAX package's jnp.where: every stage keeps the
            # received buf and its own outputs in its autograd graph, so the
            # backward runs every rotation on every stage, tick for tick
            h_in = torch.where(first, x[min(t, K - 1)], buf)
            h_out = apply_stage(stage_params, h_in)
            if 0 <= t - (n_stages - 1) < K:
                outs[t - (n_stages - 1)] = h_out
            if t < K + n_stages - 2:  # the last tick's rotation reaches no stage's output
                buf = rotate(h_out)
        y = torch.stack(outs)
        return _ReplicatedSum.apply(torch.where(last, y, torch.zeros_like(y)), group, n_stages)

    return run


def pipeline_apply(
    mesh: DeviceMesh,
    apply_stage: Callable,
    stage_params,  # tree, leading dim = n_stages on every leaf, the same on every rank
    x: torch.Tensor,  # (K, mbs, ...) microbatched input, the same on every rank
    *,
    axis_name: str = "stage",
) -> torch.Tensor:
    """Every rank applies its own stage's slice of ``stage_params`` (as
    ``shard_map``'s ``P(axis_name)`` hands it); the output is the same on
    every rank."""
    stage = mesh.get_local_rank(axis_name)
    local = _tree_map(lambda p: p[stage:stage + 1], stage_params)
    return gpipe_spmd(apply_stage, mesh, axis_name)(local, x)


def stack_for_stages(layer_stack, n_stages: int):
    """(L, ...) stacked layer params -> (n_stages, L/n_stages, ...)."""

    def reshape(x):
        L = x.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} stages")
        return x.reshape((n_stages, L // n_stages) + tuple(x.shape[1:]))

    return _tree_map(reshape, layer_stack)
