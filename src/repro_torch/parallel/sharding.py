"""Sharding rules: Astra strategy -> placements for params, batch and caches,
the counterpart of ``repro/parallel/sharding.py`` on DTensor.

The mesh is ("data", "model") or ("pod", "data", "model") (launch/mesh.py).
An Astra :class:`ParallelStrategy` maps onto it as in the JAX package:

    data parallel        -> ("pod", "data") on the batch dim
    tensor parallel      -> "model" on heads / ffn / vocab dims
    distributed optimizer / FSDP (ZeRO-3) -> "model"-orthogonal dim of each
        large weight additionally sharded over "data"
    expert parallel      -> expert dim over "data" when divisible

The rules are the JAX package's, leaf for leaf, over the port's own
:class:`PartitionSpec`: a tuple with one entry per tensor dim, each an axis
name, a tuple of axis names (major to minor) or None. A dim that its axis does
not divide stays unsharded, so DTensor never sees an uneven shard.
:func:`named` turns specs into DTensor placements, one per mesh dim: a tensor
dim over ("pod", "data") is ``Shard(d)`` on both mesh dims, and DTensor shards
it over the mesh dims in order, pod major, as JAX does.

GSPMD's place is taken by DTensor's op propagation, which inserts the
collectives; :func:`constrain_batch_sharding` is a ``redistribute``. The mesh
in use is the one its argument lives on: a plain tensor has none, and the
constraint is the identity, as the JAX one is outside a mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.core.arch import ModelArch


BATCH_AXES = ("pod", "data")  # the mesh axes that shard the batch, major first
MODEL_AXIS = "model"  # the tensor-parallel axis


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of names, or None."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes with no devices behind it (JAX's
    ``AbstractMesh``): all that :func:`make_plan` and the rules read."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]


Mesh = Union[DeviceMesh, MeshShape]


def axis_sizes(mesh: Mesh) -> dict[str, int]:
    """Axis name -> size, in the mesh's order."""
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.axis_names, mesh.axis_sizes))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Resolved axis names + toggles for one (mesh, strategy) pair."""

    mesh: Mesh
    batch_axes: tuple[str, ...]  # axes sharding the batch dim
    model_axis: Optional[str]  # tensor-parallel axis
    fsdp: bool  # shard weights/opt-state over the data axis too

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(axis_sizes(self.mesh))

    @property
    def data_axis(self) -> Optional[str]:
        return "data" if "data" in self.axis_names else None

    def axis_size(self, name: Optional[str]) -> int:
        if name is None:
            return 1
        return axis_sizes(self.mesh)[name]

    def batch_size_divisor(self) -> int:
        return math.prod(self.axis_size(a) for a in self.batch_axes)


def placements(mesh: DeviceMesh, spec: PartitionSpec) -> tuple:
    """A spec -> one DTensor placement per mesh dim: ``Shard(d)`` on each mesh
    dim named at tensor dim d, ``Replicate()`` on the others. A tuple of axes
    must name them in the mesh's order: DTensor shards a dim over several
    mesh dims in mesh order, major first."""
    names = tuple(mesh.mesh_dim_names)
    out: list[Any] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        if not set(axes) <= set(names):
            raise ValueError(f"{spec}: the mesh has no axis {sorted(set(axes) - set(names))}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axes} are not in the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: axis {names[i]} shards two dims")
            out[i] = Shard(dim)
    return tuple(out)


def constrain_batch_sharding(x, batch_axes: tuple[str, ...] = BATCH_AXES):
    """Pin dim 0 of ``x`` to its mesh's batch axes, replicated over the rest.

    The layer carry is left to no propagation, as in the JAX package: under
    FSDP x TP a row-parallel product leaves it a partial sum over "model",
    and this redistribute settles it once per layer, data-sharded. Outside a
    mesh (a plain tensor), or where the axes do not divide dim 0, it returns
    ``x``. A one-row dim 0 sharded over batch axes of size 1 is made whole
    there: DTensor refuses the next product's view of a sharded dim of size
    1 (the rows are the same either way)."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    sizes = axis_sizes(mesh)
    axes = tuple(a for a in batch_axes if a in sizes)
    if not axes:
        return x
    size = math.prod(sizes[a] for a in axes)
    if size == 1 and x.shape[0] == 1 and Shard(0) in x.placements:
        return x.redistribute(mesh, tuple(Replicate() if p == Shard(0) else p
                                          for p in x.placements))
    if size <= 1 or x.shape[0] % size != 0:
        return x
    return x.redistribute(mesh, placements(mesh, P(axes, *([None] * (x.dim() - 1)))))


def gather_fsdp(w):
    """A weight DTensor made whole over the batch axes ("pod", "data") with its
    sharding over "model" kept: FSDP's gather before a product. Left sharded
    there, DTensor's propagation of ``x @ w`` gathers the rows of x instead
    and leaves a partial sum over "data", and the nonlinear ops and products
    after it then run on every data rank's rows on each data rank. The
    identity on a plain tensor, and over mesh dims of size 1 (a shard there
    is the whole tensor; a redistribute would only cost DTensor's dispatch)."""
    if not isinstance(w, DTensor):
        return w
    mesh = w.device_mesh
    places = tuple(Replicate() if name in BATCH_AXES and n > 1 else p
                   for name, n, p in zip(mesh.mesh_dim_names, mesh.shape, w.placements))
    return w if places == tuple(w.placements) else w.redistribute(mesh, places)


def whole_over_model(x):
    """``x`` made whole over "model" before it is split along a dim that
    "model" shards (the packed [q; k; v] and [gate; up] products). DTensor
    does the same gather inside the split, but then its backward hands the
    product a grad replicated over "model", and each rank computes the whole
    weight grad; through this redistribute the grad comes back sharded as
    the product was. The identity on a plain tensor and for "model" of size
    1."""
    if not isinstance(x, DTensor) or MODEL_AXIS not in x.device_mesh.mesh_dim_names:
        return x
    i = x.device_mesh.mesh_dim_names.index(MODEL_AXIS)
    if isinstance(x.placements[i], Replicate) or x.device_mesh.shape[i] == 1:
        return x
    places = list(x.placements)
    places[i] = Replicate()
    return x.redistribute(x.device_mesh, tuple(places))


def split_over_model(x, dim: int):
    """``x`` sharded over "model" along ``dim`` where "model" divides it: the
    input of a product with a weight sharded so on its contracted dim (the
    FFN's down projection). From a replicated x the forward is a local
    slice, and the weight grad comes out sharded instead of whole on every
    rank. The identity on a plain tensor and for "model" of size 1."""
    if not isinstance(x, DTensor) or MODEL_AXIS not in x.device_mesh.mesh_dim_names:
        return x
    i = x.device_mesh.mesh_dim_names.index(MODEL_AXIS)
    dim = dim % x.dim()
    tp = x.device_mesh.shape[i]
    if tp == 1 or x.placements[i] == Shard(dim) or x.shape[dim] % tp:
        return x
    places = list(x.placements)
    places[i] = Shard(dim)
    return x.redistribute(x.device_mesh, tuple(places))


def make_plan(mesh: Mesh, *, fsdp: bool = True) -> ShardingPlan:
    axes = tuple(axis_sizes(mesh))
    batch_axes = tuple(a for a in BATCH_AXES if a in axes)
    model_axis = MODEL_AXIS if MODEL_AXIS in axes else None
    return ShardingPlan(
        mesh=mesh,
        batch_axes=batch_axes,
        model_axis=model_axis,
        fsdp=fsdp and "data" in axes,
    )


def _div(dim: int, plan: ShardingPlan, axis: Optional[str]) -> bool:
    return axis is not None and dim % plan.axis_size(axis) == 0


def _spec2(plan: ShardingPlan, shape: tuple[int, ...], tp_dim: int,
           fsdp_dim: Optional[int]) -> PartitionSpec:
    """Shard tp_dim over "model"; optionally fsdp_dim over "data"."""
    parts: list[Any] = [None] * len(shape)
    if _div(shape[tp_dim], plan, plan.model_axis):
        parts[tp_dim] = plan.model_axis
    if (
        plan.fsdp
        and fsdp_dim is not None
        and fsdp_dim != tp_dim
        and _div(shape[fsdp_dim], plan, plan.data_axis)
    ):
        parts[fsdp_dim] = plan.data_axis
    return P(*parts)


def _expert_spec(plan: ShardingPlan, shape: tuple[int, ...], tp_dim: int) -> PartitionSpec:
    """MoE expert weights (L, E, ., .): experts over "data" under FSDP (expert
    parallelism), ``tp_dim`` over "model"."""
    parts: list[Any] = [None] * len(shape)
    if plan.fsdp and _div(shape[1], plan, plan.data_axis):
        parts[1] = plan.data_axis
    if _div(shape[tp_dim], plan, plan.model_axis):
        parts[tp_dim] = plan.model_axis
    return P(*parts)


def param_specs(arch: ModelArch, plan: ShardingPlan, params_shape: dict) -> dict:
    """PartitionSpec tree matching ``init_params``'s structure.

    ``params_shape``: any tree of the params' leaves that have ``.shape``
    (tensors, meta tensors or DTensors): the rules read only shapes."""

    def leaf_spec(path: tuple[str, ...], shape: tuple[int, ...]) -> PartitionSpec:
        name = ".".join(path)
        last = path[-1]
        # --- embeddings / head -----------------------------------------
        if name == "embed":
            return _spec2(plan, shape, tp_dim=0, fsdp_dim=1)  # vocab x d
        if name == "lm_head":
            return _spec2(plan, shape, tp_dim=1, fsdp_dim=0)  # d x vocab
        if "norm" in last or last.startswith("ln"):
            return P(*([None] * len(shape)))
        # --- stacked layer tensors (leading L axis) ---------------------
        if last in ("wqkv", "wq", "wkv", "in_proj"):
            return _spec2(plan, shape, tp_dim=len(shape) - 1, fsdp_dim=len(shape) - 2)
        if last == "router":
            return P(*([None] * len(shape)))
        # the JAX package's moe.wo fix-up (its leaf name collides with
        # attn.wo and mlp.wo), as a rule ahead of theirs
        if len(path) >= 2 and path[-2] == "moe" and last == "wo":  # (L, E, F, d)
            return _expert_spec(plan, shape, tp_dim=2)
        if last in ("wo", "out_proj"):
            return _spec2(plan, shape, tp_dim=len(shape) - 2, fsdp_dim=len(shape) - 1)
        if last == "wi":  # (L, d, 2F) or the experts' (L, E, d, 2F)
            if len(shape) == 4:
                return _expert_spec(plan, shape, tp_dim=3)
            return _spec2(plan, shape, tp_dim=len(shape) - 1, fsdp_dim=len(shape) - 2)
        if last in ("conv_w", "conv_b", "dt_bias", "A_log", "D"):
            return _spec2(plan, shape, tp_dim=len(shape) - 1, fsdp_dim=None)
        if len(shape) == 4:  # the JAX rules' 4-dim fallback
            return _expert_spec(plan, shape, tp_dim=2)
        return P(*([None] * len(shape)))  # the shared expert

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return leaf_spec(path, tuple(node.shape))

    return walk(params_shape, ())


def batch_spec(plan: ShardingPlan, batch_shape: dict) -> dict:
    """Specs for the input batch: batch dim over ("pod","data")."""

    def leaf(x):
        nd = len(x.shape)
        if x.shape[0] % plan.batch_size_divisor() == 0 and plan.batch_axes:
            return P(plan.batch_axes, *([None] * (nd - 1)))
        return P(*([None] * nd))

    return {k: leaf(v) for k, v in batch_shape.items()}


def cache_specs(arch: ModelArch, plan: ShardingPlan, cache_shape: dict) -> dict:
    """Decode-cache specs: batch over data axes; heads (or seq) over model."""
    out = {}
    for name, x in cache_shape.items():
        shape = tuple(x.shape)
        parts: list[Any] = [None] * len(shape)
        # all caches are (L, B, ...): shard B over the data axes
        if len(shape) >= 2 and shape[1] % plan.batch_size_divisor() == 0 and plan.batch_axes:
            parts[1] = plan.batch_axes
        if name in ("k", "v", "enc_k", "enc_v", "k_scale", "v_scale"):
            # (L, B, Hkv, T[, D]): heads over model when divisible, else seq
            if _div(shape[2], plan, plan.model_axis):
                parts[2] = plan.model_axis
            elif _div(shape[3], plan, plan.model_axis):
                parts[3] = plan.model_axis
        elif name == "state":
            # (L, B, H, P, N): ssm heads over model
            if _div(shape[2], plan, plan.model_axis):
                parts[2] = plan.model_axis
        elif name == "conv":
            # (L, B, K-1, conv_dim): channels over model
            if _div(shape[3], plan, plan.model_axis):
                parts[3] = plan.model_axis
        out[name] = P(*parts)
    return out


def named(plan: ShardingPlan, spec_tree):
    """PartitionSpec tree -> a tree of ``(DeviceMesh, placements)``, the
    counterpart of a NamedSharding: what :func:`distribute` and
    ``CheckpointManager.restore(shardings=)`` take."""
    if not isinstance(plan.mesh, DeviceMesh):
        raise TypeError("named() needs a plan on a DeviceMesh, not a MeshShape")

    def walk(node):
        if isinstance(node, PartitionSpec):
            return plan.mesh, placements(plan.mesh, node)
        return {k: walk(v) for k, v in node.items()}

    return walk(spec_tree)


def distribute(tree, shardings):
    """Each tensor of ``tree`` as a DTensor on its ``(mesh, placements)`` in
    ``shardings`` (a tree of the same structure; ``named``'s output), the
    counterpart of ``jax.device_put`` onto NamedShardings. Every rank holds
    the same full tensor and keeps its own shard: nothing is sent."""
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    mesh, places = shardings
    return distribute_tensor(tree.to(mesh_device(mesh)), mesh, places, src_data_rank=None)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of ``mesh``: the current CUDA device on a cuda mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(stride))


class _ToLocal(torch.autograd.Function):
    """A DTensor -> its local shard. The grad goes back as a contiguous
    DTensor in ``grad_placements`` under the global shape and strides, given
    explicitly: DTensor's own inference of a global stride from a local
    tensor goes wrong where a local dim has size 1 (a rank's one kv head),
    and a later view of the grad then fails on the local tensor."""

    @staticmethod
    def forward(ctx, x, grad_placements):
        ctx.mesh, ctx.shape, ctx.grad_placements = x.device_mesh, x.shape, grad_placements
        local = x.to_local()
        return local.view_as(local)

    @staticmethod
    def backward(ctx, g):
        return DTensor.from_local(g.contiguous(), ctx.mesh, ctx.grad_placements,
                                  run_check=False, shape=ctx.shape,
                                  stride=_contiguous_stride(ctx.shape)), None


def local_apply(fn, args, in_placements, out_placements, in_grad_placements=None,
                out_shape=None):
    """``fn`` on each rank's local shards of the DTensors ``args``, the
    counterpart of ``shard_map`` (and of torch's ``local_map``, whose
    inferred strides hit the flaw ``_ToLocal`` works around). Each argument is
    first redistributed to its ``in_placements``; its grad comes back in its
    ``in_grad_placements`` (default: ``in_placements``; a partial sum where
    ``fn`` reads on each rank only part of a replicated input). ``fn``'s one
    output, of global shape ``out_shape`` (default: the first argument's),
    comes back as a DTensor in ``out_placements``. Where ``fn`` returns a
    tuple, ``out_placements`` and ``out_shape`` hold one entry per output,
    and a tuple of DTensors comes back."""
    mesh = args[0].device_mesh
    grads = in_grad_placements or in_placements
    local = []
    for x, places, grad_places in zip(args, in_placements, grads):
        if tuple(x.placements) != tuple(places):
            x = x.redistribute(mesh, places)
        local.append(_ToLocal.apply(x, tuple(grad_places)))
    out = fn(*local)
    if isinstance(out, tuple):
        return tuple(_from_local(o, mesh, p, s)
                     for o, p, s in zip(out, out_placements, out_shape))
    return _from_local(out, mesh, out_placements, out_shape or args[0].shape)


def _from_local(x, mesh, places, shape):
    shape = torch.Size(shape)
    return DTensor.from_local(x.contiguous(), mesh, tuple(places), run_check=False,
                              shape=shape, stride=_contiguous_stride(shape))
