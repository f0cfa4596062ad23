"""Multi-pod dry-run on the H100: trace every (arch x shape x mesh) cell on
fake tensors and a fake process group, and report whether it fits and its
roofline terms. The counterpart of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --pods both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu --arch qwen3-8b ...

One process plays one rank (rank 0) of the mesh: a fake process group of the
mesh's size (``torch.testing._internal.distributed.fake_pg``, which runs no
collective) carries a DeviceMesh, params, optimizer state, caches and batch
are DTensors whose local shards are fake tensors (``FakeTensorMode``: shapes,
no memory), and the step runs eagerly under the op accountant
(``op_account``), which counts the rank's FLOPs, HBM bytes, collectives and
live memory. ``--device`` (default ``cuda``) sets the fake tensors' device
and the mesh's device type; nothing falls back from one to the other.

As in the JAX dry-run, the model runs its plain "xla" paths (attention
through ``flash_xla``/``flash_xla_train``, the norm and the scan in plain
PyTorch): the hand-written kernels are calls a dispatch mode cannot see into
and that cannot run on fake tensors. The SSD scan's loop of S steps is
counted, not traced step by step (``op_account._CountedScan``), as the JAX
accountant multiplies a scan body by its trip count. ``donate`` has no eager counterpart:
the port's optimizer and cache writes work in place already; the report
says so.

Artifacts land in artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json, with
the JAX dry-run's keys where the port has the number: ``lower_s`` is the
trace's wall time (there is no compile), the memory fits against the H100's
80 GB (``fits_h100_80g``), and ``roofline`` holds the H100's terms.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ASSIGNED, get_arch
from repro_torch.core.arch import ASSIGNED_SHAPES, InputShape, ModelArch
from repro_torch.launch import roofline as rl
from repro_torch.launch.op_account import OpAccountant
from repro_torch.launch.specs import decode_specs, prefill_specs, train_batch_specs
from repro_torch.models.lm import ModelCfg, decode_step, forward_cached, init_params
from repro_torch.parallel.sharding import (MeshShape, _contiguous_stride, batch_spec,
                                           cache_specs, make_plan, param_specs, placements)
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import TrainStepCfg, make_train_step

SHAPES = {s.name: s for s in ASSIGNED_SHAPES}
# the JAX dry-run's --opt entries
OPTS = ("pre_cast", "dense_decode", "act_shard", "kv_repeat", "kv_scatter", "kv_quant")
DONATE_NOTE = ("no eager counterpart: the optimizer and the cache writes work in place, "
               "so no argument is copied")


def _mesh_from_arg(mesh_arg: str | None, multi_pod: bool) -> MeshShape:
    if mesh_arg:
        dims = tuple(int(x) for x in mesh_arg.split("x"))
        axes = ("pod", "data", "model")[-len(dims):]
        return MeshShape(dims, axes)
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def cell_applicable(arch: ModelArch, shape: InputShape) -> tuple[bool, str]:
    if shape.name == "long_500k" and not arch.supports_long_context:
        return False, "full-attention arch: 500k dense decode skipped (DESIGN.md §4)"
    return True, ""


@contextlib.contextmanager
def fake_mesh(mesh: MeshShape, device_type: str):
    """A fake process group of the mesh's size, this process its rank 0, and
    a DeviceMesh of ``device_type`` on it in row-major rank order. Refuses
    to start while another default group is up; destroys its own on exit."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry-run starts its own fake process group; a default "
                           f"process group ({dist.get_backend()}) is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(mesh.axis_sizes))
    try:
        yield init_device_mesh(device_type, tuple(mesh.axis_sizes),
                               mesh_dim_names=tuple(mesh.axis_names))
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _strided_shards_on_the_host(acc: OpAccountant):
    """torch 2.13's ``_StridedShard.local_shard_size_and_offset`` (a dim
    sharded over two mesh dims out of order, which DTensor makes of the
    grads of k and v when "model" does not split the kv heads) builds an
    index tensor and reads it back, which a fake tensor cannot. While the
    dry-run traces, it runs outside the fake mode and uncounted, as the
    accountant runs DTensor's propagation."""
    from torch.distributed.tensor import placement_types

    cls = getattr(placement_types, "_StridedShard", None)
    fn = cls.__dict__.get("local_shard_size_and_offset") if cls is not None else None
    if fn is None:
        yield
        return
    inner = fn.__func__ if isinstance(fn, staticmethod) else fn
    wrapped = acc.muted(inner)
    cls.local_shard_size_and_offset = staticmethod(wrapped) if isinstance(fn, staticmethod) \
        else wrapped
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = fn


def _placed(mesh, structs, specs):
    """DTensors of ``structs``' global shapes and dtypes in ``specs``'
    placements, each over a fresh local shard of its own (created inside the
    caller's FakeTensorMode, so nothing is allocated). The rules shard only
    dims their axes divide, so every rank's shard has one shape."""
    if isinstance(structs, dict):
        return {k: _placed(mesh, v, specs[k]) for k, v in structs.items()}
    places = placements(mesh, specs)
    local = list(structs.shape)
    for n, place in zip(mesh.shape, places):
        if isinstance(place, Shard):
            local[place.dim] //= n
    shard = torch.empty(local, dtype=structs.dtype, device=structs.device)
    return DTensor.from_local(shard, mesh, places, run_check=False, shape=structs.shape,
                              stride=_contiguous_stride(structs.shape))


def _kv_repeat(arch: ModelArch, plan, opts) -> int:
    kv_repeat = 1
    if "kv_repeat" in opts and not arch.is_attention_free and arch.kv_heads:
        tp = plan.axis_size(plan.model_axis)
        if arch.kv_heads % tp != 0:
            # smallest replication making the head dim tp-divisible
            r = 1
            while (arch.kv_heads * r) % tp != 0 and arch.kv_heads * r < arch.heads:
                r += 1
            kv_repeat = r if (arch.kv_heads * r) % tp == 0 else 1
    return kv_repeat


def _storages(tree) -> dict:
    """id -> bytes of the storages of ``tree``'s tensors (a DTensor's local
    shard)."""
    out = {}
    for x in tree_leaves(tree):
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            out[id(x.untyped_storage())] = x.untyped_storage().nbytes()
    return out


def lower_cell(
    arch: ModelArch,
    shape: InputShape,
    mesh: MeshShape,
    *,
    remat: str = "full",
    fsdp: bool = True,
    microbatch_rows: int = 1,
    donate: bool = True,
    opts: frozenset = frozenset(),
    device: str = "cuda",
) -> dict:
    """Trace one cell on rank 0 of a fake ``mesh``; return the
    roofline/memory report.

    ``opts`` selects the JAX dry-run's §Perf options: "pre_cast",
    "dense_decode", "act_shard", "kv_repeat", "kv_scatter", "kv_quant".
    Empty = paper-faithful baseline."""
    unknown = sorted(set(opts) - set(OPTS))
    if unknown:
        raise ValueError(f"unknown --opt {unknown}; the options are {', '.join(OPTS)}")
    ok, why = cell_applicable(arch, shape)
    if not ok:
        raise NotImplementedError(f"{arch.name} x {shape.name}: {why}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs CUDA, which is not available; pass "
                           "--device cpu to trace on the host")
    from torch._subclasses.fake_tensor import FakeTensorMode

    plan = make_plan(mesh, fsdp=fsdp)
    act_shard = None
    if "act_shard" in opts:
        act_shard = {"batch": plan.batch_axes, "model": plan.model_axis}
    cfg = ModelCfg(dtype=torch.bfloat16, attn_impl="xla", ssm_impl="xla", norm_impl="xla",
                   remat=remat,
                   decode_dense_attn="dense_decode" in opts,
                   kv_cache_repeat=_kv_repeat(arch, plan, opts),
                   kv_scatter_write="kv_scatter" in opts,
                   kv_cache_quant="kv_quant" in opts,
                   act_shard=act_shard)
    report: dict = {
        "arch": arch.name, "shape": shape.name,
        "mesh": "x".join(str(n) for n in mesh.axis_sizes),
        "axes": list(mesh.axis_names), "remat": remat, "fsdp": fsdp,
        "opts": sorted(opts), "device": device,
        "donate": {"requested": donate, "note": DONATE_NOTE},
    }
    dev = torch.device(device)
    acc = OpAccountant()
    with fake_mesh(mesh, device) as dmesh, FakeTensorMode():
        gen = torch.Generator(device=dev)
        if shape.kind == "train":
            p_struct = init_params(arch, gen, torch.float32, dev)
            params = _placed(dmesh, p_struct, param_specs(arch, plan, p_struct))
            del p_struct
            opt = adamw_init(params)
            b_struct = train_batch_specs(arch, shape, cfg, dev)
            batch = _placed(dmesh, b_struct, batch_spec(plan, b_struct))
            dp = plan.batch_size_divisor()
            rows_per_replica = max(shape.global_batch // dp, 1)
            K = max(rows_per_replica // microbatch_rows, 1)
            step_cfg = TrainStepCfg(num_microbatches=K, batch_axes=plan.batch_axes,
                                    pre_cast="pre_cast" in opts)
            step = make_train_step(arch, cfg, step_cfg)
            args = (params, opt, batch)
            report["num_microbatches"] = K

            def run():
                return step(params, opt, batch)
        else:
            p_struct = init_params(arch, gen, torch.bfloat16, dev)
            params = _placed(dmesh, p_struct, param_specs(arch, plan, p_struct))
            del p_struct
            specs = (prefill_specs if shape.kind == "prefill" else decode_specs)(
                arch, shape, cfg, dev)
            caches = _placed(dmesh, specs["caches"],
                             cache_specs(arch, plan, specs["caches"]))
            # the prefill's frontend (vlm) beside the tokens; an encdec
            # model's frames are not read (its cross K/V are in the caches),
            # and JAX's jit drops them
            inputs = {k: specs[k] for k in ("tokens", "frontend") if k in specs}
            inputs = _placed(dmesh, inputs, batch_spec(plan, inputs))
            tokens, frontend = inputs["tokens"], inputs.get("frontend")
            args = (params, caches, inputs)
            if shape.kind == "prefill":
                def run():
                    return forward_cached(params, arch, cfg, caches, tokens, 0,
                                          frontend=frontend)
            else:
                position = specs["position"]
                report["position"] = position

                def run():
                    return decode_step(params, arch, cfg, caches, tokens, position)
        acc.add_arguments(args)
        t0 = time.perf_counter()
        with acc, _strided_shards_on_the_host(acc):
            out = run()
        report["lower_s"] = round(time.perf_counter() - t0, 2)
        kept = _storages(args)
        out_bytes = sum(n for k, n in _storages(out).items() if k not in kept)
        del out
    chips = math.prod(mesh.axis_sizes)

    mem = acc.memory()
    report["memory"] = {
        "argument_bytes": mem["argument_bytes"],
        "output_bytes": out_bytes,
        "temp_bytes": mem["temp_bytes"],
        "per_device_total": mem["per_device_total"],
        "fits_h100_80g": bool(mem["per_device_total"] <= rl.MEM_BYTES),
    }
    totals = acc.totals
    rep = rl.RooflineReport(
        flops=totals.flops, hbm_bytes=totals.bytes,
        wire_bytes=totals.wire_bytes, chips=chips,
        model_flops_total=rl.model_flops(arch, shape), link_s=totals.collective_s,
    )
    groups: dict = {}
    for kind, nbytes, g, _ in acc.collectives:
        row = groups.setdefault((kind, g), {"op": kind, "group_size": g, "count": 0,
                                            "result_bytes": 0.0})
        row["count"] += 1
        row["result_bytes"] += nbytes
    report["collectives"] = {
        "counts": totals.collective_counts,
        "result_bytes": totals.collective_bytes,
        "wire_bytes": totals.wire_bytes,
        "by_group_size": list(groups.values()),
    }
    report["breakdown"] = acc.breakdown()
    report["roofline"] = rep.to_dict()
    report["ok"] = True
    return report


def summary_line(report: dict) -> str:
    """The JAX dry-run's line for an ``ok`` cell."""
    r = report["roofline"]
    m = report.get("memory", {})
    return (f"  ok lower={report['lower_s']}s "
            f"flops/chip={r['flops_per_chip']:.3g} "
            f"terms(c/m/coll)={r['compute_s']:.4g}/{r['memory_s']:.4g}/"
            f"{r['collective_s']:.4g}s dominant={r['dominant']} "
            f"mem/device={(m.get('per_device_total') or 0)/1e9:.2f}GB")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ASSIGNED), default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--pods", choices=("single", "multi", "both"), default="single")
    ap.add_argument("--mesh", default=None, help="override, e.g. 4x4 or 2x2x4")
    ap.add_argument("--remat", default="full", choices=("none", "selective", "full"))
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--opt", default="", help="comma list of " + ",".join(OPTS))
    ap.add_argument("--tag", default="", help="suffix for artifact filenames")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--reduced", action="store_true",
                    help="the archs' reduced configs (CPU-sized)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from repro_torch.configs import get_reduced

    cells = []
    archs = list(ASSIGNED) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    pods = {"single": [False], "multi": [True], "both": [False, True]}[args.pods]
    os.makedirs(args.out, exist_ok=True)

    for arch_name in archs:
        arch = get_reduced(arch_name) if args.reduced else get_arch(arch_name)
        for shape_name in shapes:
            shape = SHAPES[shape_name]
            ok, why = cell_applicable(arch, shape)
            if not ok:
                print(f"SKIP {arch_name} x {shape_name}: {why}")
                continue
            for mp in pods:
                cells.append((arch, shape, mp))

    opts = frozenset(x for x in args.opt.split(",") if x)
    n_fail = 0
    for arch, shape, mp in cells:
        mesh = _mesh_from_arg(args.mesh, mp)
        mesh_tag = "x".join(str(n) for n in mesh.axis_sizes)
        tag = f"{arch.name}__{shape.name}__{mesh_tag}"
        if args.tag:
            tag += f"__{args.tag}"
        print(f"=== {tag} ===", flush=True)
        try:
            report = lower_cell(arch, shape, mesh, remat=args.remat,
                                fsdp=not args.no_fsdp, opts=opts, device=args.device)
        except Exception:
            traceback.print_exc()
            report = {"arch": arch.name, "shape": shape.name, "mesh": mesh_tag,
                      "ok": False, "error": traceback.format_exc(limit=3)}
            n_fail += 1
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(report, f, indent=2)
        if report.get("ok"):
            print(summary_line(report), flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
