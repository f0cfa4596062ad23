"""Runs a function on several gloo ranks of one machine, for the port's
sharding tests.

Each rank is a process started with ``spawn``, joins its process group through
a ``FileStore`` under the test's ``tmp_path`` (never a fixed TCP port: xdist
runs test files side by side), runs on one intra-op thread, and has a time
limit, as the whole spawn has: a hang fails the test instead of running into
the suite's limit. A rank's exception fails the test with its traceback.
"""
import datetime
import os
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANK_TIMEOUT_S = 60  # each collective of a rank
SPAWN_TIMEOUT_S = 120  # the whole run


def _main(rank, fn, world, store, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = SPAWN_TIMEOUT_S):
    """``fn(rank, world, *args)`` on ``world`` gloo ranks; ``fn`` and ``args``
    must pickle (a module-level function)."""
    store = os.path.join(str(tmp_path), f"store-{time.monotonic_ns()}")
    ctx = mp.start_processes(_main, args=(fn, world, store, args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            pytest.fail(f"{fn.__name__} on {world} ranks ran past {timeout} s")


# ---------------------------------------------------------------------------
# rank programs (module-level so that spawn can pickle them; they import
# the port only, never jax)
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _placed(arch, plan, params_np, tokens):
    """The params (from numpy) and a token batch as DTensors on ``plan``."""
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel.sharding import batch_spec, distribute, named, param_specs

    params = params_from_numpy(params_np, device="cpu")
    params = distribute(params, named(plan, param_specs(arch, plan, params)))
    batch = {"tokens": torch.from_numpy(tokens).long()}
    return params, distribute(batch, named(plan, batch_spec(plan, batch)))


def _full(tree) -> dict:
    return {k: v.full_tensor().numpy() for k, v in _flat(tree).items()}


def _grads(arch, cfg, params, batch):
    """The loss's grads on DTensor params, each redistributed to its param's
    placements as make_train_step does, made whole; and, per leaf, the
    placements the backward handed the grad in beside its param's."""
    from repro_torch.models.lm import forward_train

    flat = _flat(params)
    inputs = {k: v.detach().requires_grad_() for k, v in flat.items()}
    tree = {}
    for k, v in inputs.items():
        node = tree
        *parents, last = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v
    loss, _ = forward_train(tree, arch, cfg, batch)
    grads = torch.autograd.grad(loss, list(inputs.values()))
    placed = {k: (tuple(g.placements), tuple(v.placements))
              for (k, v), g in zip(inputs.items(), grads)}
    whole = {k: g.redistribute(v.device_mesh, v.placements).full_tensor().numpy()
             for (k, v), g in zip(inputs.items(), grads)}
    return whole, placed


def _arch(name, opts):
    """The reduced config of ``name`` with ``opts["arch"]``'s fields replaced."""
    import dataclasses

    from repro_torch.configs import get_reduced

    return dataclasses.replace(get_reduced(name), **opts.get("arch", {}))


class _Drops:
    """While active, counts the assignments ``moe.global_route`` drops on
    this rank (its position among all assignments to its expert at C or
    past it), and records the token counts it was handed (``rows``)."""

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.real, self.n, self.rows = moe, moe.global_route, 0, set()

        def route(*args, **kwargs):
            out = self.real(*args, **kwargs)
            self.n += int((out[3] >= out[6]).sum())
            self.rows.add(args[1].shape[0])
            return out

        moe.global_route = route
        return self

    def __exit__(self, *exc):
        self.moe.global_route = self.real


def _global_drops(mesh, n: int) -> int:
    """The drops of the ranks of "model" index 0 summed: the ranks of one
    "model" group route the same tokens."""
    import torch.distributed as dist

    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (mesh.get_local_rank("model"), n))
    return sum(k for m, k in every if m == 0)


def train_step_program(rank, world, out, cases, order_cases, ckpt_dir=None, kept_case=None,
                       uneven_case=None):
    """On a (2, 2) data x model mesh with FSDP (``opts["fsdp"]`` False: without):
    per case (arch name, params, tokens[, opts]), one make_train_step step,
    then one of K = 2 microbatches with batch_axes; the inputs K1 was handed,
    each with what K1's ``_plan`` made of it; the loss's grads at the first
    step's params (``_grads``) and, for the moe family, the assignments
    their forward dropped over all ranks. ``opts``: "label" (the results'
    key, default the name), "arch" (fields of the reduced config to replace)
    and "fsdp". Then the shards the ranks hold of an arange under each (mesh
    shape, axes, spec) of ``order_cases``, by rank; with ``ckpt_dir``, the
    mamba2 and granite cases' states after a step saved there and restored
    with their placements (``_ckpt_round_trip``); with ``kept_case``, the
    global dispatch on a (4, 1) mesh (``_kept_on_ranks``); with
    ``uneven_case``, granite's MoE block on rows the data ranks hold unequal
    blocks of (``_uneven_moe_on_ranks``). Rank 0 saves the results."""
    import torch.distributed as dist

    from repro_torch.kernels import ops, rmsnorm
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import ModelCfg
    from repro_torch.parallel.sharding import distribute, make_plan, placements
    from repro_torch.train import TrainStepCfg, adamw_init, make_train_step

    seen = []
    kernel = ops.rmsnorm_fwd

    def recording(x, weight, eps=1e-6):
        try:
            kind = rmsnorm._plan(x, weight)[0]
        except ValueError:
            kind = "refused"
        seen.append((tuple(x.shape), tuple(x.stride()), x.is_contiguous(), kind))
        return kernel(x, weight, eps=eps)

    ops.rmsnorm_fwd = recording
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    cfg = ModelCfg(dtype=torch.float32)  # impl "cuda": the plain versions on the CPU
    results = {}
    for name, params_np, tokens, *more in cases:
        opts = more[0] if more else {}
        label = opts.get("label", name)
        arch = _arch(name, opts)
        plan = make_plan(mesh, fsdp=opts.get("fsdp", True))
        params, batch = _placed(arch, plan, params_np, tokens)
        with _Drops() as drops:
            results[(label, "grads")] = _grads(arch, cfg, params, batch)
        if arch.family == "moe":
            results[(label, "drops")] = _global_drops(mesh, drops.n)
        for K in (1, 2):
            seen.clear()
            step = make_train_step(arch, cfg, TrainStepCfg(num_microbatches=K,
                                                           batch_axes=plan.batch_axes))
            params, batch = _placed(arch, plan, params_np, tokens)
            opt = adamw_init(params)
            placed = {k: v.placements for k, v in _flat(params).items()}
            params, opt, m = step(params, opt, batch)
            results[(label, K)] = {
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "params": _full(params), "norm_inputs": list(seen),
                "aux_loss": float(m["aux_loss"]) if "aux_loss" in m else None,
                "kept_placements": all(
                    v.placements == placed[k] == _flat(opt.mu)[k].placements
                    == _flat(opt.nu)[k].placements for k, v in _flat(params).items()),
            }
    shards = []
    for shape, axes, spec in order_cases:
        order_mesh = make_mesh(shape, axes, "cpu")
        x = torch.arange(8 * 8, dtype=torch.float32).reshape(8, 8)
        local = distribute(x, (order_mesh, placements(order_mesh, spec))).to_local()
        every = [None] * world
        dist.all_gather_object(every, local.numpy().copy())
        shards.append(every)
    results["shards"] = shards
    if ckpt_dir is not None:
        plan = make_plan(mesh, fsdp=True)
        for name, params_np, tokens, *more in cases:
            if name in ("mamba2-370m", "granite-moe-3b-a800m") and not more:
                results[("ckpt", name)] = _ckpt_round_trip(
                    _arch(name, {}), cfg, plan, params_np, tokens, f"{ckpt_dir}/{name}")
    if kept_case is not None:
        results["kept"] = _kept_on_ranks(*kept_case)
    if uneven_case is not None:
        results["uneven"] = _uneven_moe_on_ranks(mesh, make_plan(mesh, fsdp=True), cfg,
                                                 *uneven_case)
    if rank == 0:
        torch.save(results, out)


def _kept_on_ranks(router_np, x_np, top_k, capacity_factor) -> dict:
    """On a (4, 1) data x model mesh, each rank's block of the rows of x (B,
    S, d) through ``moe.global_route``: the (token, expert) pairs it keeps,
    the tokens numbered in the global order, and its own assignments to each
    expert; every rank's, with C."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import batch_groups

    mesh = make_mesh((4, 1), ("data", "model"), "cpu")
    rank = mesh.get_local_rank("data")
    B, S, d = x_np.shape
    rows = B // 4
    xt = torch.from_numpy(x_np[rank * rows:(rank + 1) * rows]).reshape(-1, d)
    router = torch.from_numpy(router_np)
    _, e_sorted, _, pos, t_sorted, _, C = moe.global_route(
        router, xt, top_k, capacity_factor, B * S, batch_groups(mesh))
    kept = pos < C
    pairs = sorted(zip((t_sorted[kept] + rank * rows * S).tolist(), e_sorted[kept].tolist()))
    counts = moe.expert_counts(e_sorted, router.shape[-1]).tolist()
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (pairs, counts))
    return {"pairs": sorted(p for ps, _ in every for p in ps),
            "counts": [c for _, c in every], "C": C}


def _uneven_moe_on_ranks(mesh, plan, cfg, params_np, x_np, cot_np, tokens) -> dict:
    """Reduced granite's layer-0 MoE block and aux loss on the (2, 2) mesh,
    x (3, S, d) over "data" as blocks of 2 and 1 rows: the output, the loss
    ``sum(y * cot) + aux`` and its grads made whole, and the token counts
    the ranks' dispatch was handed. Then K = 2 microbatches of ``tokens``'s
    6 rows through make_train_step: the ValueError it raises, or None."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.configs import get_reduced
    from repro_torch.models import lm, moe
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import TrainStepCfg, make_train_step

    arch = get_reduced("granite-moe-3b-a800m")
    params, batch = _placed(arch, plan, params_np, tokens)
    p = {k: v.detach().requires_grad_()
         for k, v in lm._layer(params["layers"], 0)["moe"].items()}
    rows = (Shard(0), Replicate())
    x = distribute_tensor(torch.from_numpy(x_np), mesh, rows).requires_grad_()
    with _Drops() as drops:
        y = moe.moe_block(p, x, top_k=arch.top_k, capacity_factor=1.25)
        aux = moe.aux_load_balance_loss(p, x, top_k=arch.top_k)
    loss = (y * distribute_tensor(torch.from_numpy(cot_np), mesh, rows)).sum() + aux
    names = ["x", *p]
    grads = torch.autograd.grad(loss, [x, *p.values()])
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, drops.rows)
    step = make_train_step(arch, cfg, TrainStepCfg(num_microbatches=2,
                                                   batch_axes=plan.batch_axes))
    try:
        step(params, adamw_init(params), batch)
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"y": y.full_tensor().detach().numpy(), "loss": float(loss.detach().full_tensor()),
            "aux": float(aux.detach().full_tensor()),
            "grads": {k: g.full_tensor().numpy() for k, g in zip(names, grads)},
            "rows": sorted(set().union(*every)), "refused": refused}


def _ckpt_round_trip(arch, cfg, plan, params_np, tokens, ckpt_dir) -> dict:
    """One step's params and AdamW state as DTensors through
    ``CheckpointManager.save`` and ``restore(shardings=)`` onto the same
    placements: whether every rank's local shards came back equal, and the
    restored expert leaves' placements (moe)."""
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel.sharding import named, param_specs
    from repro_torch.train import TrainStepCfg, adamw_init, make_train_step

    step = make_train_step(arch, cfg, TrainStepCfg(batch_axes=plan.batch_axes))
    params, batch = _placed(arch, plan, params_np, tokens)
    params, opt, _ = step(params, adamw_init(params), batch)
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(1, {"params": params, "opt": opt}, blocking=True)
    dist.barrier()  # rank 0's write is done
    whole = params_from_numpy(params_np, device="cpu")
    sh = named(plan, param_specs(arch, plan, whole))
    state, _ = mgr.restore({"params": whole, "opt": adamw_init(whole)},
                           shardings={"params": sh, "opt": {"mu": sh, "nu": sh}})
    pairs = [(_flat(a), _flat(b)) for a, b in ((state["params"], params),
                                                (state["opt"].mu, opt.mu),
                                                (state["opt"].nu, opt.nu))]
    same = all(got[k].placements == want[k].placements for got, want in pairs for k in want)
    equal = all(torch.equal(got[k].to_local(), want[k].to_local())
                for got, want in pairs for k in want)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (same, equal))
    restored = _flat(state["params"])
    return {"same_placements": all(s for s, _ in every), "equal": all(e for _, e in every),
            "leaves": sum(len(want) for _, want in pairs),
            "expert_placements": [tuple(restored[k].placements)
                                  for k in ("layers/moe/wi", "layers/moe/wo") if k in restored]}


def elastic_program(rank, world, out, ckpt_dir, params_np, token_batches):
    """Reduced yi-6b: two steps on a (4, 1) mesh, a save, a restore onto
    (2, 2) with placements, two more steps. Rank 0 saves the losses and the
    leaves each rank copied to the host in the save."""
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint import manager as manager_mod
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.lm import ModelCfg
    from repro_torch.parallel.sharding import batch_spec, distribute, make_plan, named, param_specs
    from repro_torch.train import TrainStepCfg, adamw_init, make_train_step

    arch = get_reduced("yi-6b")
    step = make_train_step(arch, ModelCfg(dtype=torch.float32), TrainStepCfg(base_lr=1e-3))
    losses = []

    def run(plan, params, opt, tokens_list):
        for tokens in tokens_list:
            batch = {"tokens": torch.from_numpy(tokens).long()}
            batch = distribute(batch, named(plan, batch_spec(plan, batch)))
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
        return params, opt

    whole = params_from_numpy(params_np, device="cpu")
    plan_a = make_plan(make_mesh((4, 1), ("data", "model"), "cpu"), fsdp=True)
    params = distribute(whole, named(plan_a, param_specs(arch, plan_a, whole)))
    params, opt = run(plan_a, params, adamw_init(params), token_batches[:2])
    mgr = CheckpointManager(ckpt_dir)
    copied = []
    to_host = manager_mod._to_host
    manager_mod._to_host = lambda leaf: copied.append(1) or to_host(leaf)
    mgr.save(2, {"params": params, "opt": opt}, blocking=True)
    manager_mod._to_host = to_host
    host_copies = [None] * world
    dist.all_gather_object(host_copies, len(copied))
    dist.barrier()  # rank 0's write is done
    plan_b = make_plan(make_mesh((2, 2), ("data", "model"), "cpu"), fsdp=True)
    sh = named(plan_b, param_specs(arch, plan_b, whole))
    state, meta = mgr.restore({"params": whole, "opt": adamw_init(whole)},
                              shardings={"params": sh, "opt": {"mu": sh, "nu": sh}})
    params, opt = state["params"], state["opt"]
    on_b = all(v.placements == sh_k[1] for v, sh_k in zip(_flat(params).values(),
                                                          _flat_named(sh)))
    run(plan_b, params, opt, token_batches[2:])
    if rank == 0:
        torch.save({"losses": losses, "restored_on_b": on_b, "step": meta["step"],
                    "host_copies": host_copies}, out)


def _flat_named(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _flat_named(v)
    else:
        yield tree


def act_shard_program(rank, world, out, cases):
    """On a (1, 2) data x model mesh: per case, the forward's logits without
    and with ``act_shard``, the loss under it, and the loss that DTensor's
    ``loss_parallel`` gives on the logits sharded over the vocab. Rank 0
    saves them."""
    import dataclasses

    import torch.nn.functional as F
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.parallel import loss_parallel

    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import make_plan

    plan = make_plan(make_mesh((1, 2), ("data", "model"), "cpu"), fsdp=True)
    cfg = lm.ModelCfg(dtype=torch.float32)
    shard_cfg = dataclasses.replace(cfg, act_shard={"batch": plan.batch_axes,
                                                    "model": plan.model_axis})
    results = {}
    for name, params_np, tokens in cases:
        arch = get_reduced(name)
        params, batch = _placed(arch, plan, params_np, tokens)
        logits = lm.forward_logits(params, arch, cfg, batch)
        mesh = logits.device_mesh
        lg = logits[:, :-1, :].float().redistribute(mesh, (Replicate(), Shard(2)))
        targets = batch["tokens"][:, 1:].redistribute(mesh, (Replicate(), Replicate()))
        with loss_parallel():  # reduction="mean" takes a one-dim mesh only
            vocab_sharded = F.cross_entropy(lg.reshape(-1, arch.vocab), targets.reshape(-1),
                                            reduction="sum") / targets.numel()
        results[name] = {
            "plain": logits.full_tensor().numpy(),
            "act_shard": lm.forward_logits(params, arch, shard_cfg, batch).full_tensor().numpy(),
            "loss": float(lm.forward_train(params, arch, shard_cfg, batch)[0]),
            "loss_parallel": float(vocab_sharded.full_tensor()),
        }
    if rank == 0:
        torch.save(results, out)


def pipeline_program(rank, world, out, w_np, x_np):
    """tests/test_distributed.py's GPipe case: L layers of ``h + silu(h @ w)``
    over the ranks as stages, forward and the grad of sum(y ** 2) (each rank
    holds its own stage's rows of it: summed over the ranks); then the same on
    a mesh whose "stage" dim has size 1 (every rank its own one-stage
    pipeline). Rank 0 saves both."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.pipeline import pipeline_apply, stack_for_stages

    def apply_stage(stage_w, h):
        for wl in stage_w:
            h = h + F.silu(h @ wl)
        return h

    results = {}
    for shape, axes in (((world,), ("stage",)), ((world, 1), ("data", "stage"))):
        mesh = make_mesh(shape, axes, "cpu")
        n = mesh.size(axes.index("stage"))
        w = torch.from_numpy(w_np).requires_grad_()
        y = pipeline_apply(mesh, apply_stage, stack_for_stages(w, n), torch.from_numpy(x_np))
        (g,) = torch.autograd.grad((y ** 2).sum(), w)
        if n > 1:
            dist.all_reduce(g)
        ys = [torch.empty_like(y) for _ in range(world)]
        dist.all_gather(ys, y.detach())
        results[n] = {"y": y.detach().numpy(), "grad": g.numpy(),
                      "same_on_every_rank": all(torch.equal(t, ys[0]) for t in ys)}
    if rank == 0:
        torch.save(results, out)


def cached_program(rank, world, out, mesh_shape, cases, chunk_case):
    """On a ``mesh_shape`` data x model mesh with FSDP, params, caches and
    tokens as DTensors placed by param_specs, cache_specs and batch_spec.
    Per case (label, arch name, params, prompts, new tokens N, max_len,
    ModelCfg options): the prefill and N greedy decode steps, each step's
    logits made whole, the tokens, and the caches' placements; or the error
    the cached path raised. Then, where given, chunk_case (params, P0, C,
    max_len, tokens) for reduced yi-6b: a prefill of P0 tokens and a chunk
    of C more from position P0, each rank's local k shard after each; and
    the error a family the port does not shard raises. Rank 0 saves the
    results."""
    import torch.distributed as dist

    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel.sharding import (batch_spec, cache_specs, distribute, make_plan,
                                               named, param_specs)

    plan = make_plan(make_mesh(mesh_shape, ("data", "model"), "cpu"), fsdp=True)

    def placed(arch, cfg, params_np, B, T):
        params = params_from_numpy(params_np, device="cpu")
        params = distribute(params, named(plan, param_specs(arch, plan, params)))
        caches = lm.init_caches(arch, cfg, B, T, device="cpu")
        return params, distribute(caches, named(plan, cache_specs(arch, plan, caches)))

    def tokens(t):
        t = torch.as_tensor(t).long()
        return distribute({"tokens": t}, named(plan, batch_spec(plan, {"tokens": t})))["tokens"]

    results = {}
    for label, name, params_np, prompts, N, T, opts in cases:
        arch = get_reduced(name)
        cfg = lm.ModelCfg(dtype=torch.float32, **opts)
        params, caches = placed(arch, cfg, params_np, prompts.shape[0], T)
        try:
            logits, _ = lm.prefill(params, arch, cfg, caches, tokens(prompts))
            steps = [logits.full_tensor().numpy()]
            nxt = logits.full_tensor()[:, -1].argmax(-1, keepdim=True)
            seq = [torch.as_tensor(prompts).long(), nxt]
            for i in range(N):
                logits, _ = lm.decode_step(params, arch, cfg, caches, tokens(nxt),
                                           prompts.shape[1] + i)
                steps.append(logits.full_tensor().numpy())
                nxt = logits.full_tensor()[:, -1].argmax(-1, keepdim=True)
                seq.append(nxt)
            results[label] = {"logits": steps, "tokens": torch.cat(seq[:-1], 1).numpy(),
                              "placements": {k: tuple(v.placements) for k, v in caches.items()}}
        except NotImplementedError as e:
            results[label] = {"error": str(e)}

    if chunk_case is not None:
        params_np, P0, C, T, toks = chunk_case
        arch = get_reduced("yi-6b")
        cfg = lm.ModelCfg(dtype=torch.float32)
        params, caches = placed(arch, cfg, params_np, toks.shape[0], T)
        shards = []
        lm.prefill(params, arch, cfg, caches, tokens(toks[:, :P0]))
        for start, chunk in ((None, None), (P0, toks[:, P0:P0 + C])):
            if start is not None:
                lm.forward_cached(params, arch, cfg, caches, tokens(chunk), start)
            every = [None] * world
            dist.all_gather_object(every, (plan.mesh.get_coordinate(),
                                           caches["k"].to_local().numpy().copy()))
            shards.append(every)
        results["chunk"] = {"shards": shards, "placements": tuple(caches["k"].placements)}

        vlm = get_reduced("pixtral-12b")
        vlm_params = lm.init_params(vlm, torch.Generator().manual_seed(0), torch.float32, "cpu")
        vlm_params = distribute(vlm_params, named(plan, param_specs(vlm, plan, vlm_params)))
        try:
            lm.prefill(vlm_params, vlm, cfg, lm.init_caches(vlm, cfg, 2, 16, device="cpu"),
                       tokens(torch.zeros((2, 4), dtype=torch.long)))
            results["unsharded_family"] = None
        except NotImplementedError as e:
            results["unsharded_family"] = str(e)
    if rank == 0:
        torch.save(results, out)
