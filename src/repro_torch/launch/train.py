"""Training driver: the counterpart of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b --reduced \\
        --steps 60 --batch 16 --seq 64
    PYTHONPATH=src torchrun --standalone --nproc-per-node N \\
        -m repro_torch.launch.train --arch qwen3-8b --reduced ...

Same CLI as the JAX driver, plus ``--device`` (default ``cuda``; ``cpu`` runs
the kernels' plain versions). Started by ``torchrun`` (``WORLD_SIZE`` set), it
trains as the JAX driver does on its devices: a ``(world, 1)`` data x model
mesh with FSDP, params and AdamW state placed by ``param_specs`` and each
batch by ``batch_spec`` (every rank draws the same global batch from the
seed); the process group is ``nccl`` on cards, each rank on
``cuda:LOCAL_RANK`` and never two on one card, ``gloo`` with ``--device cpu``.
Rank 0 alone prints and writes traces and checkpoints. ``--auto-strategy``
runs the paper's mode-1 search for the world's H100s through the port's copy
of the search half and applies the winner's microbatching and recompute
granularity; ``--emit-traces PATH`` appends one measured :class:`StepTrace`
for a calibration loop.
``--checkpoint-dir DIR`` saves params and AdamW state every
``--checkpoint-every`` steps (default 25) through the port's
:class:`CheckpointManager`, in the JAX package's file layout, with the data
pipeline's cursor; ``--resume`` restores the latest one and goes on from its
step, drawing the batches an uninterrupted run would draw.

Attention and the norms take the port's default impls, the CUDA kernels. The
JAX driver trains through ``attn_impl="xla"`` because interpret-mode Pallas
cannot be partitioned across devices (``repro/kernels/ops.py``); one card
partitions nothing, so the kernels run here.

``MarkovCorpus`` holds (V, V) matrices, so the driver runs reduced configs:
qwen3-8b's vocab of 151936 would need 185 GB for each. An encdec model
(whisper) trains on encoder frames and a vlm (pixtral) behind stub patch
embeddings, both drawn each step as the JAX driver draws them, from a
generator seeded with the step.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.calibration.fit import AnalyticEtaModel, load_or_train
from repro_torch.calibration.traces import StepTrace, append_trace
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import PAPER_MODELS, get_arch, get_reduced
from repro_torch.core import Astra, FixedPool, SearchSpec, Workload
from repro_torch.core.params import ParallelStrategy
from repro_torch.data import MarkovCorpus, SyntheticPipeline
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.lm import ModelCfg, init_params
from repro_torch.parallel.sharding import batch_spec, distribute, make_plan, named, param_specs
from repro_torch.serve.search_service import SearchService
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import TrainStepCfg, make_train_step

DEVICE = "H100"  # the card each rank runs on


def pick_strategy(arch, num_devices: int, global_batch: int, seq: int):
    """Run the paper's mode-1 search for this cluster (H100 cards).

    Goes through the spec-keyed :class:`SearchService`, as the JAX driver
    does. The spec keeps the default ``Limits`` (one worker): more workers
    would fork a process pool, which is unsafe once CUDA is initialised, so
    call this before the first CUDA call."""
    try:
        eta, _ = load_or_train()
    except Exception:
        eta = AnalyticEtaModel()
    service = SearchService(Astra(eta))
    report = service.search(SearchSpec(
        arch=arch,
        pool=FixedPool(DEVICE, max(num_devices, 1)),
        workload=Workload(global_batch, seq),
    ))
    return report.best


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config of the family")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=("none", "selective", "full"))
    ap.add_argument("--auto-strategy", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--emit-traces", default=None, metavar="PATH",
                    help="append one measured StepTrace (JSONL, wire format) "
                         "per run — feed it to a calibration-enabled search "
                         "service via 'python -m repro_torch.serve.search_service "
                         "traces' or CalibrationLoop.ingest")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    arch = get_reduced(args.arch) if args.reduced and args.arch not in PAPER_MODELS \
        else get_arch(args.arch)
    # started by torchrun (or with its environment set by hand)
    world = int(os.environ.get("WORLD_SIZE", "1"))

    remat, micro = args.remat, args.microbatches
    searched = None  # the auto-strategy winner, reused for trace attribution
    if args.auto_strategy:  # before the first CUDA call (see pick_strategy)
        s = searched = pick_strategy(arch, world, args.batch, args.seq)
        if s is not None:
            remat = s.recompute_granularity
            # num_microbatches is per-DP-rank (GB / (dp * mbs)); the train
            # step splits the *global* batch K ways, so K is exactly it
            micro = max(s.num_microbatches(args.batch), 1)
    device = resolve_device(args.device)
    plan, owns_group = None, False
    if "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            local_rank = int(os.environ.get("LOCAL_RANK", "0"))
            cards = torch.cuda.device_count()
            per_host = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
            if per_host > cards:
                raise RuntimeError(f"{per_host} ranks on a machine with {cards} card(s): "
                                   f"each rank takes a card of its own")
            torch.cuda.set_device(local_rank)
            device = torch.device("cuda", local_rank)
        owns_group = not dist.is_initialized()
        plan = make_plan(make_mesh((world, 1), ("data", "model"), device.type), fsdp=True)
    rank0 = plan is None or dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    if searched is not None:
        s = searched
        say(f"[astra] strategy: tp={s.tensor_parallel} pp={s.pipeline_parallel} "
            f"dp={s.data_parallel} mbs={s.micro_batch_size} remat={remat} "
            f"dist_opt={s.use_distributed_optimizer}")

    cfg = ModelCfg(dtype=getattr(torch, args.dtype), remat=remat)
    step_cfg = TrainStepCfg(num_microbatches=micro, base_lr=args.lr,
                            warmup_steps=10, total_steps=args.steps,
                            batch_axes=plan.batch_axes if plan else ())
    train_step = make_train_step(arch, cfg, step_cfg)

    # every rank draws the same params from the seed and keeps its shards
    params = init_params(arch, torch.Generator(device).manual_seed(0), torch.float32, device)
    if plan is not None:
        params = distribute(params, named(plan, param_specs(arch, plan, params)))
    opt = adamw_init(params)
    corpus = MarkovCorpus(arch.vocab, seed=0)
    pipe = SyntheticPipeline(corpus=corpus, global_batch=args.batch, seq_len=args.seq)

    ckpt = CheckpointManager(args.checkpoint_dir) if args.checkpoint_dir else None
    start_step = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        state, meta = ckpt.restore({"params": params, "opt": opt})
        params, opt = state["params"], state["opt"]
        pipe.load_state_dict({"step": meta["data_step"]})
        start_step = meta["step"]
        say(f"[ckpt] resumed from step {start_step}")

    losses: list[float] = []
    step_times: list[float] = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        t_step = time.perf_counter()
        batch = {k: torch.as_tensor(v, device=device).long()
                 for k, v in pipe.next_batch().items()}
        # the frontend stubs' inputs, drawn from the step; the JAX driver
        # draws them from PRNGKey(step), so the two drivers' values differ
        stub = None
        if arch.family == "encdec":
            stub = ("enc_features", arch.encoder_seq)
        elif arch.frontend_stub and arch.frontend_seq:
            stub = ("frontend", arch.frontend_seq)
        if stub is not None:
            batch[stub[0]] = torch.randn(
                (args.batch, stub[1], arch.hidden), dtype=cfg.dtype, device=device,
                generator=torch.Generator(device).manual_seed(step))
        if plan is not None:
            batch = distribute(batch, named(plan, batch_spec(plan, batch)))
        params, opt, metrics = train_step(params, opt, batch)
        loss = float(metrics["loss"])  # waits for the step's loss
        if device.type == "cuda":
            torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t_step)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {loss:.4f} "
                f"gnorm {float(metrics.get('grad_norm', 0)):.3f} "
                f"({(time.time() - t0):.1f}s)")
        if ckpt and (step + 1) % args.checkpoint_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt},
                      metadata={"data_step": pipe.step, "arch": arch.name})
    if ckpt:
        ckpt.wait()
    if args.emit_traces and step_times and rank0:
        # attribute the measurement to the searched strategy when there is
        # one; otherwise describe the mesh this run used (data parallel over
        # its world of cards)
        strategy = searched if searched is not None else ParallelStrategy(
            device=DEVICE, num_devices=world,
            micro_batch_size=max(args.batch // (world * micro), 1),
        )
        trace = StepTrace(
            arch=arch, strategy=strategy,
            global_batch=args.batch, seq=args.seq,
            step_times=tuple(step_times), source="train",
        )
        append_trace(args.emit_traces, trace)
        print(f"[trace] appended {len(step_times)}-step trace "
              f"(median {trace.measured_step_time:.4f}s) to {args.emit_traces}")
    result = {
        "first_loss": losses[0], "last_loss": losses[-1],
        "entropy_floor": corpus.entropy_rate(), "steps": len(losses),
    }
    say(json.dumps(result))
    if owns_group:
        dist.destroy_process_group()
    return dict(result, step_times=step_times, losses=losses)


if __name__ == "__main__":
    main()
