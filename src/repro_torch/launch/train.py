"""Training driver: the counterpart of ``repro/launch/train.py``, on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b --reduced \\
        --steps 60 --batch 16 --seq 64

Same CLI as the JAX driver, plus ``--device`` (default ``cuda``; ``cpu`` runs
the kernels' plain versions). Not ported yet, and refused with the ROADMAP
item each waits for: ``--auto-strategy`` and ``--emit-traces`` (they need
the search half, ``repro.core``'s ``Astra`` and ``StepTrace``, copied into
the port), ``--checkpoint-dir``, ``--checkpoint-every`` and ``--resume``
(checkpoints). Each is refused whenever it is given, at any value.

Attention and the norms take the port's default impls, the CUDA kernels. The
JAX driver trains through ``attn_impl="xla"`` because interpret-mode Pallas
cannot be partitioned across devices (``repro/kernels/ops.py``); one card
partitions nothing, so the kernels run here.

``MarkovCorpus`` holds (V, V) matrices, so the driver runs reduced configs:
qwen3-8b's vocab of 151936 would need 185 GB for each.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import PAPER_MODELS, get_arch, get_reduced
from repro_torch.data import MarkovCorpus, SyntheticPipeline
from repro_torch.models.lm import ModelCfg, init_params
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import TrainStepCfg, make_train_step

# flag -> what it waits for
_NOT_PORTED = {
    "auto_strategy": "the search half copied into repro_torch (ROADMAP Queue 1 item 2)",
    "emit_traces": "StepTrace, with the search half copied into repro_torch "
                   "(ROADMAP Queue 1 item 2)",
    "checkpoint_dir": "checkpoints (ROADMAP Queue 1 item 8)",
    "checkpoint_every": "checkpoints (ROADMAP Queue 1 item 8)",
    "resume": "checkpoints (ROADMAP Queue 1 item 8)",
}


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
    ap.add_argument("--checkpoint-every", type=int, default=None)  # JAX's default: 25
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--emit-traces", default=None, metavar="PATH")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for flag, needs in _NOT_PORTED.items():
        given = getattr(args, flag)
        if given is not None and given is not False:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet: it needs {needs}")

    arch = get_reduced(args.arch) if args.reduced and args.arch not in PAPER_MODELS \
        else get_arch(args.arch)
    device = resolve_device(args.device)

    cfg = ModelCfg(dtype=getattr(torch, args.dtype), remat=args.remat)
    step_cfg = TrainStepCfg(num_microbatches=args.microbatches, base_lr=args.lr,
                            warmup_steps=10, total_steps=args.steps)
    train_step = make_train_step(arch, cfg, step_cfg)

    params = init_params(arch, torch.Generator(device).manual_seed(0), torch.float32, device)
    opt = adamw_init(params)
    corpus = MarkovCorpus(arch.vocab, seed=0)
    pipe = SyntheticPipeline(corpus=corpus, global_batch=args.batch, seq_len=args.seq)

    losses: list[float] = []
    step_times: list[float] = []
    t0 = time.time()
    for step in range(args.steps):
        t_step = time.perf_counter()
        batch = {k: torch.as_tensor(v, device=device).long()
                 for k, v in pipe.next_batch().items()}
        params, opt, metrics = train_step(params, opt, batch)
        loss = float(metrics["loss"])  # waits for the step's loss
        if device.type == "cuda":
            torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t_step)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics.get('grad_norm', 0)):.3f} "
                  f"({(time.time() - t0):.1f}s)")
    result = {
        "first_loss": losses[0], "last_loss": losses[-1],
        "entropy_floor": corpus.entropy_rate(), "steps": len(losses),
    }
    print(json.dumps(result))
    return dict(result, step_times=step_times)


if __name__ == "__main__":
    main()
