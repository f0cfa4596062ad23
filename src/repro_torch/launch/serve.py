"""Batched serving driver: the counterpart of ``examples/serve_batched.py``,
prefill + decode over the port's :class:`ServeEngine` on one card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --tokens 24

Same CLI as the JAX example, plus ``--device`` (default ``cuda``; ``cpu`` runs
the kernels' plain versions). It serves the reduced config of ``--arch`` in
f32 with random weights; an encdec model (whisper) needs encoder features,
which the example passes none of, so its cache refuses to build
(``ValueError``). With ``--search-spec spec.json`` the driver first replays a
serialized :class:`SearchSpec` through the port's spec-keyed
:class:`SearchService` and reports the strategy it would deploy; with
``--search-url http://host:port`` it fetches the report from a running
service instead (``python -m repro_torch.serve.search_service serve``), and
exits 2 when that service cannot be reached. ``--emit-traces PATH`` appends
one measured ``source="serve"`` :class:`StepTrace` of the decode steps,
without the engine's first-call warm-up steps.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.calibration.fit import load_or_train
from repro_torch.calibration.traces import StepTrace, append_trace
from repro_torch.configs import get_reduced
from repro_torch.core import Astra, SearchSpec
from repro_torch.core.params import ParallelStrategy
from repro_torch.models import lm
from repro_torch.serve import ServeEngine
from repro_torch.serve.search_service import SearchService, post_spec

# the card a serve without a searched strategy is attributed to
DEVICE = "H100"


def pick_strategy_from_spec(path: str, url: str = None, token: str = None,
                            timeout: float = None):
    """Replay a serialized SearchSpec through the search service.

    In-process by default; with ``url`` the spec is POSTed to a remote
    service (``token`` authenticates against an ``--auth-tokens`` service)
    through the hardened HTTP client: a dead service fails within
    ``timeout`` with a clean error instead of hanging the deploy, and
    transient transport faults retry with backoff. In-process, call it
    before the first CUDA call: a spec whose limits ask for workers forks a
    process pool."""
    with open(path) as f:
        spec_json = f.read()
    spec = SearchSpec.from_json(spec_json)
    if url:
        kw = {} if timeout is None else {"timeout": timeout}
        key, report, cached = post_spec(url, spec_json, token=token, **kw)
        print(f"served by {url} (key={key} cached={cached})")
        return spec, report
    eta, _ = load_or_train()
    return spec, SearchService(Astra(eta)).search(spec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--search-spec", default=None, metavar="SPEC_JSON",
                    help="replay a serialized SearchSpec and report the "
                         "strategy this deployment would use")
    ap.add_argument("--search-url", default=None, metavar="URL",
                    help="fetch the report from a running search service "
                         "instead of searching in-process")
    ap.add_argument("--search-token", default=None, metavar="TOKEN",
                    help="bearer token when --search-url points at an "
                         "auth-enabled service")
    ap.add_argument("--search-timeout", type=float, default=None, metavar="SECONDS",
                    help="per-request timeout against --search-url "
                         "(default: the service client's 600s)")
    ap.add_argument("--emit-traces", default=None, metavar="PATH",
                    help="append one measured source='serve' StepTrace "
                         "(JSONL, wire format) from this generate's decode "
                         "steps, the inlet the train driver feeds too "
                         "('python -m repro_torch.serve.search_service "
                         "traces' or CalibrationLoop.ingest)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    report = None
    if args.search_spec:
        try:
            _, report = pick_strategy_from_spec(
                args.search_spec, url=args.search_url,
                token=args.search_token, timeout=args.search_timeout,
            )
        except (RuntimeError, OSError) as e:
            print(f"search service unavailable: {e}", file=sys.stderr)
            return 2
        b = report.best
        if b is None:
            print(f"search spec {args.search_spec}: no feasible strategy")
        else:
            print(f"search spec {args.search_spec} ({report.mode}): "
                  f"{b.device} x{b.num_devices} tp={b.tensor_parallel} "
                  f"pp={b.pipeline_parallel} dp={b.data_parallel} -> "
                  f"{report.best_sim.throughput_tokens:,.0f} tok/s simulated")

    device = resolve_device(args.device)
    arch = get_reduced(args.arch)
    cfg = lm.ModelCfg(dtype=torch.float32)
    params = lm.init_params(arch, torch.Generator(device).manual_seed(0), torch.float32,
                            device)
    engine = ServeEngine(arch, cfg, params, max_len=args.prompt_len + args.tokens + 8,
                         device=device)

    prompts = np.random.default_rng(0).integers(
        0, arch.vocab, size=(args.batch, args.prompt_len)
    ).astype(np.int32)

    t0 = time.time()
    result = engine.generate(prompts, max_new_tokens=args.tokens,
                             temperature=args.temperature, seed=1)
    dt = time.time() - t0
    total_new = args.batch * args.tokens
    print(f"arch={arch.name} ({arch.total_params()/1e6:.1f}M params, "
          f"family={arch.family})")
    print(f"batched generate: {args.batch} requests x {args.tokens} tokens "
          f"in {dt:.2f}s ({total_new/dt:.1f} tok/s incl. first-call set-up)")
    for i, row in enumerate(result.tokens[:2]):
        print(f"  req{i}: prompt={row[:args.prompt_len].tolist()[:8]}... "
              f"generated={row[args.prompt_len:].tolist()}")

    # the first call's set-up steps stay out of the trace, whose consumers
    # would read them as drift; the exclusion is recorded on the trace
    clean_steps = result.step_times[result.warmup_steps:]
    if args.emit_traces and clean_steps:
        # attribute the measurement to the searched strategy when there is
        # one; otherwise the H100 cards the port serves on (one where none is
        # visible)
        strategy = report.best if report is not None and report.best \
            is not None else ParallelStrategy(
                device=DEVICE, num_devices=max(torch.cuda.device_count(), 1),
                micro_batch_size=max(args.batch, 1),
            )
        trace = StepTrace(
            arch=arch, strategy=strategy,
            global_batch=args.batch, seq=args.prompt_len + args.tokens,
            step_times=clean_steps, source="serve",
            warmup_steps_excluded=result.warmup_steps,
        )
        append_trace(args.emit_traces, trace)
        print(f"[trace] appended {len(clean_steps)}-step serve trace "
              f"({result.warmup_steps} warmup step(s) excluded, median "
              f"{trace.measured_step_time:.4f}s) to {args.emit_traces}")
    elif args.emit_traces:
        print("[trace] nothing to append: every measured step was a "
              "first-call warmup")
    return 0


if __name__ == "__main__":
    sys.exit(main())
