#!/usr/bin/env python3
"""Drive the PyTorch port's inference and training paths on one CUDA card:
the dense family (qwen3-8b), the ssm family (mamba2-370m), the hybrid family
(hymba-1.5b: a sliding window and a ring KV cache), the moe family
(granite-moe-3b-a800m), the encdec family (whisper-tiny: a bidirectional
encoder over 1500 stub frames, cross-attended by the decoder) and the vlm
family (pixtral-12b: 1024 stub patch embeddings in front of the text).

    python3 chip_smoke.py

Phases, each reported on its own lines; any failure exits non-zero:
  1. device  - the card's name and power limit (nvidia-smi);
  2. build   - compile the CUDA kernels of src/repro_torch/kernels/csrc, and
               print each kernel's registers, stack and spills (ptxas -v);
  3. kernels - each kernel (RMSNorm, flash attention, SSD scan) against its
               plain PyTorch version at the shapes of the main paths and the
               edge cases of the JAX tests (RMSNorm also at every width of the
               JAX configs and on the q/k head views of a fused qkv row, read
               in place; an unaligned view is refused; flash attention also at
               the forward shapes of hymba, granite, whisper's encoder (not
               causal, T = 1500) and pixtral (head size 160), with the path
               each dtype took), timed beside its plain version,
               its bound and a library call where one exists. Each time is
               given twice: `ms`, the device time per call (the durations of
               the CUDA kernels that torch.profiler records over N calls,
               over N), and `call_ms`, CUDA events around the loop of N
               calls, which also holds the host's dispatch when a kernel is
               shorter than it;
  4. forward - per model, at full width and depth (random bf16 weights from a
               seeded generator, and the stub inputs of whisper and pixtral
               too): forward_logits through the kernels, with the launches of
               each kernel counted, against the same forward through the
               plain versions, in bf16 and, on the same weights cast up, in
               f32 (pixtral's first 4 of 40 layers: f32 weights at full depth
               would be 51 GB; for granite the plain run replays the kernel
               run's expert choices, and its own routing is logged beside);
               plus the reduced model in f32 where kernels, plain versions
               and the cached path agree; hymba also at B=1, S=2048, past its
               window (banded_flash_xla: K2 must not launch), granite's share
               of dropped assignments at capacity factor 1.25;
  5. serve   - per model, ServeEngine.generate, checked against teacher
               forcing, and the device's busy share while decoding (whisper
               with its frames encoded into the cache, pixtral with 1024
               patch embeddings in front of each prompt, so decode starts at
               position 1152); hymba also with a 1024-token prompt whose
               prefill fills the ring and whose every decode step wraps it,
               and with the int8 KV cache, scatter writes and dense decode
               attention (tokens and cache bytes beside the default run's);
               then the serve driver (python -m repro_torch.launch.serve
               --arch qwen3-8b --emit-traces), its trace read back;
  6. train   - qwen3-8b at full width and 8 of its 36 layers (f32 AdamW at
               full depth needs 131 GB): five make_train_step steps through
               the kernels (wall, forward + backward and optimizer ms, peak
               memory, launches per step, busy share, train_mfu); one step
               under each remat policy from the same params (losses, peak
               memory, launches, recomputed weight products); loss and every
               grad through the kernels against the plain versions and the
               "xla" path in f32 at 2 layers, and against the plain versions
               in bf16 at 2 layers and the five steps' B, S (the shapes at
               which the train step calls K1 and K2); the train driver on
               the reduced config; one mamba2-370m step at 2 of 48 layers,
               timed; two granite-moe-3b-a800m steps at 4 of 32 layers (wall,
               forward + backward and optimizer ms, peak memory, ce_loss and
               aux_loss, launches), and its loss and grads through the
               kernels against the plain versions in f32 at 2 layers;
  7. ckpt    - the free disk and host RAM; qwen3-8b at full width and 2 of its
               36 layers at phase 6's B, S: two steps, an async save of params
               and AdamW state (19.6 GB), two more steps while it writes, the
               restore into a fresh template on the card equal to the saved
               state bit for bit, the resumed run's two steps against the
               uninterrupted run's beside a control run (bytes written, the ms
               save() blocked the loop, the write's s and GB/s, the restore's
               s, step ms while writing and without, in a {"ckpt": ...} JSON
               line); then the train driver on the reduced config: 6 steps
               saving every 3, against 3 steps and --resume to 6;
  8. astra   - the train driver with --auto-strategy --emit-traces (the
               searched strategy, its launches, the trace read back); then
               the port's Astra searches phase 6's step, and the five steps
               of phase 6, as one StepTrace, are scored by a CalibrationLoop
               under the analytic and the GBT eta model: predicted, measured
               and accuracy in an {"astra": ...} JSON line (a measurement:
               no check holds it to a bound);
  9. shard   - sharding on the card, on a one-rank NCCL group: qwen3-8b at full
               width and 2 of its 36 layers at phase 6's B, S, eight
               make_train_step steps with params, AdamW state and batch as
               DTensors on a (1, 1) ("data", "model") mesh with FSDP (K1 and
               K2 on each rank's shards) against the same eight steps on
               plain tensors: the losses and every leaf, the launches, the
               first step's ms and the median and range of the other seven,
               and the peak memory of each run, in a {"shard": ...} JSON
               line; the same for mamba2-370m (2 of 48 layers, B=1 S=256)
               and hymba-1.5b (2 of 32 layers, B=1 S=2048, past its window:
               the banded attention), four steps each, K1 and K3 on each
               rank's shards through local_apply, in a {"shard_ssm": ...}
               JSON line;
               pipeline_apply at one stage against the sequential stack; a
               save at (1, 1) restored through restore(shardings=) with
               placements; the train driver under torchrun --nproc-per-node 1
               against the same driver alone. No collective across cards;
 10. dryrun  - the port's dry-run (repro_torch.launch.dryrun) against the card:
               (a) qwen3-8b at full width and depth served (4 prompts x 128
               + 32 greedy tokens) with params, caches and tokens as DTensors
               on a (1, 1) mesh over the one-rank NCCL group, against plain
               tensors: tokens equal, prefill logits bit for bit, K1 launched
               on the DTensor path; the same for mamba2-370m and hymba-1.5b
               at full depth (4 x 128 + 32, and hymba 2 x 1024 + 8, whose
               prompt fills its ring of 1024 and whose decode steps wrap
               it); (b) lower_cell of phase 9's cells (qwen3-8b's and
               mamba2-370m's) on fake CUDA tensors against the same step on
               the card under the same op accountant (mamba2's scan there
               the real loop of 256 steps, which the dry-run counts in
               three): FLOPs equal, the predicted per-device memory within
               DRYRUN_MEM_RATIO of max_memory_allocated, the roofline bound
               beside the measured step, the step through the kernels
               beside it; one decode step at full depth against a cache of
               1024, its memory term beside the measured step and the busy
               share; (c) the production cells (qwen3-8b at train_4k,
               prefill_32k and decode_32k on 16x16 and train_4k on 2x16x16,
               the other dense archs' serve cells on 16x16, mamba2-370m's
               and hymba-1.5b's 16 cells at all four shapes on both
               meshes), each a `python -m repro_torch.launch.dryrun` process
               at the lowest priority (the train cells start with the
               script) on fake CUDA tensors and a fake process group of 256
               or 512 ranks, all `ok`; a {"dryrun": ...} JSON line;
 11. order   - RMSNorm timed at each (rows, D) it ran at in phases 4-10, with
               the launches its wrapper counted there at that shape, beside
               F.rms_norm at the same shape and the launch floor (a one-block
               elementwise op), at D = 128 also on k head views; then the
               order of the kernel redesigns, each kernel's launches on the
               main paths x (device ms - bound ms), RMSNorm summed over its
               shapes; a JSON line with one entry per kernel, and a last JSON
               line with the device.
It imports nothing of the JAX package and never falls back to the CPU.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import io
import itertools
import json
import math
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}  # tensor bf16; f32 CUDA cores
L2_BYTES = 50 * 2 ** 20
# Kernel vs plain version. bf16: 2e-2 (tests/test_kernels.py) plus one bf16
# ulp (2^-7 of the value): both round an f32 result once, and f32 values that
# differ in the last bits can fall on either side of a bf16 rounding midpoint.
# f32: 2e-5, as the JAX tests.
TOL = {torch.bfloat16: (2e-2, 2.0 ** -7), torch.float32: (2e-5, 0.0)}
# lse is f32 from either input type: log(T) plus the row max, below 20 here;
# sums of up to 1024 terms in another order differ by a few f32 ulps of it.
LSE_TOL = 1e-4
# bf16 forward, kernels vs plain versions, per model: (max abs logit
# difference, argmax agreement, also held by serve's greedy tokens against
# teacher forcing). The two paths differ only in rounding, which the layers
# carry into the logits; random weights give near-ties at many positions.
#   qwen3-8b: 36 layers, |logit| up to ~6, one bf16 ulp there is 2^-5.
#   mamba2-370m: 48 layers, and the SSM state carries each rounding along the
#   sequence too. The chunked and the sequential scan, 1e-4 apart in f32 on
#   the same weights, moved the bf16 logits by 0.95 at 0.80 argmax agreement
#   on an H100 at B=2, S=512 (PERF.md); serve compares only 128 tokens
#   (binomial spread ~0.035), hence the lower agreement bound.
#   hymba-1.5b: 32 layers with an SSM recurrence beside attention, as mamba2.
#   An H100 (700 W) read 0.47 and 0.848 at B=2, S=1024; its serve runs 0.81
#   (128 tokens), 0.91 (the ring run, 64 tokens) and 0.73 (int8 KV cache).
#   granite-moe-3b-a800m: the plain run replays the kernel run's expert
#   choices (RoutingReplay). An H100 read 0.078 and 0.996 at B=2, S=512, and
#   0.961 for serve, whose decode and teacher forcing route on their own: a
#   bf16 rounding flips near-ties of the router (1515 of 32768 token-layers
#   in that forward). The plain run on its own routing is held to the same
#   agreement bound (an H100 read 0.985 and 0.989).
#   whisper-tiny: 4 encoder and 4 decoder layers. An H100 (700 W) read
#   0.109 and 0.959 at B=4, 448 tokens behind 1500 frames (f32 on the same
#   weights 1.2e-05: rounding alone), its serve 0.961 over 128 tokens
#   (binomial spread ~0.017); about twice the reading, as qwen3's bound is
#   about twice its own, and 0.9 for the agreement.
#   pixtral-12b: 40 layers, qwen3-8b's bounds (36). An H100 read 0.313 and
#   0.923 at B=1, 1024 + 512 positions (f32 over 4 layers 2.8e-05), its
#   serve 0.891 over 64 tokens (spread ~0.039).
# The f32 comparison on the same weights is the one that tells a fault from
# rounding.
BF16_BOUNDS = {"qwen3-8b": (0.5, 0.75), "mamba2-370m": (1.5, 0.6),
               "hymba-1.5b": (1.0, 0.6), "granite-moe-3b-a800m": (0.25, 0.9),
               "whisper-tiny": (0.25, 0.9), "pixtral-12b": (0.5, 0.75)}
# the capacity factor of the moe serve runs (see _serve_cfg)
MOE_SERVE_CAPACITY = 8.0
# the same model in f32: rounding noise near 1e-5 of the logits
F32_MAX_ABS = 1e-3
F32_ARGMAX_MIN = 0.99
# moe in f32, the plain run on its own routing: the share of token-layers
# whose top-k differs from the kernel run's. An H100 read 1 of 32768 in the
# forward and 0 of 4096 in the train step; bf16 rounding alone flips 4.6-4.8%.
# A fault that moves the router's inputs flips far more than this.
MOE_F32_FLIP_SHARE = 1e-3
REDUCED_TOL = 1e-4
# SSD kernel vs the sequential plain scan, y in f32 and the f32 state in both
# types: 2e-3, as tests/test_kernels.py (bf16 y takes TOL: both sides take the
# same bf16 inputs to f32 and round y once)
SSD_TOL = 2e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def err_vs(out: torch.Tensor, ref: torch.Tensor, dtype) -> tuple[float, bool]:
    atol, rtol = TOL[dtype]
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    return float(diff.max()), ok


def device_events(prof) -> list:
    """The device events (kernels, memsets, copies) of a torch.profiler run.
    Not key_averages(): there a CPU op also carries the device time of the
    kernels it launched, so its sum counts them twice."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == cuda]


def device_us(prof) -> float:
    return sum(e.time_range.elapsed_us() for e in device_events(prof))


def time_ms(fn, arg_sets, iters: int = 20) -> tuple[float, float]:
    """(ms, call_ms) per call. Each call takes the next of the input copies
    (copies()), so a copy comes back only after twice the 50 MB L2 of others
    and every call reads its inputs from HBM. ms: the device time of the
    kernels the calls launch, under torch.profiler, after a warm-up step of
    as many calls whose events it drops: right after it starts, the profiler
    loses the device events of short calls (8 of 20 RMSNorm launches on an
    H100), and a trace can hold a few events too many (22 for 20 RMSNorm
    launches, once on an H100). A trace whose events are not a multiple of
    the calls is retaken; the timing takes the first two whole traces that
    hold the same number of events, the most any whole one held; at most
    twelve traces (the plain RMSNorm's nine kernels a call have taken more
    than five on an H100), after which the fullest whole trace counts (a
    long trace may lose a few events in every take); a timing that took
    more than two says so. call_ms: CUDA events around a
    loop of calls, which is the host's dispatch rate when that is slower."""
    from torch.profiler import ProfilerActivity, profile, schedule

    n_call = itertools.count()

    def calls(n: int) -> None:
        for _ in range(n):
            fn(*arg_sets[next(n_call) % len(arg_sets)])

    def trace() -> list:
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):  # the warm-up step, then the one recorded
                calls(iters)
                torch.cuda.synchronize()
                prof.step()
        return device_events(prof)

    calls(3)
    torch.cuda.synchronize()
    best, seen = [], []
    for _ in range(12):
        events = trace()
        seen.append(len(events))
        if not events or len(events) % iters:
            continue
        if len(events) == len(best):
            break
        if len(events) > len(best):
            best = events
    else:
        # no two agreed: the fullest whole one (the plain SSD's 28720 events
        # a trace came whole once in twelve traces on an H100)
        if not best:
            raise SmokeFailure(f"the profiler's traces of {iters} calls held {seen} device "
                               f"events")
        events = best
        log("timing", f"no two of the profiler's traces agreed; took the fullest, "
            f"{len(best)} events")
    if len(seen) > 2:
        log("timing", f"the profiler's traces of {iters} calls held {seen} device events")
    dev_us = sum(e.time_range.elapsed_us() for e in events)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    calls(iters)
    end.record()
    end.synchronize()
    return dev_us / 1e3 / iters, start.elapsed_time(end) / iters


def warm_up(fn, arg_sets, calls: int = 200) -> None:
    """Calls enough to bring the card's clocks up after a pause (making
    inputs, checking outputs): without them, the first timing of a short
    kernel after one reads slower than the same kernel timed again."""
    for i in range(calls):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()


def copies(make, nbytes: int):
    """Copies of the inputs whose sum passes twice the L2."""
    return [make() for _ in range(max(2, math.ceil(2 * L2_BYTES / max(nbytes, 1))))]


def bound_ms(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _times(name: str, fn, sets, iters: int = 20) -> dict:
    ms, call_ms = time_ms(fn, sets, iters)
    return {f"{name}ms": ms, f"{name}call_ms": call_ms}


def _kernel_name(mangled: str) -> str:
    """ssd_fwd_bf16<64, 32, 128> from the mangled name of a kernel in an
    anonymous namespace of csrc/*.cu."""
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
    if m is None:
        return mangled
    end = m.end() + int(m.group(1))
    tmpl = mangled[end:].split("EEv")[0]
    args = re.findall(r"Li(\d+)E", tmpl)
    if "bfloat16" in tmpl:
        args.append("bf16")
    elif tmpl.startswith("If"):
        args.append("f32")
    return f"{mangled[m.end():end]}<{', '.join(args)}>"


def ptxas_summary(text: str) -> list[str]:
    """One line per kernel of a build log holding ptxas -v's output."""
    rows, name, frame = [], None, ("?", "?", "?")
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            frame = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append(f"{name}: {m.group(1)} registers, stack {frame[0]} B, spill stores "
                        f"{frame[1]} B, spill loads {frame[2]} B")
            name = None
    return rows


def _fold_rmsnorm_configs(rows: list[str]) -> list[str]:
    """ptxas_summary's lines with those of the RMSNorm vector kernel's
    configurations folded into one a dtype: registers from least to most,
    stack and spills (the full list is in the build log)."""
    out, vec = [], collections.defaultdict(list)
    for line in rows:
        m = re.match(r"rmsnorm_vec_kernel<(.*), (bf16|f32)>: (\d+) registers, (.*)", line)
        if m:
            vec[m.group(2)].append((int(m.group(3)), m.group(1), m.group(4)))
        else:
            out.append(line)
    for dtype, regs in vec.items():
        lo, hi = min(regs), max(regs)
        frames = sorted({r[2] for r in regs})
        out.append(f"rmsnorm_vec_kernel {dtype}: {len(regs)} configurations (LPR, VPT, RPT, "
                   f"THREADS), {lo[0]} registers <{lo[1]}> to {hi[0]} <{hi[1]}>; "
                   f"{' / '.join(frames)}")
    return out


def build_kernels() -> list[str]:
    """load_kernels(verbose=True), with its output (ninja's, holding ptxas -v
    for every kernel) in build/repro_torch_kernels/build.log; returns
    ptxas_summary of it."""
    from repro_torch.kernels._build import BUILD_DIR, load_kernels

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / "build.log"
    sys.stdout.flush()
    saved = os.dup(1)
    try:
        with open(path, "w") as f:
            os.dup2(f.fileno(), 1)
            load_kernels(verbose=True)
            sys.stdout.flush()
    except Exception:
        os.dup2(saved, 1)
        print(path.read_text()[-4000:], file=sys.stderr)
        raise
    finally:
        os.dup2(saved, 1)
        os.close(saved)
    return ptxas_summary(path.read_text())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _rmsnorm_bound(rows: int, D: int) -> tuple[float, str]:
    return bound_ms((2 * rows * D + D) * 2, 4.0 * rows * D, torch.float32)


def _rmsnorm_inputs(rows, D, dtype, g, dev):
    return lambda: (torch.randn(rows, D, generator=g, device=dev).to(dtype),
                    torch.ones(D, device=dev, dtype=dtype))


def _fused_view(tokens, H, Hkv, D, dtype, g, dev, which="q", offset=0):
    """The q or k heads of a fused (tokens, (H + 2 Hkv) D) projection output,
    as the attention sub-layer hands them to the norm: (tokens, heads, D) with
    row strides ((H + 2 Hkv) D, D). offset: elements the buffer starts past
    its allocation (1 puts a bf16 view off the 16-byte grid)."""
    W = (H + 2 * Hkv) * D
    buf = torch.randn(tokens * W + offset, generator=g, device=dev).to(dtype)
    fused = buf[offset:].view(tokens, W)
    q, k, _ = torch.split(fused, [H * D, Hkv * D, Hkv * D], dim=-1)
    return (q if which == "q" else k).reshape(tokens, -1, D)


# K1's correctness cases: the widths of the JAX configs and of the main paths
# at these row counts (32768 rows of the widest in both types: 1 GB of f32),
# and the q/k views of the fused product at these token counts
RMSNORM_WIDTHS = (64, 80, 128, 384, 1024, 1536, 1600, 4096, 5120, 8192)
RMSNORM_ROWS = (1, 3, 4, 32, 1000, 32768)
RMSNORM_VIEW_HEADS = ((32, 8, 128), (32, 8, 64), (32, 8, 80))  # H, Hkv, head_dim
RMSNORM_VIEW_TOKENS = (1, 3, 4, 32, 1000, 1024, 4096)  # 4096: the train step's B x S


def rmsnorm_phase(dev) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels._build import load_kernels
    from repro_torch.kernels.rmsnorm import row_layout, rmsnorm_fwd

    g = torch.Generator(device=dev).manual_seed(1)
    # (rows, D): forward ln over B*S=1024 rows of d=4096 and train ln over
    # B*S=4096, q/k norms over B*S*32 and B*S*8 rows of head_dim 128 (train:
    # 131072 and 32768), decode rows (B=4), edge widths, the ln rows of the
    # hymba (B*S=2048, d=1600) and granite (1024 and the train step's 4096,
    # d=1536) forwards, whisper's encoder (4 x 1500 frames) and decoder (4 x
    # 448 tokens) at d=384, pixtral's (1024 + 512 positions, d=5120); then
    # every width of RMSNORM_WIDTHS at every row count of RMSNORM_ROWS
    named = [(1024, 4096), (4096, 4096), (32768, 128), (131072, 128), (8192, 128),
             (4, 4096), (128, 128), (1000, 16), (1000, 80), (1000, 8192), (3, 100),
             (2048, 1600), (1024, 1536), (4096, 1536), (6000, 384), (1792, 384),
             (1536, 5120)]
    cases = named + [(rows, D) for D in RMSNORM_WIDTHS for rows in RMSNORM_ROWS]
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        before = collections.Counter(rmsnorm_fwd.paths)
        n_views = 0
        for i, (rows, D) in enumerate(cases):
            x = torch.randn(rows, D, generator=g, device=dev).to(dtype)
            w = (1.0 + 0.1 * torch.randn(D, generator=g, device=dev)).to(dtype)
            y = rmsnorm_fwd(x, w)
            e, ok = err_vs(y, ref.rmsnorm(x, w), dtype)
            worst = max(worst, e)
            if i < len(named) or not ok:
                log("kernels", f"rmsnorm {str(dtype)[6:]} rows={rows} D={D} max_abs_err={e:.3e} "
                    f"ok={ok}")
            check(ok, f"rmsnorm {dtype} ({rows}, {D}) off by {e}")
        for (H, Hkv, D), tokens, which in itertools.product(
                RMSNORM_VIEW_HEADS, RMSNORM_VIEW_TOKENS, ("q", "k")):
            x = _fused_view(tokens, H, Hkv, D, dtype, g, dev, which)
            w = (1.0 + 0.1 * torch.randn(D, generator=g, device=dev)).to(dtype)
            y = rmsnorm_fwd(x, w)
            e, ok = err_vs(y, ref.rmsnorm(x, w), dtype)
            ok = ok and y.is_contiguous() and y.shape == x.shape
            worst = max(worst, e)
            n_views += 1
            if D == 128 and tokens >= 1024 or not ok:
                log("kernels", f"rmsnorm {str(dtype)[6:]} {which} view of a fused row, "
                    f"{tokens} tokens x {x.shape[1]} heads, D={D}, layout {row_layout(x)}: "
                    f"max_abs_err={e:.3e} ok={ok}")
            check(ok, f"rmsnorm {dtype} {which} view {(tokens, H, Hkv, D)} off by {e}")
        took = collections.Counter(rmsnorm_fwd.paths) - before
        log("kernels", f"rmsnorm {str(dtype)[6:]}: {len(cases)} contiguous cases and "
            f"{n_views} q/k views held ref.rmsnorm at TOL; kernels {dict(took)}")
        # rows of whole 16-byte vectors take the vector kernel, (3, 100) in
        # bf16 the scalar one
        n_scalar = sum(D * x.element_size() % 16 != 0 for _, D in cases)
        check(took == collections.Counter(vector=len(cases) - n_scalar + n_views,
                                          scalar=n_scalar),
              f"rmsnorm {dtype} took the kernels {dict(took)}")

    # a strided bf16 view off the 16-byte grid: the wrapper refuses it, and so
    # does the launcher behind it; no launch is counted
    x = _fused_view(4, 32, 8, 128, torch.bfloat16, g, dev, "k", offset=1)
    w = torch.ones(128, device=dev, dtype=torch.bfloat16)
    before = rmsnorm_fwd.launches
    _, n_inner, s_outer, s_inner = row_layout(x)
    for launch in (lambda: rmsnorm_fwd(x, w),
                   lambda: load_kernels().rmsnorm_fwd(
                       x, w, torch.empty(x.shape, device=dev, dtype=x.dtype), 1e-6, n_inner,
                       s_outer, s_inner)):
        try:
            launch()
            torch.cuda.synchronize()
        except (ValueError, RuntimeError) as exc:
            log("kernels", f"rmsnorm bf16 unaligned view refused: {str(exc).splitlines()[0]}")
        else:
            raise SmokeFailure("an unaligned bf16 rmsnorm view was launched")
    check(rmsnorm_fwd.launches == before, "an unaligned rmsnorm launch was counted")

    rows, D = 1024, 4096
    sets = copies(_rmsnorm_inputs(rows, D, torch.bfloat16, g, dev), (2 * rows * D + D) * 2)
    t = _times("", rmsnorm_fwd, sets) | _times("plain_", ref.rmsnorm, sets) | _times(
        "library_", lambda x, w: torch.nn.functional.rms_norm(x, (D,), w, 1e-6), sets)
    bms, by = _rmsnorm_bound(rows, D)
    log("kernels", f"rmsnorm timing bf16 ({rows}, {D}): kernel {t['ms']:.4f} ms "
        f"(call {t['call_ms']:.4f}), plain {t['plain_ms']:.4f} ({t['plain_call_ms']:.4f}), "
        f"torch rms_norm {t['library_ms']:.4f} ({t['library_call_ms']:.4f}), bound "
        f"{bms:.4f} ms ({by})")
    return {"name": "rmsnorm_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm.py:30",
            "max_abs_err": worst, **t, "bound_ms": bms, "bound_by": by}


def rmsnorm_shape_times(dev, shapes: collections.Counter) -> list[dict]:
    """RMSNorm (bf16) at each (rows, D) of the main paths (phases 4-10), with the launches
    its wrapper counted there at that shape, beside F.rms_norm and the launch
    floor (the device time of a one-block elementwise op on 8 bf16 values),
    each timed here. At D = 128 (the q/k norms) also on the same rows read in
    place as the k heads of qwen3-8b's fused qkv rows (8 of 48 heads a row)."""
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd

    g = torch.Generator(device=dev).manual_seed(7)
    eight = torch.ones(8, device=dev, dtype=torch.bfloat16)
    floor_ms = time_ms(lambda a: a * 2, [(eight,)])[0]
    log("order", f"launch floor: a one-block elementwise op on 8 bf16 values, {floor_ms:.4f} ms")
    rows_out = []
    for (rows, D), n in sorted(shapes.items(), key=lambda kv: -kv[0][0] * kv[0][1]):
        sets = copies(_rmsnorm_inputs(rows, D, torch.bfloat16, g, dev), (2 * rows * D + D) * 2)
        lib = lambda x, w: torch.nn.functional.rms_norm(x, (D,), w, 1e-6)  # noqa: E731
        warm_up(rmsnorm_fwd, sets)
        turns = {rmsnorm_fwd: [], lib: []}
        for fn in (rmsnorm_fwd, lib, lib, rmsnorm_fwd):
            turns[fn].append(time_ms(fn, sets))
        (ms, call_ms), (lib_ms, lib_call_ms) = (
            [statistics.mean(t[i] for t in turns[fn]) for i in (0, 1)]
            for fn in (rmsnorm_fwd, lib))
        del sets
        view_ms = None
        if D == 128 and rows % 8 == 0:
            w = torch.ones(D, device=dev, dtype=torch.bfloat16)
            make = lambda: (_fused_view(rows // 8, 32, 8, D, torch.bfloat16, g, dev, "k"), w)
            # as many copies as of contiguous rows: what is read must pass the L2
            view_ms = time_ms(rmsnorm_fwd, copies(make, (2 * rows * D + D) * 2))[0]
        b_ms, _ = _rmsnorm_bound(rows, D)
        rows_out.append({"rows": rows, "D": D, "launches": n, "ms": ms, "call_ms": call_ms,
                         "view_ms": view_ms, "library_ms": lib_ms,
                         "library_call_ms": lib_call_ms, "bound_ms": b_ms,
                         "floor_ms": floor_ms, "gap_ms": n * (ms - b_ms)})
        log("order", f"rmsnorm shape ({rows}, {D}) x {n} launches: kernel {ms:.4f} ms "
            f"(call {call_ms:.4f}; turns {[round(t[0], 5) for t in turns[rmsnorm_fwd]]})"
            + (f", as k views of fused rows {view_ms:.4f} ms" if view_ms is not None else "")
            + f", torch rms_norm {lib_ms:.4f} ms (call {lib_call_ms:.4f}; turns "
            f"{[round(t[0], 5) for t in turns[lib]]}), bound {b_ms:.6f} ms "
            f"(bound / kernel {b_ms / ms:.3f}), floor {floor_ms:.4f} ms, launches x gap "
            f"{rows_out[-1]['gap_ms']:.3f} ms")
    return rows_out


def _qkv_views(B, Hq, Hkv, S, T, D, dtype, g, dev):
    """q/k/v as the model hands them over: head-transposed views of one
    projection output when S == T, separate contiguous tensors otherwise."""
    if S == T:
        qkv = torch.randn(B, S, (Hq + 2 * Hkv) * D, generator=g, device=dev).to(dtype)
        q, k, v = torch.split(qkv, [Hq * D, Hkv * D, Hkv * D], dim=-1)
        return (q.reshape(B, S, Hq, D).transpose(1, 2),
                k.reshape(B, S, Hkv, D).transpose(1, 2),
                v.reshape(B, S, Hkv, D).transpose(1, 2))
    return (torch.randn(B, Hq, S, D, generator=g, device=dev).to(dtype),
            torch.randn(B, Hkv, T, D, generator=g, device=dev).to(dtype),
            torch.randn(B, Hkv, T, D, generator=g, device=dev).to(dtype))


# K2 at the full-sequence forwards of hymba-1.5b (B=2, S=1024 = its window:
# groups of 5), granite-moe-3b-a800m (B=2, S=512: groups of 3), whisper-tiny's
# encoder (B=4, 1500 frames, not causal: the last 64-key tile holds 28 live
# keys) and pixtral-12b (B=1, 1024 + 512 positions, head size 160, groups of 4)
FLASH_MODEL_SHAPES = {"hymba": (2, 25, 5, 1024, 1024, 64, True),
                      "granite": (2, 24, 8, 512, 512, 64, True),
                      "whisper_enc": (4, 6, 6, 1500, 1500, 64, False),
                      "pixtral": (1, 32, 8, 1536, 1536, 160, True)}


def flash_phase(dev) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels._build import load_kernels
    from repro_torch.kernels.flash_attention import HEAD_DIMS, _plan, flash_attention_fwd

    g = torch.Generator(device=dev).manual_seed(2)
    cases = [  # B, Hq, Hkv, S, T, D, causal
        (2, 32, 8, 512, 512, 128, True),    # the forward's shape (GQA)
        *FLASH_MODEL_SHAPES.values(),       # hymba's (groups of 5), granite's (of 3)
        (2, 32, 8, 512, 512, 128, False),
        (4, 32, 8, 1024, 1024, 128, True),  # the train step's shape
        (1, 8, 1, 512, 512, 64, True),      # MQA
        (1, 8, 8, 512, 512, 64, False),     # MHA
        (1, 4, 2, 200, 200, 128, True),     # uneven T
        (2, 8, 2, 1, 300, 64, True),        # one query against 300 keys
        (2, 4, 4, 128, 128, 16, True),
        (1, 4, 2, 256, 256, 32, False),
        (1, 4, 2, 64, 300, 128, True),      # S < T: q_offset = 236
    ]
    for D in HEAD_DIMS:  # every instantiation of both kernels
        cases += [
            (1, 16, 2, 200, 200, D, True),  # groups of 8, T % 64 != 0, the model's views
            (2, 8, 2, 70, 130, D, True),    # groups of 4, S < T: q_offset = 60
            (1, 4, 4, 1, 77, D, True),      # S = 1
            (1, 8, 2, 100, 100, D, False),
        ]
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for B, Hq, Hkv, S, T, D, causal in cases:
            q, k, v = _qkv_views(B, Hq, Hkv, S, T, D, dtype, g, dev)
            out_r, lse_r = ref.flash_attention_fwd_ref(q, k, v, causal=causal)
            out, lse = flash_attention_fwd(q, k, v, causal=causal)
            e, ok = err_vs(out, out_r, dtype)
            e_lse = float((lse - lse_r).abs().max())
            worst = max(worst, e)
            log("kernels", f"flash {str(dtype)[6:]} ({_plan(q, k, v)}) B={B} Hq={Hq} Hkv={Hkv} "
                f"S={S} T={T} D={D} causal={causal} out_err={e:.3e} lse_err={e_lse:.3e}")
            check(ok and e_lse <= LSE_TOL, f"flash {dtype} {(B, Hq, Hkv, S, T, D, causal)} "
                  f"out {e} lse {e_lse}")

    # a bf16 view off the 16-byte grid: the wrapper refuses it, and so does
    # the launcher behind it
    base = torch.zeros(2 * 4 * 64 * 64 + 1, device=dev, dtype=torch.bfloat16)
    q = base[1:].view(2, 4, 64, 64)
    before = flash_attention_fwd.launches
    for launch in (lambda: flash_attention_fwd(q, q, q),
                   lambda: load_kernels().flash_attention_fwd(
                       q, q, q, torch.empty_like(q), torch.empty(2, 4, 64, device=dev),
                       True, 0.125, 0)):
        try:
            launch()
        except (ValueError, RuntimeError) as exc:
            log("kernels", f"flash bf16 unaligned view refused: {str(exc).splitlines()[0]}")
        else:
            raise SmokeFailure("an unaligned bf16 view was launched")
    check(flash_attention_fwd.launches == before, "an unaligned launch was counted")

    dtype = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t = {}
    for name, (B, Hq, Hkv, S, T, D, causal) in (("", cases[0]), *(
            (f"{m}_", shape) for m, shape in FLASH_MODEL_SHAPES.items())):
        nbytes = (2 * B * Hq * S * D + 2 * B * Hkv * T * D) * 2 + B * Hq * S * 4
        # the (q, k) pairs the mask leaves: each query sees the keys up to its
        # position when causal, all T otherwise
        pairs = sum(min(T - S + i + 1, T) for i in range(S)) if causal else S * T
        ops = 4.0 * B * Hq * D * pairs
        sets = copies(lambda: _qkv_views(B, Hq, Hkv, S, T, D, dtype, g, dev), nbytes)
        t |= _times(name, lambda q, k, v: flash_attention_fwd(q, k, v, causal=causal), sets)
        t |= _times(f"{name}plain_",
                    lambda q, k, v: ref.flash_attention_fwd_ref(q, k, v, causal=causal), sets)
        t |= _times(f"{name}library_",
                    lambda q, k, v: sdpa(q, k, v, is_causal=causal, enable_gqa=True), sets)
        # SDPA picks cuDNN's wgmma kernel here; its FA2 backend is an mma.sync
        # kernel like this one
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            fa2_ms = time_ms(lambda q, k, v: sdpa(q, k, v, is_causal=causal, enable_gqa=True),
                             sets)[0]
        del sets
        bms, by = bound_ms(nbytes, ops, dtype)
        t |= {f"{name}bound_ms": bms, f"{name}bound_by": by}
        ms, lib = t[f"{name}ms"], t[f"{name}library_ms"]
        log("kernels", f"flash timing bf16 {(B, Hq, Hkv, S, T, D)} causal={causal}: kernel "
            f"{ms:.4f} ms "
            f"(call {t[name + 'call_ms']:.4f}), plain {t[name + 'plain_ms']:.4f} "
            f"({t[name + 'plain_call_ms']:.4f}), sdpa {lib:.4f} "
            f"({t[name + 'library_call_ms']:.4f}), sdpa's FA2 backend {fa2_ms:.4f}, bound "
            f"{bms:.4f} ms ({by}); kernel {ops / ms / 1e9:.2f} TFLOP/s, sdpa "
            f"{ops / lib / 1e9:.2f} TFLOP/s, kernel / sdpa {ms / lib:.3f}, bound / kernel "
            f"{bms / ms:.3f}")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:108",
            "max_abs_err": worst, **t}


def _ssd_inputs(B, S, H, P, N, dtype, seed, dev):
    """x, dt, A, Bm, C, D as tests/test_kernels.py draws them, from a seeded
    CPU generator (the same numbers on every machine); x, Bm and C are views
    of one (B, S, H*P + 2N) tensor, as the model hands them over."""
    g = torch.Generator().manual_seed(seed)
    xbc = torch.randn(B, S, H * P + 2 * N, generator=g).to(dev, dtype)
    x, Bm, C = torch.split(xbc, [H * P, N, N], dim=-1)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g)).to(dev, dtype)
    A = -torch.exp(torch.randn(H, generator=g)).to(dev)
    D = torch.randn(H, generator=g).to(dev)
    return x.reshape(B, S, H, P), dt, A, Bm, C, D


def ssd_ops(B, S, H, P, N, chunk) -> float:
    """Operations the chunked scan needs at this shape: in each chunk of l
    steps the causal pairs of C B^T and of S x, then C h^T and the state
    update, 2 flops per multiply-add."""
    total = 0
    for t0 in range(0, S, chunk):
        l = min(chunk, S - t0)
        pairs = l * (l + 1) // 2
        total += 2 * (pairs * N + pairs * P + 2 * l * N * P)
    return float(total * B * H)


def _ssd_bytes(B, S, H, P, N) -> int:
    """x, dt, B and C read once and y written once in bf16, the f32 state
    written once, A and D read once."""
    return (2 * B * S * H * P + 2 * B * S * N + B * S * H) * 2 + B * H * P * N * 4 + 2 * H * 4


def ssd_phase(dev) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels._build import load_kernels
    from repro_torch.kernels.ssd import DEFAULT_CHUNK, ssd_scan_fwd

    cases = [  # B, S, H, P, N, chunk
        (4, 2048, 32, 64, 128, DEFAULT_CHUNK),  # the mamba2-370m forward's shape
        (2, 1024, 50, 64, 16, DEFAULT_CHUNK),   # hymba-1.5b's ssm heads
        (1, 2048, 50, 64, 16, DEFAULT_CHUNK),   #   and its banded forward's
        (1, 128, 2, 32, 16, 64),                # the cases of tests/test_kernels.py
        (2, 300, 4, 64, 32, 128),               #   uneven chunks
        (1, 64, 1, 16, 8, 256),                 #   chunk > seq
        (3, 1, 4, 64, 128, DEFAULT_CHUNK),      # one step
    ]
    worst = 0.0
    path_of = {torch.bfloat16: "tensor_cores", torch.float32: "cuda_cores"}
    for dtype in (torch.bfloat16, torch.float32):
        before = dict(ssd_scan_fwd.paths)
        for i, (B, S, H, P, N, chunk) in enumerate(cases):
            args = _ssd_inputs(B, S, H, P, N, dtype, 10 + i, dev)
            y, state = ssd_scan_fwd(*args, chunk=chunk)
            y_r, state_r = ref.ssd_scan(*args, return_state=True)
            if dtype == torch.float32:
                e = float((y - y_r).abs().max())
                ok = e <= SSD_TOL
            else:
                e, ok = err_vs(y, y_r, dtype)
            e_state = float((state - state_r).abs().max())
            worst = max(worst, e)
            log("kernels", f"ssd {str(dtype)[6:]} ({path_of[dtype]}) B={B} S={S} H={H} P={P} "
                f"N={N} chunk={chunk} y_err={e:.3e} (|y| <= {float(y_r.float().abs().max()):.1f})"
                f" state_err={e_state:.3e}")
            check(ok and e_state <= SSD_TOL and y.dtype == dtype,
                  f"ssd {dtype} {(B, S, H, P, N, chunk)} y {e} state {e_state}")
        took = {k: v - before.get(k, 0) for k, v in ssd_scan_fwd.paths.items()
                if v != before.get(k, 0)}
        check(took == {path_of[dtype]: len(cases)}, f"ssd {dtype} took the paths {took}")

    # a bf16 view off the 16-byte grid: the wrapper refuses it, and so does
    # the launcher behind it
    B, S, H, P, N = 1, 64, 2, 64, 16
    buf = torch.zeros(B * S * (H * P + 2 * N) + 1, device=dev, dtype=torch.bfloat16)
    x, Bm, C = torch.split(buf[1:].view(B, S, H * P + 2 * N), [H * P, N, N], dim=-1)
    x = x.reshape(B, S, H, P)
    dt = torch.ones(B, S, H, device=dev, dtype=torch.bfloat16)
    A, D = -torch.ones(H, device=dev), torch.ones(H, device=dev)
    before = ssd_scan_fwd.launches
    for launch in (lambda: ssd_scan_fwd(x, dt, A, Bm, C, D),
                   lambda: load_kernels().ssd_scan_fwd(
                       x, dt, A, Bm, C, D, torch.empty(B, S, H, P, device=dev,
                                                       dtype=torch.bfloat16),
                       torch.empty(B, H, P, N, device=dev), DEFAULT_CHUNK)):
        try:
            launch()
            torch.cuda.synchronize()
        except (ValueError, RuntimeError) as exc:
            log("kernels", f"ssd bf16 unaligned view refused: {str(exc).splitlines()[0]}")
        else:
            raise SmokeFailure("an unaligned bf16 ssd view was launched")
    check(ssd_scan_fwd.launches == before, "an unaligned ssd launch was counted")

    dtype = torch.bfloat16
    t = {}
    for name, (B, S, H, P, N) in (("", cases[0][:5]), ("hymba_", cases[1][:5])):
        nbytes = _ssd_bytes(B, S, H, P, N)
        sets = copies(lambda: _ssd_inputs(B, S, H, P, N, dtype, 20, dev), nbytes)
        t |= _times(name, lambda *a: ssd_scan_fwd(*a), sets)
        bms, by = bound_ms(nbytes, ssd_ops(B, S, H, P, N, DEFAULT_CHUNK), dtype)
        t |= {f"{name}bound_ms": bms, f"{name}bound_by": by}
        t |= _times(f"{name}plain_", lambda *a: ref.ssd_scan(*a, return_state=True), sets,
                    iters=2)
        if name == "":
            # the chunk is the kernel's choice: both that it takes, in turns
            other = 128 if DEFAULT_CHUNK == 64 else 64
            chunk_ms = {c: [] for c in (DEFAULT_CHUNK, other)}
            for c in (DEFAULT_CHUNK, other, other, DEFAULT_CHUNK):
                chunk_ms[c].append(time_ms(lambda *a: ssd_scan_fwd(*a, chunk=c), sets)[0])
            t["chunk_ms"] = chunk_ms
            log("kernels", f"ssd bf16 {(B, S, H, P, N)} device ms by chunk, in turns: {chunk_ms}")
        del sets
        ops = ssd_ops(B, S, H, P, N, DEFAULT_CHUNK)
        log("kernels", f"ssd timing bf16 {(B, S, H, P, N)} chunk {DEFAULT_CHUNK}: kernel "
            f"{t[name + 'ms']:.4f} ms (call {t[name + 'call_ms']:.4f}), "
            + f"plain {t[name + 'plain_ms']:.4f} ms ({t[name + 'plain_call_ms']:.4f}), "
            f"no library call, bound {bms:.4f} ms ({by}), "
            f"{ops / t[name + 'ms'] / 1e9:.2f} TFLOP/s, {nbytes / t[name + 'ms'] / 1e6:.1f} GB/s, "
            f"bound / kernel {bms / t[name + 'ms']:.3f}")
    return {"name": "ssd_scan_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd.cu",
            "replaces": "src/repro/kernels/ssd.py:97",
            "max_abs_err": worst, **t, "library_ms": None, "library_call_ms": None}


# ---------------------------------------------------------------------------
# phases 4-5: the main paths
# ---------------------------------------------------------------------------

def _plain(cfg):
    """The same model config through the kernels' plain versions."""
    return dataclasses.replace(cfg, attn_impl="torch", norm_impl="torch", ssm_impl="torch")


def reset_counts(counters) -> None:
    for c in counters:
        c.launches = 0
        for by in ("shapes", "paths"):
            if hasattr(c, by):
                getattr(c, by).clear()


def read_counts(counters) -> tuple[dict, dict]:
    """Each kernel's launches since reset_counts, and by shape where its
    wrapper counts them so."""
    return ({c.__name__: c.launches for c in counters},
            {c.__name__: collections.Counter(c.shapes) for c in counters
             if hasattr(c, "shapes")})


def _serve_cfg(arch, dtype, **kw):
    """The model config of the cached paths. For moe, capacity factor 8.0:
    the capacity depends on the number of tokens, so a prefill, its decode
    steps and the teacher-forced forward drop different assignments at the
    default 1.25 (tests/test_models.py does the same)."""
    from repro_torch.models import lm

    if arch.family == "moe":
        kw.setdefault("capacity_factor", MOE_SERVE_CAPACITY)
    return lm.ModelCfg(dtype=dtype, **kw)


def stub_inputs(arch, B: int, dev, seed: int, dtype=torch.bfloat16) -> dict:
    """The family's stub inputs from a seeded generator: encdec's encoder
    frames (B, encoder_seq, d), vlm's patch embeddings in front of the text
    (B, frontend_seq, d); none for the other families."""
    if arch.family == "encdec":
        name, n = "enc_features", arch.encoder_seq
    elif arch.frontend_stub and arch.frontend_seq:
        name, n = "frontend", arch.frontend_seq
    else:
        return {}
    g = torch.Generator(device=dev).manual_seed(seed)
    return {name: torch.randn(B, n, arch.hidden, generator=g, device=dev).to(dtype)}


def _frontend_len(batch: dict) -> int:
    return batch["frontend"].shape[1] if "frontend" in batch else 0


def reduced_phase(dev, name: str) -> None:
    """Small input, f32: kernels == plain versions, and prefill + decode ==
    teacher forcing, at the 1e-4 of tests/test_models.py."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import lm

    arch = get_reduced(name)
    params = lm.init_params(arch, torch.Generator(device=dev).manual_seed(3),
                            torch.float32, dev)
    toks = torch.randint(0, arch.vocab, (2, 12), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(4))
    batch = {"tokens": toks, **stub_inputs(arch, 2, dev, 4, torch.float32)}
    F = _frontend_len(batch)
    cfg = _serve_cfg(arch, torch.float32)
    full = lm.forward_logits(params, arch, cfg, batch)
    plain = lm.forward_logits(params, arch, _plain(cfg), batch)
    e_plain = float((full - plain).abs().max())
    caches = lm.init_caches(arch, cfg, 2, F + 16, enc_features=batch.get("enc_features"),
                            params=params, device=dev)
    lg, caches = lm.prefill(params, arch, cfg, caches, toks[:, :10],
                            frontend=batch.get("frontend"))
    e_pre = float((lg - full[:, :F + 10]).abs().max())
    lg1, caches = lm.decode_step(params, arch, cfg, caches, toks[:, 10:11], F + 10)
    lg2, caches = lm.decode_step(params, arch, cfg, caches, toks[:, 11:12], F + 11)
    e_dec = max(float((lg1[:, 0] - full[:, F + 10]).abs().max()),
                float((lg2[:, 0] - full[:, F + 11]).abs().max()))
    log("forward", f"reduced {name} f32: kernels vs plain {e_plain:.3e}, prefill vs "
        f"teacher forcing {e_pre:.3e}, decode vs teacher forcing {e_dec:.3e} "
        f"(bound {REDUCED_TOL})")
    check(max(e_plain, e_pre, e_dec) <= REDUCED_TOL, f"reduced {name} parity")


def _first_layers(params: dict, n: int) -> dict:
    """params with each per-layer leaf cut to its first n layers (views)."""
    from repro_torch.models import lm

    return dict(params, layers=lm._tree_map(lambda x: x[:n], params["layers"]))


def forward_phase(dev, name, arch, params, counters, expect: dict, main_bs,
                  compare_bs, f32_layers=None) -> tuple[dict, dict]:
    """forward_logits at main_bs = (B, S) text tokens (behind the stub's
    positions for vlm; encdec's frames besides) through the kernels, the main
    path whose launches are counted (read_counts); then kernels against plain
    versions at compare_bs (the plain SSD is a loop over S, so mamba2
    compares shorter), in bf16 at full depth and in f32 over the first
    f32_layers layers (all where None)."""
    from repro_torch.models import lm

    B, S = main_bs
    toks = torch.randint(0, arch.vocab, (B, S), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(5))
    batch = {"tokens": toks, **stub_inputs(arch, B, dev, 5)}
    F = _frontend_len(batch)
    cfg = lm.ModelCfg(dtype=torch.bfloat16)
    plain_cfg = _plain(cfg)
    torch.cuda.synchronize()
    reset_counts(counters)
    t0 = time.perf_counter()
    logits = lm.forward_logits(params, arch, cfg, batch)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    counts, shapes = read_counts(counters)
    ssd = next(c for c in counters if c.__name__ == "ssd_scan_fwd")
    paths = dict(ssd.paths)
    want_paths = {"tensor_cores": expect["ssd_scan_fwd"]} if expect["ssd_scan_fwd"] else {}
    norm_paths = _norm_paths(counters)
    what = f"{arch.name} B={B} S={S}" + (f" behind {F} frontend positions" if F else "") + (
        f", {arch.encoder_seq} encoder frames" if "enc_features" in batch else "")
    log("forward", f"{what}: launches {counts} (expect {expect}); ssd "
        f"launches by path {paths} (expect {want_paths}); rmsnorm launches by kernel "
        f"{norm_paths}")
    check(counts == expect, "forward launch counts")
    check(paths == want_paths, "the bf16 forward's SSD launches took another path")
    check(norm_paths == {"vector": expect["rmsnorm_fwd"]},
          "the forward's RMSNorm launches took another kernel")
    check(tuple(logits.shape) == (B, F + S, arch.vocab), f"logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    del logits
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        lm.forward_logits(params, arch, cfg, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    log("forward", f"{what} warm forward wall ms through the kernels: "
        f"{walls} (first call {t_fwd * 1e3:.1f} ms)")

    B, S = compare_bs
    batch = {k: (x[:B, :S] if k == "tokens" else x[:B]) for k, x in batch.items()}
    logits, ref_logits = kernels_and_plain(params, arch, cfg, batch, "bf16")
    max_abs, max_rel, agree = _compare_logits(logits, ref_logits)
    abs_bound, agree_bound = BF16_BOUNDS[name]
    log("forward", f"{arch.name} B={B} S={S} bf16 kernels vs plain: max_abs {max_abs:.4f}, "
        f"max_rel {max_rel:.4e}, argmax agreement {agree:.4f} (bounds: max_abs <= "
        f"{abs_bound}, agreement >= {agree_bound})")
    check(max_abs <= abs_bound and agree >= agree_bound, "forward parity")
    del logits, ref_logits

    # warm wall times, in turns: kernels, plain, plain, kernels
    times = {"kernels": [], "plain": []}
    for which in ("kernels", "plain", "plain", "kernels"):
        t0 = time.perf_counter()
        lm.forward_logits(params, arch, cfg if which == "kernels" else plain_cfg, batch)
        torch.cuda.synchronize()
        times[which].append((time.perf_counter() - t0) * 1e3)
    log("forward", f"{arch.name} B={B} S={S} warm forward wall ms: kernels "
        f"{times['kernels']}, plain {times['plain']}")

    arch32, p32 = arch, params
    if f32_layers is not None:
        arch32 = dataclasses.replace(arch, num_layers=f32_layers)
        p32 = _first_layers(params, f32_layers)
    p32 = lm.cast_params(p32, torch.float32)
    cfg32 = lm.ModelCfg(dtype=torch.float32)
    l32, r32 = kernels_and_plain(p32, arch32, cfg32, batch, "f32")
    max_abs, max_rel, agree = _compare_logits(l32, r32)
    log("forward", f"{arch.name} f32 (same weights, {arch32.num_layers} of "
        f"{arch.num_layers} layers) kernels vs plain: max_abs {max_abs:.3e}, "
        f"max_rel {max_rel:.3e}, argmax agreement {agree:.4f} (bounds: max_abs <= "
        f"{F32_MAX_ABS}, agreement >= {F32_ARGMAX_MIN})")
    check(max_abs <= F32_MAX_ABS and agree >= F32_ARGMAX_MIN, "f32 forward parity")
    return counts, shapes


class RoutingReplay:
    """For the with block, repro_torch.models.moe.select records the experts
    each of its calls chose (``RoutingReplay()``), or hands back those of a
    recorded run in the same order (``RoutingReplay(recorded)``), with gates
    from the call's own router logits at those experts. Top-k is
    discontinuous: an f32 difference of 1e-5 in a layer's input flips a
    near-tie between two experts, and at a full capacity that moves other
    assignments to the drop slot. Replaying the kernel path's choices in the
    plain path holds the kernels to the plain versions on the same dispatch;
    ``flips`` counts the token-layers whose own choice would have differed."""

    def __init__(self, recorded=None):
        self.recorded, self.experts, self.flips, self.rows = recorded, [], 0, 0

    def __enter__(self):
        from repro_torch.models import moe

        self._moe, self._real = moe, moe.select
        replay = iter(self.recorded or ())

        def select(p, xt, top_k):
            gates, experts = self._real(p, xt, top_k)
            if self.recorded is None:
                self.experts.append(experts)
                return gates, experts
            want = next(replay)
            self.rows += want.shape[0]
            self.flips += int((experts.sort(-1).values != want.sort(-1).values).any(-1).sum())
            logits = xt.float() @ p["router"].float()
            return torch.softmax(logits.gather(-1, want), dim=-1).to(xt.dtype), want

        moe.select = select
        return self

    def __exit__(self, *exc):
        self._moe.select = self._real


def kernels_and_plain(params, arch, cfg, batch: dict, what: str):
    """forward_logits of batch through the kernels and through the plain
    versions. For moe, the plain run replays the kernel run's expert choices
    (RoutingReplay); the plain run on its own choices is held to the argmax
    agreement bound of cfg's dtype and, in f32, to MOE_F32_FLIP_SHARE."""
    from repro_torch.models import lm

    if arch.family != "moe":
        return (lm.forward_logits(params, arch, cfg, batch),
                lm.forward_logits(params, arch, _plain(cfg), batch))
    with RoutingReplay() as rec:
        logits = lm.forward_logits(params, arch, cfg, batch)
    with RoutingReplay(rec.experts) as rep:
        ref_logits = lm.forward_logits(params, arch, _plain(cfg), batch)
    own = lm.forward_logits(params, arch, _plain(cfg), batch)
    max_abs, max_rel, agree = _compare_logits(logits, own)
    f32 = cfg.dtype == torch.float32
    agree_bound = F32_ARGMAX_MIN if f32 else BF16_BOUNDS[arch.name][1]
    flip_bound = f", bound <= {MOE_F32_FLIP_SHARE}" if f32 else ", a reading"
    log("forward", f"{arch.name} {what} kernels vs plain on its own routing: max_abs "
        f"{max_abs:.4e} (a reading), max_rel {max_rel:.4e}, argmax agreement {agree:.4f} "
        f"(bound >= {agree_bound}); the plain run's own top-{arch.top_k} differs at "
        f"{rep.flips} of {rep.rows} token-layers ({rep.flips / rep.rows:.2e}{flip_bound})")
    check(agree >= agree_bound, f"{what} moe forward vs plain on its own routing")
    check(not f32 or rep.flips <= MOE_F32_FLIP_SHARE * rep.rows,
          "f32 moe forward: the plain run's own routing differs too often")
    return logits, ref_logits


def _norm_paths(counters) -> dict:
    """RMSNorm's launches by kernel since reset_counts: on the main paths all
    take the vector kernel, the q/k norms on views of the fused product."""
    return dict(next(c for c in counters if c.__name__ == "rmsnorm_fwd").paths)


def _compare_logits(got, want) -> tuple[float, float, float]:
    diff = (got.float() - want.float()).abs()
    max_abs = float(diff.max())
    return (max_abs, max_abs / float(want.float().abs().max()),
            float((got.argmax(-1) == want.argmax(-1)).float().mean()))


def kv_cache_bytes(arch, cfg, B: int, max_len: int) -> int:
    """Bytes of the KV cache (k, v and, under kv_cache_quant, their scales)
    that init_caches allocates, counted on the meta device; for encdec also
    the cross K/V it keeps from the encoder pass, counted from their shape."""
    from repro_torch.models import lm

    self_attn = dataclasses.replace(arch, family="dense") if arch.family == "encdec" else arch
    caches = lm.init_caches(self_attn, cfg, B, max_len, device="meta")
    n = sum(t.numel() * t.element_size() for name, t in caches.items()
            if name in ("k", "v", "k_scale", "v_scale"))
    if arch.family == "encdec":
        n += (2 * arch.num_layers * B * arch.kv_heads * arch.encoder_seq * arch.head_dim
              * cfg.dtype.itemsize)
    return n


def serve_phase(dev, name, arch, params, counters, per_forward: dict, *, B: int = 4,
                P: int = 128, N: int = 32, max_len: int = 256, cfg=None, busy: bool = True,
                label: str = "", cache_pass=None):
    """ServeEngine.generate of B prompts of P tokens and N new ones, with the
    family's stub inputs (stub_inputs: encdec's frames, encoded into the
    cache; vlm's F patch embeddings in front of each prompt, so decoding
    starts at F + P). per_forward: each kernel's launches in one cached
    forward; generate runs N + 1 of them (the prefill and N decode steps),
    after cache_pass's launches where given (the cache's encoder pass). The
    greedy tokens are held against the teacher-forced argmax through the
    kernels (cfg: the model config, by default _serve_cfg's in bf16).
    Returns read_counts after generate, the GenerateResult and the median
    decode step in ms."""
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine

    expect = {k: (N + 1) * v + (cache_pass or {}).get(k, 0) for k, v in per_forward.items()}
    cfg = cfg or _serve_cfg(arch, torch.bfloat16)
    engine = ServeEngine(arch, cfg, params, max_len=max_len)
    prompts = np.random.default_rng(6).integers(0, arch.vocab, size=(B, P))
    stub = stub_inputs(arch, B, dev, 6)
    F = _frontend_len(stub)
    what = (f"{arch.name}{label} B={B} prompt={P}" + (f" behind {F} frontend positions"
                                                      if F else "")
            + f" new={N} max_len={max_len}")
    torch.cuda.synchronize()
    reset_counts(counters)
    res = engine.generate(prompts, max_new_tokens=N, **stub)
    counts, shapes = read_counts(counters)
    norm_paths = _norm_paths(counters)
    steps = res.step_times[res.warmup_steps:]
    med = statistics.median(steps)
    log("serve", f"{what}: launches {counts} (expect "
        f"{expect}); prefill {res.prefill_time * 1e3:.2f} ms, median decode step "
        f"{med * 1e3:.3f} ms (first step {res.step_times[0] * 1e3:.3f} ms), decode "
        f"{B / med:.1f} tokens/s; KV cache {kv_cache_bytes(arch, cfg, B, max_len)} bytes")
    check(counts == expect, "serve launch counts")
    check(norm_paths == {"vector": expect["rmsnorm_fwd"]},
          f"serve's RMSNorm launches took the kernels {norm_paths}")
    check(res.tokens.shape == (B, P + N) and (res.tokens[:, :P] == prompts).all()
          and res.tokens.min() >= 0 and res.tokens.max() < arch.vocab, "serve tokens")
    # greedy tokens against teacher forcing over the generated sequence
    seq = torch.as_tensor(res.tokens, device=dev)
    with torch.inference_mode():
        tf = lm.forward_logits(params, arch, cfg, {"tokens": seq[:, :-1], **stub})
    agree = float((tf[:, F + P - 1:].argmax(-1) == seq[:, P:]).float().mean())
    del tf
    agree_bound = BF16_BOUNDS[name][1]
    log("serve", f"{what} greedy tokens vs teacher-forced argmax (through the kernels): "
        f"agreement {agree:.4f} (bound >= {agree_bound})")
    check(agree >= agree_bound, "serve vs teacher forcing")
    if busy:
        # device busy share while decoding (warm engine, a few steps)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            r4 = engine.generate(prompts, max_new_tokens=4, **stub)
        busy_ms = device_us(prof) / 1e3
        twice_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
        wall_ms = (r4.prefill_time + sum(r4.step_times)) * 1e3
        log("serve", f"{what} profiled generate (prefill + 4 steps): wall {wall_ms:.1f} ms, "
            f"device kernels {busy_ms:.1f} ms, busy share {busy_ms / wall_ms:.3f} (the sum "
            f"over key_averages(), which counts an op's kernels twice: {twice_ms:.1f} ms)")
        check(busy_ms > 0, "the profiler saw no device time")
    return (counts, shapes), res, med * 1e3


def model_phases(dev, name: str, counters, expect_forward: dict, expect_cached: dict,
                 main_bs, compare_bs, extra=None, serve=None, cache_pass=None,
                 f32_layers=None) -> list[tuple[str, dict, dict]]:
    """Phases 4 and 5 for one model at full width and depth, and extra(dev,
    arch, params, counters, serve_result, decode_ms) where given: the
    family's own runs. serve: serve_phase's B, P, N and max_len where they
    differ from its defaults; cache_pass: the launches of the cache's
    encoder pass (encdec); f32_layers: the depth of the f32 kernels-vs-plain
    forward where the whole model would not fit in f32. Returns (label,
    launches, launches by shape) for each main-path run."""
    from repro_torch.configs import get_arch
    from repro_torch.models import lm

    with torch.inference_mode():
        reduced_phase(dev, name)
        arch = get_arch(name)
        t0 = time.perf_counter()
        params = lm.init_params(arch, torch.Generator(device=dev).manual_seed(0),
                                torch.bfloat16, dev)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params))
        log("forward", f"{name} params {n_params / 1e9:.4f} B in bf16 "
            f"({torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB), init "
            f"{time.perf_counter() - t0:.1f} s")
        fwd = forward_phase(dev, name, arch, params, counters, expect_forward, main_bs,
                            compare_bs, f32_layers)
    serve = serve or {}
    srv, res, decode_ms = serve_phase(dev, name, arch, params, counters, expect_cached,
                                      cache_pass=cache_pass, **serve)
    F = arch.frontend_seq if arch.family == "vlm" else 0
    runs = [(f"{name} forward B={main_bs[0]} S={F + main_bs[1]}", *fwd),
            (f"{name} serve {serve.get('B', 4)} x {F + serve.get('P', 128)} + "
             f"{serve.get('N', 32)}", *srv)]
    if extra is not None:
        runs += extra(dev, arch, params, counters, res, decode_ms)
    log("serve", f"{name} peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return runs


# hymba-1.5b: per forward, ln1 and ln2 in each of its 32 layers and the final
# norm through K1; attention through K2 while S <= its window of 1024 and
# through banded_flash_xla past it; the full-sequence SSD scan through K3.
# The cached paths (prefill and decode) run attention through flash_xla and
# the plain scan on the cache, as the JAX package does: K1 only.
HYMBA_BANDED_BS = (1, 2048)
HYMBA_SERVE_MAX_LEN = 160  # 4 x 128 + 32: a ring of 160 slots that never wraps
# the serve run whose prefill fills the 1024-slot ring (ring prefill through
# banded_flash_xla and the roll) and whose every decode step wraps it
HYMBA_RING_SERVE = dict(B=2, P=1024, N=32, max_len=1056)
# the serve options of the JAX package, all three on the 4 x 128 + 32 run
KV_OPTIONS = dict(kv_cache_quant=True, decode_dense_attn=True, kv_scatter_write=True)
# The options against the default cache, f32 on the same weights, the same
# tokens through prefill and KV_OPTION_STEPS decode steps, logits step by
# step: (B, prompt, max_len) of the 4 x 128 + 32 run and of one whose prefill
# fills the 1024-slot ring and whose every step wraps it.
#   Dense decode attention with scatter writes, against the default cache and
#   under int8 against the int8 cache alone, only reorders f32 sums:
#   F32_MAX_ABS.
#   Layer 0's K and V depend on the tokens alone, so its int8 cache, read
#   back as the attention reads it (_kv_dequantize), is held slot by slot to
#   the default's, in steps of the row's stored bf16 scale:
#   rounding to the nearest step is half a step, and the scale's own bf16
#   rounding (2^-8 of it at most) adds 127 x 2^-8 of one, so (0.5 + 127 x
#   2^-8) / (1 - 2^-8) = 1.0 at most, and the f32 products a little more.
#   The int8 cache's logits against the default's: a rounding of K and V of
#   a bf16 rounding's order, which the 32 layers carry as they carry bf16's,
#   so hymba's bf16 bound on the max abs logit difference. An H100 read 0.064
#   of the largest logit over the 4 x 128 prefill, 0.024 in decode; the CPU
#   tests' 0.02 holds at their 2 layers.
KV_OPTION_RUNS = ((4, 128, HYMBA_SERVE_MAX_LEN), (1, 1024, 1024 + 8))
KV_OPTION_STEPS = 8
KV_QUANT_STEPS = 1.001


def kv_options_vs_default(dev, arch, params) -> None:
    """Prefill and KV_OPTION_STEPS decode steps under the default cache,
    decode_dense_attn + kv_scatter_write, kv_cache_quant alone and
    KV_OPTIONS (params in f32), held to each other as set out above."""
    from repro_torch.models import lm

    dense = {k: v for k, v in KV_OPTIONS.items() if k != "kv_cache_quant"}
    settings = {"default": {}, "dense": dense, "int8": {"kv_cache_quant": True},
                "all": KV_OPTIONS}
    abs_bound = BF16_BOUNDS[arch.name][0]
    for B, P, max_len in KV_OPTION_RUNS:
        toks = torch.randint(0, arch.vocab, (B, P + KV_OPTION_STEPS), device=dev,
                             generator=torch.Generator(device=dev).manual_seed(21))
        logits, layer0 = {}, {}
        for name, opts in settings.items():
            cfg = _serve_cfg(arch, torch.float32, **opts)
            caches = lm.init_caches(arch, cfg, B, max_len, device=dev)
            lg, caches = lm.prefill(params, arch, cfg, caches, toks[:, :P])
            steps = [lg]
            for i in range(P, P + KV_OPTION_STEPS):
                lg, caches = lm.decode_step(params, arch, cfg, caches, toks[:, i:i + 1], i)
                steps.append(lg)
            logits[name] = torch.cat(steps, dim=1).float()
            layer0[name] = {n: t[0].clone() for n, t in caches.items()
                            if n in ("k", "v", "k_scale", "v_scale")}
            del caches, steps, lg
        want = logits["default"]
        e_dense = float((logits["dense"] - want).abs().max())
        e_opts = float((logits["all"] - logits["int8"]).abs().max())
        e_slot = 0.0
        for name in ("int8", "all"):
            for kv in ("k", "v"):
                q, scale = layer0[name][kv], layer0[name][f"{kv}_scale"]
                err = (lm._kv_dequantize(q, scale, torch.float32) - layer0["default"][kv]).abs()
                e_slot = max(e_slot, float((err / scale.float()[..., None].clamp(min=1e-30))
                                           .max()))
        T = min(max_len, arch.sliding_window)
        what = (f"{arch.name} f32 B={B} prompt={P} + {KV_OPTION_STEPS} steps, {T}-slot cache "
                f"(positions up to {P + KV_OPTION_STEPS - 1})")
        log("serve", f"{what}: {sorted(dense)} vs the default cache max_abs {e_dense:.3e}, "
            f"{sorted(KV_OPTIONS)} vs kv_cache_quant alone {e_opts:.3e} (bound "
            f"{F32_MAX_ABS}); layer 0's int8 K/V within {e_slot:.4f} of a scale step of "
            f"the default cache at every slot (bound {KV_QUANT_STEPS})")
        check(e_dense <= F32_MAX_ABS, f"{sorted(dense)} vs the default cache")
        check(e_opts <= F32_MAX_ABS, f"{sorted(KV_OPTIONS)} vs kv_cache_quant alone")
        check(e_slot <= KV_QUANT_STEPS, "layer 0's int8 cache vs the default cache")
        for name in ("int8", "all"):
            diff = (logits[name] - want).abs()
            rel = diff.amax(dim=(0, 2)) / want.abs().amax(dim=(0, 2))  # per position
            agree = float((logits[name].argmax(-1) == want.argmax(-1)).float().mean())
            log("serve", f"{what}: {sorted(settings[name])} vs the default cache max_abs "
                f"{float(diff.max()):.4f} (bound {abs_bound}), of the largest logit: prefill "
                f"{float(rel[:P].max()):.4f}, decode {float(rel[P:].max()):.4f}; argmax "
                f"agreement {agree:.4f}")
            check(float(diff.max()) <= abs_bound, f"{sorted(settings[name])} logits")
        del logits, want, layer0


def hymba_extra(dev, arch, params, counters, res, decode_ms) -> list[tuple[str, dict, dict]]:
    """hymba's own runs: the banded forward (K2 must not launch), the serve
    run that wraps the ring, and the 4 x 128 + 32 run under KV_OPTIONS beside
    the default one (res, decode_ms)."""
    from repro_torch.models import lm

    L = arch.num_layers
    B, S = HYMBA_BANDED_BS
    toks = torch.randint(0, arch.vocab, (B, S), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(15))
    cfg = lm.ModelCfg(dtype=torch.bfloat16)
    expect = {"rmsnorm_fwd": 2 * L + 1, "flash_attention_fwd": 0, "ssd_scan_fwd": L}
    runs = []
    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_counts(counters)
        t0 = time.perf_counter()
        logits = lm.forward_logits(params, arch, cfg, {"tokens": toks})
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts, shapes = read_counts(counters)
        log("forward", f"{arch.name} B={B} S={S} (window {arch.sliding_window}: "
            f"banded_flash_xla): launches {counts} (expect {expect}); wall {wall:.1f} ms "
            f"(first call)")
        check(counts == expect, "hymba banded forward launch counts")
        check(tuple(logits.shape) == (B, S, arch.vocab)
              and bool(torch.isfinite(logits).all()), "hymba banded forward logits")
        del logits
        runs.append((f"{arch.name} forward B={B} S={S} (banded)", counts, shapes))
        # the banded forward in f32 on the same weights, kernels vs plain
        p32 = lm.cast_params(params, torch.float32)
        l32, r32 = kernels_and_plain(p32, arch, lm.ModelCfg(dtype=torch.float32),
                                     {"tokens": toks}, "f32")
        max_abs, max_rel, agree = _compare_logits(l32, r32)
        log("forward", f"{arch.name} B={B} S={S} (banded) f32 (same weights) kernels vs plain: "
            f"max_abs {max_abs:.3e}, max_rel {max_rel:.3e}, argmax agreement {agree:.4f} "
            f"(bounds: max_abs <= {F32_MAX_ABS}, agreement >= {F32_ARGMAX_MIN})")
        check(max_abs <= F32_MAX_ABS and agree >= F32_ARGMAX_MIN,
              "hymba banded f32 forward parity")
        del l32, r32
        t0 = time.perf_counter()
        kv_options_vs_default(dev, arch, p32)
        log("serve", f"{arch.name} KV options vs the default cache done in "
            f"{time.perf_counter() - t0:.1f} s")
        del p32

    per_forward = {"rmsnorm_fwd": 2 * L + 1, "flash_attention_fwd": 0, "ssd_scan_fwd": 0}
    t0 = time.perf_counter()
    srv, _, _ = serve_phase(dev, arch.name, arch, params, counters, per_forward, busy=False,
                            label=" (ring: prefill fills it, every decode step wraps it)",
                            **HYMBA_RING_SERVE)
    log("serve", f"{arch.name} ring serve run done in {time.perf_counter() - t0:.1f} s")
    runs.append((f"{arch.name} serve 2 x 1024 + 32 (ring wraps)", *srv))

    opt_cfg = _serve_cfg(arch, torch.bfloat16, **KV_OPTIONS)
    srv, res_opt, opt_ms = serve_phase(dev, arch.name, arch, params, counters, per_forward,
                                       cfg=opt_cfg, busy=False, label=f" {KV_OPTIONS}",
                                       max_len=HYMBA_SERVE_MAX_LEN)
    runs.append((f"{arch.name} serve 4 x 128 + 32 {sorted(KV_OPTIONS)}", *srv))
    B, P = res.tokens.shape[0], res.prompt_len
    same = float((res_opt.tokens[:, P:] == res.tokens[:, P:]).mean())
    first = [int(np.argmax(a != b)) if (a != b).any() else None
             for a, b in zip(res_opt.tokens[:, P:], res.tokens[:, P:])]
    default_bytes = kv_cache_bytes(arch, _serve_cfg(arch, torch.bfloat16), B,
                                   HYMBA_SERVE_MAX_LEN)
    opt_bytes = kv_cache_bytes(arch, opt_cfg, B, HYMBA_SERVE_MAX_LEN)
    log("serve", f"{arch.name} {KV_OPTIONS} against the default cache: new tokens equal at "
        f"{same:.4f} of positions (first difference per prompt {first}); KV cache "
        f"{opt_bytes} bytes against {default_bytes} ({opt_bytes / default_bytes:.4f}); "
        f"median decode step {opt_ms:.3f} ms against {decode_ms:.3f} ms")
    check(opt_bytes < default_bytes, "the int8 cache is not smaller")
    return runs


def granite_extra(dev, arch, params, counters, res, decode_ms) -> list:
    """The share of dropped assignments at the default capacity factor, on
    the forward's tokens: a reading, not a check. An expert keeps its first C
    assignments, so each layer drops max(count - C, 0) of each expert's."""
    from repro_torch.models import lm, moe

    toks = torch.randint(0, arch.vocab, (2, 512), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(5))
    cfg = lm.ModelCfg(dtype=torch.bfloat16)
    with torch.inference_mode(), RoutingReplay() as rec:
        lm.forward_logits(params, arch, cfg, {"tokens": toks})
    C = moe.capacity(toks.numel(), arch.top_k, cfg.capacity_factor, arch.num_experts)
    dropped = [int((moe.expert_counts(e, arch.num_experts) - C).clamp(min=0).sum())
               for e in rec.experts]
    total = sum(e.numel() for e in rec.experts)
    shares = [d / e.numel() for d, e in zip(dropped, rec.experts)]
    log("forward", f"{arch.name} B=2 S=512 capacity factor {cfg.capacity_factor}: "
        f"{C} slots an expert, {sum(dropped) / total:.4f} of {total} assignments "
        f"dropped (by layer {min(shares):.4f} to {max(shares):.4f})")
    return []


# whisper-tiny: per forward, ln1 and ln2 of each encoder layer and the
# encoder's final norm, ln1, ln_cross and ln2 of each decoder layer and the
# final norm through K1; the encoder's attention (not causal) and the
# decoder's self-attention through K2; cross-attention through
# flash_xla_train, as the JAX package pins it. ServeEngine builds the cache
# with one encoder pass (WHISPER_CACHE_PASS); each cached forward then runs
# the decoder's norms and attention through flash_xla (K1 only). Forward at
# B=4: 1500 frames and 448 text tokens (the decoder's context); serve 4 x 32
# + 32.
WHISPER_BS = (4, 448)
WHISPER_SERVE = dict(P=32, max_len=64)
# pixtral-12b: 1024 patch embeddings in front of 512 text tokens, B=1; serve
# 2 x (1024 + 128) + 32, decode from position 1152. f32 kernels-vs-plain over
# its first 4 of 40 layers: f32 weights at full depth would be 51 GB beside
# the bf16 ones' 25.5 GB.
PIXTRAL_BS = (1, 512)
PIXTRAL_SERVE = dict(B=2, P=128, max_len=1024 + 128 + 32)
PIXTRAL_F32_LAYERS = 4

# the serve driver at its defaults: reduced qwen3-8b (2 layers with q/k
# norms, f32), 4 prompts of 16 tokens, 24 new ones: 25 cached forwards of 4 x
# 2 + 1 K1 launches
SERVE_DRIVER_ARGV = ["--arch", "qwen3-8b"]
SERVE_DRIVER_LAUNCHES = {"rmsnorm_fwd": 25 * (4 * 2 + 1), "flash_attention_fwd": 0,
                         "ssd_scan_fwd": 0}


def serve_driver_phase(counters) -> tuple[dict, dict]:
    """python -m repro_torch.launch.serve --arch qwen3-8b --emit-traces PATH,
    in this process: its launches, and the trace it appends, read back
    through the port's read_traces."""
    from repro_torch.calibration.traces import StepTrace, read_traces
    from repro_torch.launch import serve as driver

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "traces.jsonl")
        argv = SERVE_DRIVER_ARGV + ["--emit-traces", path]
        out = io.StringIO()
        reset_counts(counters)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = driver.main(argv)
        seconds = time.perf_counter() - t0
        counts, shapes = read_counts(counters)
        for line in out.getvalue().splitlines():
            log("serve", f"driver: {line}")
        traces = read_traces(path)
    log("serve", f"driver {' '.join(argv)} <tmp>: exit {rc} in {seconds:.1f} s; launches "
        f"{counts} (expect {SERVE_DRIVER_LAUNCHES})")
    check(rc == 0, f"the serve driver exited {rc}")
    check(counts == SERVE_DRIVER_LAUNCHES, "serve driver launches")
    check(len(traces) == 1, f"{len(traces)} traces in the serve driver's file, 1 expected")
    t = traces[0]
    check(t.source == "serve" and t.strategy.device == "H100"
          and t.strategy.num_devices == torch.cuda.device_count()
          and len(t.step_times) == 23 and t.warmup_steps_excluded == 1,
          f"the serve driver's trace: source {t.source}, device {t.strategy.device} x "
          f"{t.strategy.num_devices}, {len(t.step_times)} step times, "
          f"{t.warmup_steps_excluded} excluded")
    check(StepTrace.from_json(t.to_json()) == t, "the serve driver's trace does not round-trip")
    log("serve", f"driver trace: {t.pool_key}, strategy {t.strategy_key}, median decode step "
        f"{t.measured_step_time * 1e3:.3f} ms")
    return counts, shapes


# ---------------------------------------------------------------------------
# phase 6: training
# ---------------------------------------------------------------------------

# qwen3-8b at full width, cut to 8 of its 36 layers: f32 AdamW at full depth
# keeps 8.191e9 params x 16 B (weights, grads, two moments) = 131 GB against the
# card's 80 GB. At 8 layers, 2.788e9 params take 44.6 GB, beside the bf16 cast
# (5.6 GB), the logits (~8 GB at 4096 tokens) and the activations.
TRAIN_LAYERS = 8
TRAIN_BS = (4, 1024)
TRAIN_STEPS = 5
# The first loss of random weights: the final norm's output has unit RMS and
# the head's entries variance 1/d, so the logits are ~N(0, 1), and the
# expected cross-entropy of N(0, s^2) logits is ln(vocab) + s^2 / 2 (12.43 at
# qwen3's vocab; 12.34 at a 512-wide CPU run of the same init).
FIRST_LOSS_TOL = 0.25
# Remat: every policy runs the same bf16 forward on the same params (lr 0), so
# the losses agree unless cuBLAS takes another algorithm for a product in one
# run; this bounds that by a bf16 rounding of the logits averaged over the
# B x (S - 1) positions.
REMAT_LOSS_TOL = 1e-3
# Kernels against the plain versions and the "xla" path, one f32 step at 2
# layers: the loss, and each grad leaf by max |diff| over the leaf's max
# |value|, within 1e-4, the CPU parity bound of tests/test_torch_train.py: f32
# products summed in another order, and the plain VJPs of the backward run at
# saved activations that the kernels rounded differently.
TRAIN_F32_REL = 1e-4
# The same step in bf16 at the train path's own B, S (so K1 and K2 run at the
# 8-layer path's shapes), kernels against plain. The loss: the paths round the
# bf16 activations differently, which moves each position's logits by about a
# bf16 rounding, 2^-8 of |logit| ~ 1 (N(0, 1) logits at init), at random, so
# the mean over 4 x 1023 positions moves by ~3.9e-3 / sqrt(4092) = 6e-5 (an
# H100 read 1.0e-4; 5e-5 at B=2). 1e-3 is ten times that reading. The
# wrong kernels of tools/train_parity_control.py moved it by 1.6e-3 to 0.34.
TRAIN_BF16_LOSS_TOL = 1e-3
# Each grad leaf by max |diff| over the leaf's max |value|: the backward runs
# the plain VJPs at activations the kernels rounded differently, so the grads
# differ by bf16 roundings carried through two layers. An H100 read 2.1e-2 at
# worst (q_norm; the other leaves 0.9-1.3e-2); the wrong kernels of
# tools/train_parity_control.py read 0.105 (softmax scale 5% high) and up.
TRAIN_BF16_GRAD_REL = 5e-2
H100_BF16_FLOPS = PEAK_OPS_PER_S[torch.bfloat16]


class OptimizerTimer:
    """Wraps ``adamw_update`` where ``make_train_step`` calls it (a global of
    repro_torch.train.train_step) for the ``with`` block: records a CUDA event
    at its entry and exit, and the peak memory so far at its entry, which is
    the forward and backward's peak."""

    def __enter__(self):
        from repro_torch.train import train_step

        self._module, self._real = train_step, train_step.adamw_update
        self.events, self.fwd_bwd_peak = [], []

        def timed(*args, **kwargs):
            enter, leave = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            enter.record()
            self.fwd_bwd_peak.append(torch.cuda.max_memory_allocated())
            out = self._real(*args, **kwargs)
            leave.record()
            self.events.append((enter, leave))
            return out

        train_step.adamw_update = timed
        return self

    def __exit__(self, *exc):
        self._module.adamw_update = self._real


def timed_step(step, params, opt, batch, timer: OptimizerTimer):
    """One train step: wall ms to the loss on the host; forward + backward and
    optimizer ms by CUDA events (the optimizer's from timer)."""
    start = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    params, opt, metrics = step(params, opt, batch)
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    enter, leave = timer.events[-1]
    return params, opt, {"wall_ms": wall, "fwd_bwd_ms": start.elapsed_time(enter),
                         "opt_ms": enter.elapsed_time(leave), "loss": loss, "grad_norm": gnorm,
                         **{k: float(metrics[k]) for k in ("ce_loss", "aux_loss")
                            if k in metrics}}


class CountMM(TorchDispatchMode):
    """Counts aten.mm calls: the weight products x @ W."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func == torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def train_mfu_flops(arch, B: int, S: int) -> float:
    """Model FLOPs of one train step: 6 x the matmul params (the layers' four
    weight products and the lm head) x tokens, plus causal attention's
    6 L S H D x tokens (QK^T and PV, 2 S D a head each over half the keys, x3
    for forward and backward)."""
    d, H, Hkv, D, F = arch.hidden, arch.heads, arch.kv_heads, arch.head_dim, arch.ffn
    per_layer = d * (H + 2 * Hkv) * D + H * D * d + d * 2 * F + F * d
    matmul_params = arch.num_layers * per_layer + d * arch.vocab
    tokens = B * S
    return 6.0 * matmul_params * tokens + 6.0 * arch.num_layers * S * H * D * tokens


def _leaf_rels(got, want) -> list[float]:
    """Each leaf's max |got - want| / max |want|."""
    return [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for a, b in zip(got, want)]


def _leaf_rel(got, want) -> tuple[float, int]:
    """Worst leaf's max |got - want| / max |want|, and its index."""
    rel = _leaf_rels(got, want)
    i = max(range(len(rel)), key=rel.__getitem__)
    return rel[i], i


def train_steps_phase(dev, counters, card: str) -> tuple[tuple[dict, dict], list[dict]]:
    """Five steps at TRAIN_BS through the kernels, a profiled step, then one
    step under each remat policy. Returns read_counts of the five steps, and
    the five steps' times (timed_step's rows)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from repro_torch.train import TrainStepCfg, adamw_init, make_train_step

    arch = dataclasses.replace(get_arch("qwen3-8b"), num_layers=TRAIN_LAYERS)
    B, S = TRAIN_BS
    L = arch.num_layers
    log("train", f"qwen3-8b at full width, {L} of its 36 layers (f32 AdamW at full depth "
        f"keeps 8.191e9 params x 16 B = 131 GB against 80 GB), B={B} S={S}: f32 master "
        f"weights, bf16 compute, uniform random tokens")
    t0 = time.perf_counter()
    params = lm.init_params(arch, torch.Generator(device=dev).manual_seed(0), torch.float32,
                            dev)
    opt = adamw_init(params)
    batch = {"tokens": torch.randint(0, arch.vocab, (B, S), device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(8))}
    cfg = lm.ModelCfg(dtype=torch.bfloat16)
    step = make_train_step(arch, cfg, TrainStepCfg(num_microbatches=1, warmup_steps=2,
                                                   total_steps=10))
    n_params = sum(t.numel() for t in _leaves(params))
    torch.cuda.synchronize()
    log("train", f"params {n_params / 1e9:.4f} B, params + AdamW state "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB, init {time.perf_counter() - t0:.1f} s")

    reset_counts(counters)
    rows, peak = [], 0
    with OptimizerTimer() as timer:
        for i in range(TRAIN_STEPS):
            torch.cuda.reset_peak_memory_stats()
            params, opt, r = timed_step(step, params, opt, batch, timer)
            rows.append(r)
            peak = max(peak, torch.cuda.max_memory_allocated())
            log("train", f"step {i}: wall {r['wall_ms']:.1f} ms, forward + backward "
                f"{r['fwd_bwd_ms']:.1f} ms, optimizer {r['opt_ms']:.1f} ms, loss "
                f"{r['loss']:.4f}, grad_norm {r['grad_norm']:.4f}, peak memory "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (forward + backward "
                f"{timer.fwd_bwd_peak[-1] / 1e9:.2f})")
    counts, shapes = read_counts(counters)
    norm_paths = _norm_paths(counters)
    per_step = {"rmsnorm_fwd": 4 * L + 1, "flash_attention_fwd": L, "ssd_scan_fwd": 0}
    expect = {k: TRAIN_STEPS * v for k, v in per_step.items()}
    log("train", f"peak memory {peak / 2 ** 30:.2f} GiB ({peak / 1e9:.2f} GB; forward + "
        f"backward {max(timer.fwd_bwd_peak) / 1e9:.2f} GB); launches {counts} over "
        f"{TRAIN_STEPS} steps, per step {per_step} expected; rmsnorm launches by kernel "
        f"{norm_paths}")
    check(counts == expect, "train launch counts")
    check(norm_paths == {"vector": expect["rmsnorm_fwd"]},
          "the train step's RMSNorm launches took another kernel")
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rows),
          "non-finite train loss or grad_norm")
    first_want = math.log(arch.vocab) + 0.5
    log("train", f"first loss {rows[0]['loss']:.4f}, expected ln(vocab) + 1/2 = "
        f"{first_want:.4f} (bound {FIRST_LOSS_TOL})")
    check(abs(rows[0]["loss"] - first_want) <= FIRST_LOSS_TOL,
          f"first loss {rows[0]['loss']} not within {FIRST_LOSS_TOL} of ln(vocab) + 1/2")
    med = statistics.median(r["wall_ms"] for r in rows)
    flops = train_mfu_flops(arch, B, S)
    log("train", f"median step {med:.1f} ms, forward + backward "
        f"{statistics.median(r['fwd_bwd_ms'] for r in rows):.1f} ms, optimizer "
        f"{statistics.median(r['opt_ms'] for r in rows):.1f} ms; model FLOPs a step "
        f"{flops:.4e}; train_mfu {flops / (H100_BF16_FLOPS * med / 1e3):.4f} (of 989 TFLOP/s "
        f"bf16) on {card}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = device_us(prof) / 1e3
    log("train", f"profiled step: wall {wall_ms:.1f} ms, device kernels {busy_ms:.1f} ms, "
        f"busy share {busy_ms / wall_ms:.3f}")
    check(busy_ms > 0, "the profiler saw no device time")
    # by the aten op that launched each kernel (each kernel also has an entry
    # of its own in key_averages(), and runtime markers such as "Command
    # Buffer Full" carry device time too: neither is counted); the rest were
    # launched outside an aten op, the port's kernels through their bindings
    by_op = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
             if e.key.startswith("aten::") and e.self_device_time_total > 0}
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:12]
    log("train", "profiled step, device ms by launching op: " + ", ".join(
        f"{k} {ms:.1f}" for k, ms in top) + f"; the other aten ops "
        f"{sum(by_op.values()) - sum(ms for _, ms in top):.1f}; outside aten ops "
        f"{busy_ms - sum(by_op.values()):.1f}")
    del prof

    # remat: one step each from the same params (lr 0 leaves them as they are)
    res = {}
    for remat in ("none", "selective", "full"):
        fn = make_train_step(arch, dataclasses.replace(cfg, remat=remat),
                             TrainStepCfg(num_microbatches=1, base_lr=0.0))
        _free()
        reset_counts(counters)
        with CountMM() as mm, OptimizerTimer() as timer:
            params, opt, metrics = fn(params, opt, batch)
            loss = float(metrics["loss"])
        torch.cuda.synchronize()
        c, _ = read_counts(counters)
        # the recompute hands K1 the q/k views of the recomputed (or, under
        # "selective", the kept) qkv product: still on the vector kernel
        check(_norm_paths(counters) == {"vector": c["rmsnorm_fwd"]},
              f"remat {remat}: RMSNorm launches took the kernels {_norm_paths(counters)}")
        res[remat] = {"loss": loss, "fwd_bwd_peak": timer.fwd_bwd_peak[0],
                      "peak": torch.cuda.max_memory_allocated(), "launches": c, "mm": mm.mm}
        log("train", f"remat {remat}: loss {loss:.6f}, peak memory forward + backward "
            f"{res[remat]['fwd_bwd_peak'] / 1e9:.2f} GB, step {res[remat]['peak'] / 1e9:.2f} GB; "
            f"launches {c}; aten.mm calls {mm.mm}")
    for remat in ("selective", "full"):
        check(abs(res[remat]["loss"] - res["none"]["loss"]) <= REMAT_LOSS_TOL,
              f"remat {remat} changed the loss")
        # each checkpointed layer runs its forward again, norms and attention
        # included; the final norm lies outside the layers
        check(res[remat]["launches"] == {"rmsnorm_fwd": 2 * 4 * L + 1,
                                         "flash_attention_fwd": 2 * L, "ssd_scan_fwd": 0},
              f"remat {remat} launches")
    check(res["none"]["launches"] == per_step, "remat none launches")
    # "selective" keeps the weight products; "full" runs again each one whose
    # output the backward reads: all but a layer's last (mlp.wo), where the
    # recompute stops (torch.utils.checkpoint's early stop)
    check(res["selective"]["mm"] == res["none"]["mm"]
          and res["full"]["mm"] == res["none"]["mm"] + 3 * L,
          f"recomputed weight products {({k: v['mm'] for k, v in res.items()})}")
    peaks = [res[r]["fwd_bwd_peak"] for r in ("full", "selective", "none")]
    check(peaks == sorted(set(peaks)), f"remat peaks full < selective < none: {peaks}")
    return (counts, shapes), rows


def _loss_and_grads(params, arch, cfg, batch, counters):
    """forward_train's loss and its grads with respect to every leaf of
    params, and the kernels' launches."""
    from repro_torch.models import lm

    leaves = [t.requires_grad_() for t in _leaves(params)]
    reset_counts(counters)
    loss, _ = lm.forward_train(params, arch, cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), grads, read_counts(counters)[0]


def _parity_model(dev, seed: int):
    from repro_torch.configs import get_arch
    from repro_torch.models import lm

    arch = dataclasses.replace(get_arch("qwen3-8b"), num_layers=2)
    return arch, lm.init_params(arch, torch.Generator(device=dev).manual_seed(seed),
                                torch.float32, dev)


def bf16_step_vs_plain(dev, counters) -> dict:
    """One bf16 forward + backward of forward_train at qwen3-8b's full width,
    2 layers and the train path's B, S (TRAIN_BS: the shapes at which the
    8-layer path calls K1 and K2), through the kernels and through their plain
    versions, from the same f32 params and batch. Returns the loss gap, the
    worst grad leaf's rel (max |diff| / max |plain|), that leaf, every
    leaf's rel and the kernels' launches."""
    from repro_torch.models import lm

    arch, params = _parity_model(dev, 13)
    B, S = TRAIN_BS
    batch = {"tokens": torch.randint(0, arch.vocab, (B, S), device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(14))}
    cfg = lm.ModelCfg(dtype=torch.bfloat16)
    loss_k, grads_k, c = _loss_and_grads(params, arch, cfg, batch, counters)
    loss_p, grads_p, _ = _loss_and_grads(params, arch, _plain(cfg), batch, counters)
    rels = dict(zip(_leaf_names(params), _leaf_rels(grads_k, grads_p)))
    leaf = max(rels, key=rels.get)
    return {"loss": loss_k, "plain_loss": loss_p, "d_loss": abs(loss_k - loss_p),
            "grad_rel": rels[leaf], "leaf": leaf, "rels": rels, "launches": c}


def train_parity_phase(dev, counters) -> None:
    """Loss and every grad of one f32 step at 2 layers through the kernels,
    against the plain versions and the "xla" path; then the same in bf16 at
    the train path's shapes, against the plain versions."""
    from repro_torch.models import lm

    arch, params = _parity_model(dev, 9)
    batch = {"tokens": torch.randint(0, arch.vocab, (2, 1024), device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(10))}
    names = list(_leaf_names(params))

    def loss_and_grads(impl):
        cfg = lm.ModelCfg(dtype=torch.float32, attn_impl=impl, norm_impl=impl)
        return _loss_and_grads(params, arch, cfg, batch, counters)

    loss_k, grads_k, c = loss_and_grads("cuda")
    check(c == {"rmsnorm_fwd": 4 * 2 + 1, "flash_attention_fwd": 2, "ssd_scan_fwd": 0},
          f"f32 step launches {c}")
    for other in ("torch", "xla"):
        loss_o, grads_o, c = loss_and_grads(other)
        check(sum(c.values()) == 0, f"the {other} path launched a kernel: {c}")
        rel, i = _leaf_rel(grads_k, grads_o)
        d_loss = abs(loss_k - loss_o) / abs(loss_o)
        log("train", f"f32 step at 2 layers, B=2 S=1024, kernels vs {other}: loss {loss_k:.6f} "
            f"vs {loss_o:.6f} (rel {d_loss:.3e}), worst grad leaf {names[i]} of {len(names)} "
            f"rel {rel:.3e} (bound {TRAIN_F32_REL})")
        check(d_loss <= TRAIN_F32_REL and rel <= TRAIN_F32_REL, f"f32 step vs {other}")
        del grads_o
    del grads_k, params
    _free()
    r = bf16_step_vs_plain(dev, counters)
    log("train", f"bf16 step at 2 layers, B={TRAIN_BS[0]} S={TRAIN_BS[1]}, kernels vs plain: "
        f"loss {r['loss']:.6f} vs {r['plain_loss']:.6f} (gap {r['d_loss']:.3e}, bound "
        f"{TRAIN_BF16_LOSS_TOL}), worst grad leaf {r['leaf']} rel {r['grad_rel']:.3e} (bound "
        f"{TRAIN_BF16_GRAD_REL}); launches {r['launches']}")
    check(r["launches"] == {"rmsnorm_fwd": 4 * 2 + 1, "flash_attention_fwd": 2,
                            "ssd_scan_fwd": 0}, "bf16 step launches")
    check(r["d_loss"] <= TRAIN_BF16_LOSS_TOL, "bf16 loss, kernels vs plain")
    check(r["grad_rel"] <= TRAIN_BF16_GRAD_REL, "bf16 grads, kernels vs plain")


DRIVER_ARGV = ["--arch", "qwen3-8b", "--reduced", "--steps", "60", "--batch", "16",
               "--seq", "64"]
DRIVER_LAUNCHES = {"rmsnorm_fwd": 60 * (4 * 2 + 1), "flash_attention_fwd": 60 * 2,
                   "ssd_scan_fwd": 0}


def train_driver_phase(counters) -> None:
    from repro_torch.launch import train as driver

    reset_counts(counters)
    argv = DRIVER_ARGV
    res = driver.main(argv)
    c, _ = read_counts(counters)
    times = [t * 1e3 for t in res["step_times"]]
    log("train", f"driver {' '.join(argv)}: loss {res['first_loss']:.4f} -> "
        f"{res['last_loss']:.4f} (entropy floor {res['entropy_floor']:.4f}); step ms first "
        f"{times[0]:.1f}, median {statistics.median(times):.2f}, max of the rest "
        f"{max(times[1:]):.2f}; launches {c}")
    check(res["last_loss"] < res["first_loss"] - 1.0, "the driver's loss did not drop by 1.0")
    check(c == DRIVER_LAUNCHES, "driver launches")


def train_mamba_phase(dev, counters) -> tuple[dict, dict]:
    """Two steps of mamba2-370m at full width and 2 of 48 layers, B=1 S=256,
    through K3 (forward) and the plain scan's VJP (backward): measured, not
    optimised."""
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from repro_torch.train import TrainStepCfg, adamw_init, make_train_step

    arch = dataclasses.replace(get_arch("mamba2-370m"), num_layers=2)
    params = lm.init_params(arch, torch.Generator(device=dev).manual_seed(11), torch.float32,
                            dev)
    opt = adamw_init(params)
    batch = {"tokens": torch.randint(0, arch.vocab, (1, 256), device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(12))}
    step = make_train_step(arch, lm.ModelCfg(dtype=torch.bfloat16), TrainStepCfg())
    _free()
    reset_counts(counters)
    rows = []
    with OptimizerTimer() as timer:
        for _ in range(2):
            params, opt, r = timed_step(step, params, opt, batch, timer)
            rows.append(r)
    counts, shapes = read_counts(counters)
    log("train", "mamba2-370m, 2 of 48 layers, B=1 S=256, bf16: " + "; ".join(
        f"step {i} wall {r['wall_ms']:.1f} ms, forward + backward {r['fwd_bwd_ms']:.1f} ms, "
        f"optimizer {r['opt_ms']:.1f} ms, loss {r['loss']:.4f}" for i, r in enumerate(rows))
        + f"; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {counts}")
    check(all(math.isfinite(r["loss"]) for r in rows), "non-finite mamba2 train loss")
    check(counts == {"rmsnorm_fwd": 2 * 3, "flash_attention_fwd": 0, "ssd_scan_fwd": 2 * 2},
          "mamba2 train launches")
    return counts, shapes


# granite-moe-3b-a800m at full width and 4 of its 32 layers: 0.555e9 params,
# 8.9 GB with f32 AdamW state; B x S = 4096 tokens, 1024 slots an expert at
# the default capacity factor
GRANITE_TRAIN_LAYERS = 4
GRANITE_TRAIN_STEPS = 2


def train_granite_phase(dev, counters, card: str) -> tuple[dict, dict]:
    """GRANITE_TRAIN_STEPS make_train_step steps of granite at full width and
    GRANITE_TRAIN_LAYERS layers, TRAIN_BS, through the kernels (wall, forward
    + backward and optimizer ms, peak memory, ce_loss and aux_loss,
    launches); then the loss and every grad of one f32 step at 2 layers,
    kernels against plain versions."""
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from repro_torch.train import TrainStepCfg, adamw_init, make_train_step

    full = get_arch("granite-moe-3b-a800m")
    arch = dataclasses.replace(full, num_layers=GRANITE_TRAIN_LAYERS)
    B, S = TRAIN_BS
    L = arch.num_layers
    params = lm.init_params(arch, torch.Generator(device=dev).manual_seed(16), torch.float32,
                            dev)
    opt = adamw_init(params)
    batch = {"tokens": torch.randint(0, arch.vocab, (B, S), device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(17))}
    step = make_train_step(arch, lm.ModelCfg(dtype=torch.bfloat16),
                           TrainStepCfg(num_microbatches=1, warmup_steps=2, total_steps=10))
    n_params = sum(t.numel() for t in _leaves(params))
    torch.cuda.synchronize()
    log("train", f"granite-moe-3b-a800m at full width, {L} of its {full.num_layers} layers, "
        f"B={B} S={S}: params {n_params / 1e9:.4f} B, params + AdamW state "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB; f32 master weights, bf16 compute")
    _free()
    reset_counts(counters)
    rows = []
    with OptimizerTimer() as timer:
        for i in range(GRANITE_TRAIN_STEPS):
            torch.cuda.reset_peak_memory_stats()
            params, opt, r = timed_step(step, params, opt, batch, timer)
            rows.append(r)
            log("train", f"granite step {i}: wall {r['wall_ms']:.1f} ms, forward + backward "
                f"{r['fwd_bwd_ms']:.1f} ms, optimizer {r['opt_ms']:.1f} ms, loss "
                f"{r['loss']:.4f} (ce_loss {r['ce_loss']:.4f}, aux_loss {r['aux_loss']:.4f}), "
                f"grad_norm {r['grad_norm']:.4f}, peak memory "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (forward + backward "
                f"{timer.fwd_bwd_peak[-1] / 1e9:.2f}) on {card}")
    counts, shapes = read_counts(counters)
    per_step = {"rmsnorm_fwd": 2 * L + 1, "flash_attention_fwd": L, "ssd_scan_fwd": 0}
    log("train", f"granite launches {counts} over {GRANITE_TRAIN_STEPS} steps, per step "
        f"{per_step} expected; rmsnorm launches by kernel {_norm_paths(counters)}")
    check(counts == {k: GRANITE_TRAIN_STEPS * v for k, v in per_step.items()},
          "granite train launch counts")
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["aux_loss"]) for r in rows),
          "non-finite granite loss")
    first_want = math.log(arch.vocab) + 0.5
    check(abs(rows[0]["ce_loss"] - first_want) <= FIRST_LOSS_TOL,
          f"granite first ce_loss {rows[0]['ce_loss']} not within {FIRST_LOSS_TOL} of "
          f"ln(vocab) + 1/2 = {first_want}")
    del params, opt, step
    _free()

    # f32 at 2 layers: kernels against the plain versions
    arch2 = dataclasses.replace(full, num_layers=2)
    params = lm.init_params(arch2, torch.Generator(device=dev).manual_seed(18), torch.float32,
                            dev)
    batch = {"tokens": torch.randint(0, arch2.vocab, (2, 1024), device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(19))}
    names = list(_leaf_names(params))
    cfg = lm.ModelCfg(dtype=torch.float32)
    with RoutingReplay() as rec:
        loss_k, grads_k, c = _loss_and_grads(params, arch2, cfg, batch, counters)
    loss_o, grads_o, _ = _loss_and_grads(params, arch2, _plain(cfg), batch, counters)
    rel, i = _leaf_rel(grads_k, grads_o)
    d_own = abs(loss_k - loss_o) / abs(loss_o)
    log("train", f"granite f32 step at 2 layers, B=2 S=1024, kernels vs plain on its own "
        f"routing: loss {loss_k:.6f} vs {loss_o:.6f} (rel {d_own:.3e}, bound "
        f"{TRAIN_F32_REL}), worst grad leaf {names[i]} rel {rel:.3e} (a reading)")
    check(d_own <= TRAIN_F32_REL, "granite f32 step vs plain on its own routing")
    del grads_o
    with RoutingReplay(rec.experts) as replay:
        loss_p, grads_p, c_p = _loss_and_grads(params, arch2, _plain(cfg), batch, counters)
    rel, i = _leaf_rel(grads_k, grads_p)
    d_loss = abs(loss_k - loss_p) / abs(loss_p)
    log("train", f"granite f32 step at 2 layers, B=2 S=1024, kernels vs plain on the kernel "
        f"run's routing ({replay.flips} of {replay.rows} token-layers would have chosen "
        f"otherwise): loss {loss_k:.6f} vs {loss_p:.6f} (rel {d_loss:.3e}), worst grad leaf "
        f"{names[i]} of {len(names)} rel {rel:.3e} (bound {TRAIN_F32_REL}); launches {c}, "
        f"plain {c_p}")
    check(c == {"rmsnorm_fwd": 2 * 2 + 1, "flash_attention_fwd": 2, "ssd_scan_fwd": 0}
          and sum(c_p.values()) == 0, "granite f32 step launches")
    check(d_loss <= TRAIN_F32_REL and rel <= TRAIN_F32_REL, "granite f32 step vs plain")
    check(replay.flips <= MOE_F32_FLIP_SHARE * replay.rows,
          "granite f32 step: the plain run's own routing differs too often")
    del grads_k, grads_p, params
    _free()
    return counts, shapes


def train_phase(dev, counters, card: str) -> tuple[list[tuple[str, dict, dict]], list[dict]]:
    """Phase 6. Returns (label, launches, launches by shape) of the main train
    paths (qwen3-8b's five steps, mamba2's two, granite's two), and the five
    qwen3-8b steps' times. card: nvidia-smi's name and power limit."""
    _free()
    t0 = time.perf_counter()
    counts, rows = train_steps_phase(dev, counters, card)
    runs = [(f"qwen3-8b train x{TRAIN_STEPS}", *counts)]
    _free()
    train_parity_phase(dev, counters)
    _free()
    train_driver_phase(counters)
    runs.append(("mamba2-370m train x2", *train_mamba_phase(dev, counters)))
    _free()
    runs.append((f"granite-moe-3b-a800m train x{GRANITE_TRAIN_STEPS}",
                 *train_granite_phase(dev, counters, card)))
    log("train", f"done in {time.perf_counter() - t0:.1f} s")
    return runs, rows


# ---------------------------------------------------------------------------
# phase 7: checkpoints
# ---------------------------------------------------------------------------

# qwen3-8b at full width, cut to 2 of its 36 layers, at phase 6's B, S: its
# 1.6306e9 f32 params with AdamW's mu and nu are 19.57 GB on disk, written and
# read back whole. (At 8 layers they would be 33.5 GB, and the uninterrupted,
# resumed and control runs would not fit the card side by side.)
CKPT_LAYERS = 2
CKPT_STEPS = 2  # steps before the save, and again while it writes
# The resumed run's steps 3-4 against the uninterrupted run's, and the control
# (a second uninterrupted run) against the first: the largest loss gap, and
# each param leaf by max |diff| over the leaf's max |value|. The embedding's
# backward (an accumulating index_put_) is nondeterministic on CUDA by
# PyTorch's own account, so two uninterrupted runs need not agree to the bit.
# An H100 (80GB HBM3, 700 W) read 0 and 0 for the control and 0 and 0 for the
# resumed run, and the driver's two step-6 checkpoints agreed bit for bit in
# all 33 arrays. A resume that got the data cursor wrong moves the loss by
# ~0.1; one that lost mu and nu moves a param by ~lr = 3e-4, ~5e-3 of a
# leaf's max.
CKPT_LOSS_TOL = 1e-3
CKPT_PARAM_REL = 1e-4
# the train driver on the reduced config, as DRIVER_ARGV runs it
CKPT_DRIVER_EVERY = 3
CKPT_DRIVER_STEPS = 6


def _host_ram_available() -> int:
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_AVPHYS_PAGES")


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def ckpt_full_width_phase(dev, counters, card: str) -> list[tuple[str, dict, dict]]:
    """Two steps of qwen3-8b at full width and CKPT_LAYERS layers, an async
    save of params and AdamW state, two more steps while it writes; the
    checkpoint restored into a fresh template on the card equals the state it
    saved, bit for bit; the resumed run's two steps against the uninterrupted
    run's, beside a control run. Returns (label, launches, launches by shape)
    of the three runs."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from repro_torch.train import OptState, TrainStepCfg, adamw_init, make_train_step

    arch = dataclasses.replace(get_arch("qwen3-8b"), num_layers=CKPT_LAYERS)
    B, S = TRAIN_BS
    L = arch.num_layers
    state_bytes = 3 * 4 * arch.total_params()  # f32 params, mu and nu
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    log("ckpt", f"free disk {free / 1e9:.1f} GB under {tmp}, host RAM available "
        f"{_host_ram_available() / 1e9:.1f} GB")
    log("ckpt", f"qwen3-8b at full width, {L} of its 36 layers, B={B} S={S}: "
        f"{arch.total_params() / 1e9:.4f}e9 params by the arch's count, f32 params + mu + nu "
        f"= {state_bytes / 1e9:.2f} GB")
    check(free > 1.1 * state_bytes, f"{free / 1e9:.1f} GB free under {tmp}, the checkpoint "
          f"takes {state_bytes / 1e9:.2f} GB")
    step_fn = make_train_step(arch, lm.ModelCfg(dtype=torch.bfloat16),
                              TrainStepCfg(num_microbatches=1, warmup_steps=2, total_steps=10))
    per_step = {"rmsnorm_fwd": 4 * L + 1, "flash_attention_fwd": L, "ssd_scan_fwd": 0}

    def fresh():
        params = lm.init_params(arch, torch.Generator(device=dev).manual_seed(0),
                                torch.float32, dev)
        return params, adamw_init(params)

    def steps(params, opt, n, label, runs):
        """n steps, each on the batch of its own step number (so a resumed run
        draws what an uninterrupted one would), counted as one main-path run."""
        losses, ms = [], []
        reset_counts(counters)
        for _ in range(n):
            g = torch.Generator(device=dev).manual_seed(100 + opt.step)
            batch = {"tokens": torch.randint(0, arch.vocab, (B, S), device=dev, generator=g)}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        counts, shapes = read_counts(counters)
        check(counts == {k: n * v for k, v in per_step.items()},
              f"{label}: launches {counts}, {n} x {per_step} expected")
        check(all(math.isfinite(x) for x in losses), f"{label}: non-finite loss {losses}")
        runs.append((label, counts, shapes))
        return params, opt, losses, ms

    _free()
    runs: list[tuple[str, dict, dict]] = []
    params, opt = fresh()
    n_params = sum(t.numel() for t in _leaves(params))
    log("ckpt", f"init: {n_params} params (the arch's count leaves out the q/k norms' "
        f"{n_params - int(arch.total_params())}), {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"on the card with mu and nu")
    with tempfile.TemporaryDirectory(dir=tmp) as d:
        mgr = CheckpointManager(d)
        params, opt, loss_a, _ = steps(params, opt, CKPT_STEPS,
                                       f"qwen3-8b ckpt x{CKPT_STEPS} before the save", runs)
        snap = {"params": _clone_tree(params),
                "opt": OptState(_clone_tree(opt.mu), _clone_tree(opt.nu), opt.step)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(opt.step, {"params": params, "opt": opt},
                 metadata={"data_step": opt.step, "arch": arch.name})
        t_saved = time.perf_counter()
        blocked_ms = (t_saved - t0) * 1e3
        params, opt, more, ms_during = steps(
            params, opt, CKPT_STEPS, f"qwen3-8b ckpt x{CKPT_STEPS} while it writes", runs)
        loss_a += more
        in_flight = mgr.steps() == []
        mgr.wait()
        write_s = time.perf_counter() - t_saved
        path = os.path.join(d, f"step_{CKPT_STEPS:08d}")
        written = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        check(mgr.steps() == [CKPT_STEPS], f"checkpoints {mgr.steps()}, [{CKPT_STEPS}] expected")
        log("ckpt", f"save: {written} bytes written ({written / 1e9:.2f} GB), save() blocked "
            f"the loop {blocked_ms:.1f} ms (the copy to host memory), write {write_s:.2f} s "
            f"({written / 1e9 / write_s:.2f} GB/s); still writing after step "
            f"{2 * CKPT_STEPS}: {in_flight}; step ms while it wrote "
            f"{', '.join(f'{x:.1f}' for x in ms_during)}")
        params_a = params
        del params, opt
        _free()

        template = fresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, meta = mgr.restore({"params": template[0], "opt": template[1]})
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del template
    got, want = _flatten(state), _flatten(snap)
    check(list(got) == list(want), "the restored state's keys")
    differ = [k for k, w in want.items() if not (
        type(got[k]) is type(w) and (got[k] == w if isinstance(w, int) else (
            got[k].dtype == w.dtype and got[k].device == w.device and torch.equal(got[k], w))))]
    log("ckpt", f"restore: {restore_s:.2f} s ({written / 1e9 / restore_s:.2f} GB/s) into a "
        f"fresh template on {dev}; {len(want)} leaves, {len(differ)} differ from the step-"
        f"{CKPT_STEPS} state bit for bit; opt.step {state['opt'].step}, meta {meta['step']}, "
        f"data_step {meta['data_step']}")
    check(not differ, f"restored leaves differ from the saved state: {differ[:5]}")
    check(state["opt"].step == CKPT_STEPS and meta["data_step"] == CKPT_STEPS,
          "the restored step")
    check(not torch.equal(state["params"]["embed"], params_a["embed"]),
          f"the restore returned the state after step {2 * CKPT_STEPS}")
    del snap, got, want
    _free()

    params, opt, loss_c, _ = steps(state["params"], state["opt"], CKPT_STEPS,
                                   f"qwen3-8b resumed at {CKPT_STEPS} x{CKPT_STEPS}", runs)
    params_c = params
    del state, params, opt
    _free()
    params, opt = fresh()
    params, opt, loss_b, ms_b = steps(params, opt, 2 * CKPT_STEPS,
                                      f"qwen3-8b ckpt control x{2 * CKPT_STEPS}", runs)
    params_b = params
    del params, opt
    names = list(_leaf_names(params_a))
    ctrl_loss = max(abs(x - y) for x, y in zip(loss_b, loss_a))
    ctrl_rel, i = _leaf_rel(list(_leaves(params_b)), list(_leaves(params_a)))
    res_loss = max(abs(x - y) for x, y in zip(loss_c, loss_a[CKPT_STEPS:]))
    res_rel, j = _leaf_rel(list(_leaves(params_c)), list(_leaves(params_a)))
    log("ckpt", f"losses: uninterrupted {', '.join(f'{x:.6f}' for x in loss_a)}; resumed "
        f"{', '.join(f'{x:.6f}' for x in loss_c)}; control "
        f"{', '.join(f'{x:.6f}' for x in loss_b)}")
    log("ckpt", f"resumed vs uninterrupted after step {2 * CKPT_STEPS}: loss gap "
        f"{res_loss:.3e}, worst param leaf {names[j]} rel {res_rel:.3e}; control vs "
        f"uninterrupted: loss gap {ctrl_loss:.3e}, worst param leaf {names[i]} rel "
        f"{ctrl_rel:.3e} (bounds {CKPT_LOSS_TOL}, {CKPT_PARAM_REL})")
    check(ctrl_loss <= CKPT_LOSS_TOL and ctrl_rel <= CKPT_PARAM_REL,
          "two uninterrupted runs disagree beyond the bound")
    check(res_loss <= CKPT_LOSS_TOL and res_rel <= CKPT_PARAM_REL,
          "the resumed run disagrees with the uninterrupted one")
    without = ms_b[CKPT_STEPS:]
    log("ckpt", f"step ms while the checkpoint wrote {', '.join(f'{x:.1f}' for x in ms_during)}"
        f", the same steps of the control without a write "
        f"{', '.join(f'{x:.1f}' for x in without)}, on {card}")
    print(json.dumps({"ckpt": {
        "card": card, "arch": f"qwen3-8b, {L} layers", "params": n_params,
        "bytes_written": written, "save_blocked_ms": blocked_ms, "write_s": write_s,
        "write_gb_per_s": written / 1e9 / write_s, "restore_s": restore_s,
        "step_ms_during_write": ms_during, "step_ms_without_write": without,
        "resumed_loss_gap": res_loss, "resumed_param_rel": res_rel,
        "control_loss_gap": ctrl_loss, "control_param_rel": ctrl_rel}}), flush=True)
    del params_a, params_b, params_c
    _free()
    return runs


def ckpt_driver_phase(counters) -> list[tuple[str, dict, dict]]:
    """The train driver on the reduced config, as DRIVER_ARGV runs it: 6
    steps saving every 3 into one directory; 3 steps into another, then
    --resume to 6 there. The two step-6 checkpoints and the last losses agree
    to the control's bounds. Returns (label, launches, launches by shape) of
    the three runs."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train as driver

    i = DRIVER_ARGV.index("--steps")
    argv = DRIVER_ARGV[:i] + DRIVER_ARGV[i + 2:] + ["--checkpoint-every",
                                                     str(CKPT_DRIVER_EVERY)]
    per_step = {k: v // 60 for k, v in DRIVER_LAUNCHES.items()}
    runs, res = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        for label, n, extra in (
                ("whole", CKPT_DRIVER_STEPS, ["--checkpoint-dir", a]),
                ("first", CKPT_DRIVER_EVERY, ["--checkpoint-dir", b]),
                ("resumed", CKPT_DRIVER_STEPS, ["--checkpoint-dir", b, "--resume"])):
            steps = ["--steps", str(n)]
            out = io.StringIO()
            reset_counts(counters)
            with contextlib.redirect_stdout(out):
                res[label] = driver.main(argv + steps + extra)
            counts, shapes = read_counts(counters)
            ran = res[label]["steps"]
            log("ckpt", f"driver {label}: {' '.join(argv + steps + extra[:1])} <tmp> "
                f"{' '.join(extra[2:])}: {ran} steps, last loss {res[label]['last_loss']:.6f}, "
                f"launches {counts}" + "".join(
                    f"; {x}" for x in out.getvalue().splitlines() if x.startswith("[ckpt]")))
            check(counts == {k: ran * v for k, v in per_step.items()},
                  f"driver {label} launches {counts}")
            runs.append((f"driver {label} reduced x{ran}", counts, shapes))
        check("[ckpt] resumed from step 3" in out.getvalue(), "the driver did not resume")
        check(res["resumed"]["steps"] == CKPT_DRIVER_STEPS - CKPT_DRIVER_EVERY,
              f"the resumed driver ran {res['resumed']['steps']} steps")
        want = [CKPT_DRIVER_EVERY, CKPT_DRIVER_STEPS]
        check(CheckpointManager(a).steps() == CheckpointManager(b).steps() == want,
              f"driver checkpoints {CheckpointManager(a).steps()}, "
              f"{CheckpointManager(b).steps()}")
        arrays = []
        for d in (a, b):
            path = os.path.join(d, f"step_{CKPT_DRIVER_STEPS:08d}")
            with np.load(os.path.join(path, "arrays.npz")) as z:
                arrays.append({k: z[k] for k in z.files})
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
            check(meta["step"] == meta["data_step"] == CKPT_DRIVER_STEPS, f"meta {meta}")
    got, want = arrays[1], arrays[0]
    check(sorted(got) == sorted(want), "the two checkpoints' keys")
    check(int(got["opt/step"]) == int(want["opt/step"]) == CKPT_DRIVER_STEPS, "opt/step")
    rels = {k: float(np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-30))
            for k in want if k != "opt/step"}
    worst = max(rels, key=rels.get)
    gap = abs(res["resumed"]["last_loss"] - res["whole"]["last_loss"])
    log("ckpt", f"driver step {CKPT_DRIVER_STEPS}, resumed vs whole: last loss gap {gap:.3e}, "
        f"worst of {len(rels)} arrays {worst} rel {rels[worst]:.3e}; "
        f"{sum(v == 0 for v in rels.values())} arrays equal bit for bit (bounds "
        f"{CKPT_LOSS_TOL}, {CKPT_PARAM_REL})")
    check(gap <= CKPT_LOSS_TOL and rels[worst] <= CKPT_PARAM_REL,
          "the driver's resumed run disagrees with the whole run")
    return runs


def ckpt_phase(dev, counters, card: str) -> list[tuple[str, dict, dict]]:
    """Phase 7. Returns (label, launches, launches by shape) of its runs."""
    t0 = time.perf_counter()
    runs = ckpt_full_width_phase(dev, counters, card)
    runs += ckpt_driver_phase(counters)
    log("ckpt", f"done in {time.perf_counter() - t0:.1f} s")
    return runs


# ---------------------------------------------------------------------------
# phase 8: Astra's cost model against the card
# ---------------------------------------------------------------------------

def astra_driver_phase(counters):
    """The train driver as train_driver_phase runs it, with --auto-strategy
    and --emit-traces: the strategy it prints, its launches, and the trace it
    appends, read back through the port's read_traces. Returns the trace."""
    from repro_torch.calibration.traces import StepTrace, read_traces
    from repro_torch.launch import train as driver

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "traces.jsonl")
        argv = DRIVER_ARGV + ["--auto-strategy", "--emit-traces", path]
        out = io.StringIO()
        reset_counts(counters)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            res = driver.main(argv)
        seconds = time.perf_counter() - t0
        c, _ = read_counts(counters)
        for line in out.getvalue().splitlines():
            log("astra", f"driver: {line}")
        traces = read_traces(path)
    picked = [x for x in out.getvalue().splitlines() if x.startswith("[astra] strategy:")]
    times = [t * 1e3 for t in res["step_times"]]
    log("astra", f"driver {' '.join(argv[:-1])} <tmp>: {seconds:.1f} s with the search "
        f"(and the eta model's training where artifacts/ holds none); step ms median "
        f"{statistics.median(times):.2f}; launches {c}")
    check(len(picked) == 1 and " tp=1 pp=1 dp=1 " in picked[0],
          f"the driver's searched strategy is not one card's: {picked}")
    check(c == DRIVER_LAUNCHES, "driver launches with --auto-strategy")
    check(res["last_loss"] < res["first_loss"] - 1.0,
          "the driver's loss did not drop by 1.0 with --auto-strategy")
    check(len(traces) == 1, f"{len(traces)} traces in the driver's file, 1 expected")
    t = traces[0]
    check(t.source == "train" and t.strategy.device == "H100" and len(t.step_times) == 60,
          f"the driver's trace: source {t.source}, device {t.strategy.device}, "
          f"{len(t.step_times)} step times")
    check(StepTrace.from_json(t.to_json()) == t, "the driver's trace does not round-trip")
    log("astra", f"trace: {t.pool_key}, strategy {t.strategy_key}, median step "
        f"{t.measured_step_time * 1e3:.2f} ms")
    return t


def astra_cost_phase(rows: list[dict], driver_trace, card: str) -> dict:
    """Astra's search and cost model on phase 6's step (qwen3-8b at full
    width and TRAIN_LAYERS layers, TRAIN_BS, one H100), scored against the
    five steps phase 6 timed, under the analytic and the GBT eta model; the
    driver's trace scored beside it."""
    from repro_torch.calibration import CalibrationLoop, StepTrace
    from repro_torch.calibration.fit import AnalyticEtaModel, load_or_train
    from repro_torch.configs import get_arch
    from repro_torch.core import Astra, CostSimulator, FixedPool, SearchSpec, Workload
    from repro_torch.core.params import ParallelStrategy

    arch = dataclasses.replace(get_arch("qwen3-8b"), num_layers=TRAIN_LAYERS)
    B, S = TRAIN_BS
    # what phase 6 ran: the whole batch as one micro-batch, no remat, one card
    ran = ParallelStrategy(device="H100", num_devices=1, micro_batch_size=B,
                           recompute_granularity="none")
    trace = StepTrace(arch=arch, strategy=ran, global_batch=B, seq=S,
                      step_times=tuple(r["wall_ms"] / 1e3 for r in rows), source="train")
    fwd_bwd_ms = statistics.median(r["fwd_bwd_ms"] for r in rows)
    opt_ms = statistics.median(r["opt_ms"] for r in rows)
    out = {"card": card, "arch": f"qwen3-8b, {TRAIN_LAYERS} layers", "global_batch": B,
           "seq": S, "measured_step_ms": trace.measured_step_time * 1e3,
           "measured_fwd_bwd_ms": fwd_bwd_ms, "measured_optimizer_ms": opt_ms, "eta": {}}
    for name, make in (("analytic", AnalyticEtaModel),
                       ("gbt", lambda: load_or_train()[0])):
        t0 = time.perf_counter()
        eta = make()
        report = Astra(eta).search(SearchSpec(arch=arch, pool=FixedPool("H100", 1),
                                              workload=Workload(B, S)))
        best = report.best
        check(best is not None, f"{name}: Astra found no strategy for phase 6's step")
        n = report.counts
        log("astra", f"{name} ({eta.version_string()}): {n.generated} strategies, "
            f"{n.after_memory} fit in memory, {report.evaluated} simulated; best "
            f"{best.to_dict()}, step {report.best_sim.step_time * 1e3:.2f} ms predicted")
        check((best.tensor_parallel, best.pipeline_parallel, best.data_parallel) == (1, 1, 1),
              f"{name}: Astra's best strategy is not one card's")
        loop = CalibrationLoop(eta)
        ack = loop.ingest(trace)
        drv = loop.ingest(driver_trace)
        sim = CostSimulator(eta).simulate(arch, ran, global_batch=B, seq=S)
        row = {"version": ack["eta_model_version"],
               "predicted_step_ms": ack["predicted_step_time"] * 1e3,
               "measured_step_ms": ack["measured_step_time"] * 1e3,
               "accuracy": ack["accuracy"],
               "pipeline_ms": sim.pipeline_time * 1e3, "optimizer_ms": sim.optimizer_time * 1e3,
               "best": {"mbs": best.micro_batch_size, "remat": best.recompute_granularity,
                        "dist_opt": best.use_distributed_optimizer},
               "driver": {"predicted_step_ms": drv["predicted_step_time"] * 1e3,
                          "measured_step_ms": drv["measured_step_time"] * 1e3,
                          "accuracy": drv["accuracy"]},
               "seconds": time.perf_counter() - t0}
        out["eta"][name] = row
        log("astra", f"{name}: step {row['predicted_step_ms']:.2f} ms predicted, "
            f"{row['measured_step_ms']:.2f} ms measured, accuracy {row['accuracy']:.4f} "
            f"(1 - |p - m| / m); forward + backward {row['pipeline_ms']:.2f} ms predicted, "
            f"{fwd_bwd_ms:.2f} measured; optimizer {row['optimizer_ms']:.2f} ms predicted, "
            f"{opt_ms:.2f} measured; on {card}")
        log("astra", f"{name}, the driver's reduced step: {row['driver']['predicted_step_ms']:.4f} "
            f"ms predicted, {row['driver']['measured_step_ms']:.2f} ms measured, accuracy "
            f"{row['driver']['accuracy']:.4f}")
    return out


def astra_phase(counters, rows: list[dict], card: str) -> None:
    """Phase 8."""
    t0 = time.perf_counter()
    driver_trace = astra_driver_phase(counters)
    _free()
    print(json.dumps({"astra": astra_cost_phase(rows, driver_trace, card)}), flush=True)
    log("astra", f"done in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 9: sharding on one card
# ---------------------------------------------------------------------------

# qwen3-8b at full width, cut to 2 of its 36 layers, at phase 6's B, S, with
# bf16 compute and f32 AdamW state, as phase 7 runs it: the plain-tensor run's
# final state (19.6 GB) stays on the card while the DTensor run takes its own.
SHARD_LAYERS = 2
# the first step pays DTensor's sharding propagation; the median and range of
# the seven after it give a step's cost of DTensor's host dispatch
SHARD_STEPS = 8
# The DTensor run against the plain-tensor run on one rank: DTensor's
# propagation runs the same aten ops on the same whole tensors, and the
# kernels take the same inputs, so the two should agree bit for bit. The
# bound is phase 6's f32 kernel-parity bound (TRAIN_F32_REL), over the loss
# and each leaf of params, mu and nu (max |diff| over the leaf's max |value|);
# the reading itself is logged.
SHARD_REL = TRAIN_F32_REL
# the one-stage pipeline: tests/test_distributed.py's GPipe case (L=8, d=32, 6
# microbatches of 3); one stage runs the same layers in the same order as the
# sequential stack, with the rotation a copy
PIPE_L, PIPE_D, PIPE_K, PIPE_MBS = 8, 32, 6, 3
TORCHRUN_TIMEOUT_S = 300
# the train driver as DRIVER_ARGV runs it, but 20 steps: under torchrun each
# step also pays DTensor's dispatch on the host
SHARD_DRIVER_STEPS = 20
# the ssm and hybrid families on DTensors: name -> (layers, (B, S)); mamba2
# as phase 6's mamba2 step, hymba past its window of 1024 (the banded path)
SHARD_SSM_CELLS = {"mamba2-370m": (2, (1, 256)), "hymba-1.5b": (2, (1, 2048))}
SHARD_SSM_STEPS = 4
# the moe family on DTensors: granite-moe-3b-a800m at full width and 4 of its
# 32 layers (phase 6's cut), TRAIN_BS, at the default capacity factor
# 1.25 (the step drops assignments). Its dispatch sums each token's k expert
# outputs in a fixed order (models/moe.py), so the two runs must agree bit
# for bit, leaf for leaf.
SHARD_MOE_LAYERS = 4
SHARD_MOE_STEPS = 4


def _one_rank_group(dev):
    """A one-rank NCCL process group on the card (a HashStore, no address)
    and a (1, 1) ("data", "model") mesh on it."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=dev)
    return make_mesh((1, 1), ("data", "model"), "cuda")


def _shard_vs_plain(dev, mesh, counters, arch, B: int, S: int, steps: int,
                    per_step: dict, without_fsdp: bool = False) -> dict:
    """``steps`` make_train_step steps of ``arch`` (bf16) with params, AdamW
    state and batch as DTensors on the (1, 1) mesh with FSDP, against the
    same steps on plain tensors from the same params: the losses and every
    leaf, the kernels' launches of each run against ``per_step`` a step, the
    wall ms of each step and the peak memory. Returns the runs' (label,
    launches, launches by shape), their rows and the comparison; with
    ``without_fsdp``, also a third run on the plan without FSDP against the
    same plain run ("no_fsdp": its leaves equal, its launches and its
    step ms)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import lm
    from repro_torch.parallel.sharding import batch_spec, distribute, make_plan, named, param_specs
    from repro_torch.train import TrainStepCfg, adamw_init, make_train_step

    plan = make_plan(mesh, fsdp=True)
    step_fn = make_train_step(arch, lm.ModelCfg(dtype=torch.bfloat16),
                              TrainStepCfg(warmup_steps=2, total_steps=10,
                                           batch_axes=plan.batch_axes))
    name = arch.name
    runs, rows = [], {}

    def run(label, sharded, kept_bytes, plan=plan):
        _free()
        params = lm.init_params(arch, torch.Generator(device=dev).manual_seed(0),
                                torch.float32, dev)
        if sharded:
            params = distribute(params, named(plan, param_specs(arch, plan, params)))
            if arch.family == "moe":  # the layout the dispatch takes
                data = plan.axis_names.index("data")
                check(params["layers"]["moe"]["wi"].placements[data].is_shard() == plan.fsdp,
                      f"{label}: the experts lie over \"data\" {'not ' * plan.fsdp}as planned")
        opt = adamw_init(params)
        losses, ms = [], []
        reset_counts(counters)
        for i in range(steps):
            g = torch.Generator(device=dev).manual_seed(200 + i)
            batch = {"tokens": torch.randint(0, arch.vocab, (B, S), device=dev, generator=g)}
            if sharded:
                batch = distribute(batch, named(plan, batch_spec(plan, batch)))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        counts, shapes = read_counts(counters)
        peak = torch.cuda.max_memory_allocated() - kept_bytes
        check(all(math.isfinite(x) for x in losses), f"{label}: non-finite loss {losses}")
        check(counts == {k: steps * v for k, v in per_step.items()},
              f"{label}: launches {counts}, {steps} x {per_step} expected")
        if sharded:
            check(all(isinstance(t, DTensor) for t in _leaves(params))
                  and all(isinstance(t, DTensor) for t in _leaves(opt.mu)),
                  f"{label}: a leaf of the state is no DTensor")
        runs.append((label, counts, shapes))
        rows[label] = {"losses": losses, "step_ms": ms, "peak_gb": peak / 1e9,
                       "launches": counts}
        log("shard", f"{label}: losses {', '.join(f'{x:.6f}' for x in losses)}; step ms "
            f"{', '.join(f'{x:.1f}' for x in ms)}; peak {peak / 1e9:.2f} GB above what the "
            f"other run kept; launches {counts}")
        trees = {"params": params, "mu": opt.mu, "nu": opt.nu}
        state = [t.to_local() if sharded else t for tree in trees.values() for t in _leaves(tree)]
        names = [f"{k}.{n}" for k, tree in trees.items() for n in _leaf_names(tree)]
        return state, losses, names

    plain_label = f"{name} shard plain x{steps}"
    dt_label = f"{name} shard DTensor (1,1) x{steps}"
    want, want_loss, names = run(plain_label, False, 0)
    kept = sum(t.numel() * t.element_size() for t in want)
    got, got_loss, _ = run(dt_label, True, kept)
    rels = _leaf_rels(got, want)
    worst = max(range(len(rels)), key=rels.__getitem__)
    equal = sum(torch.equal(a, b) for a, b in zip(got, want))
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got_loss, want_loss))
    log("shard", f"{name} DTensor vs plain after {steps} steps: loss rel gap {loss_gap:.3e}; "
        f"{equal} of {len(want)} leaves (params, mu, nu) equal bit for bit, worst leaf "
        f"{names[worst]} rel {rels[worst]:.3e} (bound {SHARD_REL})")
    check(loss_gap <= SHARD_REL and rels[worst] <= SHARD_REL,
          f"the {name} DTensor step disagrees with the plain-tensor step")
    del got
    no_fsdp = None
    if without_fsdp:
        label = f"{name} shard DTensor (1,1) without FSDP x{steps}"
        got, got_loss, _ = run(label, True, kept, make_plan(mesh, fsdp=False))
        no_fsdp = {"leaves_equal": sum(torch.equal(a, b) for a, b in zip(got, want)),
                   "leaves": len(want), "losses_equal": got_loss == want_loss,
                   "step_ms": rows[label]["step_ms"], "launches": rows[label]["launches"]}
        log("shard", f"{label} vs plain: {no_fsdp['leaves_equal']} of {len(want)} leaves "
            f"equal bit for bit, losses equal: {no_fsdp['losses_equal']}")
        del got
    del want
    _free()
    plain, dt = rows[plain_label], rows[dt_label]
    warm = {k: sorted(r["step_ms"][1:]) for k, r in (("plain", plain), ("dtensor", dt))}
    med = {k: statistics.median(v) for k, v in warm.items()}
    log("shard", f"{name} steps 2-{steps}: plain median {med['plain']:.1f} ms "
        f"({warm['plain'][0]:.1f}-{warm['plain'][-1]:.1f}), DTensor median "
        f"{med['dtensor']:.1f} ms ({warm['dtensor'][0]:.1f}-{warm['dtensor'][-1]:.1f}), "
        f"ratio of the medians {med['dtensor'] / med['plain']:.4f}")
    return {"runs": runs, "plain": plain, "dtensor": dt, "median": med, "loss_gap": loss_gap,
            "worst_leaf": names[worst], "worst_leaf_rel": rels[worst], "leaves_equal": equal,
            "leaves": len(rels), "no_fsdp": no_fsdp}


def _shard_row(card: str, arch, B: int, S: int, res: dict) -> dict:
    plain, dt, med = res["plain"], res["dtensor"], res["median"]
    return {"card": card, "arch": f"{arch.name}, {arch.num_layers} layers", "batch": B,
            "seq": S, "mesh": [1, 1], "plain_step_ms": plain["step_ms"],
            "dtensor_step_ms": dt["step_ms"], "plain_warm_median_ms": med["plain"],
            "dtensor_warm_median_ms": med["dtensor"], "plain_peak_gb": plain["peak_gb"],
            "dtensor_peak_gb": dt["peak_gb"], "loss_rel_gap": res["loss_gap"],
            "worst_leaf": res["worst_leaf"], "worst_leaf_rel": res["worst_leaf_rel"],
            "leaves_equal": res["leaves_equal"], "leaves": res["leaves"],
            "dtensor_launches": dt["launches"]}


def shard_steps_phase(dev, mesh, counters, card: str) -> list[tuple[str, dict, dict]]:
    """SHARD_STEPS steps of qwen3-8b (full width, SHARD_LAYERS layers) on
    DTensors against plain tensors (``_shard_vs_plain``), K1 and K2 on the
    DTensor path; a {"shard": ...} JSON line. Returns (label, launches,
    launches by shape) of both runs."""
    from repro_torch.configs import get_arch

    arch = dataclasses.replace(get_arch("qwen3-8b"), num_layers=SHARD_LAYERS)
    B, S = TRAIN_BS
    L = arch.num_layers
    per_step = {"rmsnorm_fwd": 4 * L + 1, "flash_attention_fwd": L, "ssd_scan_fwd": 0}
    res = _shard_vs_plain(dev, mesh, counters, arch, B, S, SHARD_STEPS, per_step)
    print(json.dumps({"shard": _shard_row(card, arch, B, S, res)}), flush=True)
    return res["runs"]


def shard_ssm_phase(dev, mesh, counters, card: str) -> list[tuple[str, dict, dict]]:
    """The ssm and hybrid families on DTensors: SHARD_SSM_STEPS steps of
    mamba2-370m and hymba-1.5b (full width, SHARD_SSM_CELLS' layers, B and
    S) against plain tensors (``_shard_vs_plain``): K1 and K3 on each rank's
    shards (through local_apply), hymba's attention past its window through
    the banded path; a {"shard_ssm": ...} JSON line."""
    from repro_torch.configs import get_arch

    runs, rows = [], []
    for name, (L, (B, S)) in SHARD_SSM_CELLS.items():
        arch = dataclasses.replace(get_arch(name), num_layers=L)
        norms = L + 1 if arch.family == "ssm" else 2 * L + 1
        flash = L if arch.sliding_window == 0 or S <= arch.sliding_window else 0
        per_step = {"rmsnorm_fwd": norms, "flash_attention_fwd": 0 if arch.is_attention_free
                    else flash, "ssd_scan_fwd": L}
        res = _shard_vs_plain(dev, mesh, counters, arch, B, S, SHARD_SSM_STEPS, per_step)
        runs += res["runs"]
        rows.append(_shard_row(card, arch, B, S, res))
    print(json.dumps({"shard_ssm": rows}), flush=True)
    return runs


def shard_moe_phase(dev, mesh, counters, card: str) -> list[tuple[str, dict, dict]]:
    """The moe family on DTensors: SHARD_MOE_STEPS steps of granite-moe-3b-
    a800m (full width, SHARD_MOE_LAYERS layers, TRAIN_BS) against plain
    tensors (``_shard_vs_plain``): K1 on ln1, ln2 and the final norm, K2 on
    the attention, through local_apply. The dispatch in both its layouts:
    with FSDP through its global slots (its 40 experts over "data" of size
    1), and without (the experts whole over "data", as granite's 40 are at
    16-way) through each rank's own rows. Every leaf of params, mu and nu
    bit for bit in both; a {"shard_moe": ...} JSON line."""
    from repro_torch.configs import get_arch

    arch = dataclasses.replace(get_arch("granite-moe-3b-a800m"), num_layers=SHARD_MOE_LAYERS)
    B, S = TRAIN_BS
    L = arch.num_layers
    per_step = {"rmsnorm_fwd": 2 * L + 1, "flash_attention_fwd": L, "ssd_scan_fwd": 0}
    res = _shard_vs_plain(dev, mesh, counters, arch, B, S, SHARD_MOE_STEPS, per_step,
                          without_fsdp=True)
    whole = res["no_fsdp"]
    log("shard", f"{arch.name} DTensor vs plain: {res['leaves_equal']} of {res['leaves']} "
        f"leaves bit for bit with the experts over \"data\", {whole['leaves_equal']} of "
        f"{whole['leaves']} with them whole over it (all required)")
    check(res["leaves_equal"] == res["leaves"] and whole["leaves_equal"] == whole["leaves"]
          and whole["losses_equal"], f"the {arch.name} DTensor step is not bit for bit the "
          f"plain one")
    row = _shard_row(card, arch, B, S, res)
    row["without_fsdp"] = whole
    print(json.dumps({"shard_moe": row}), flush=True)
    return res["runs"]


def shard_pipeline_phase(dev) -> None:
    """pipeline_apply on a one-stage "stage" mesh of the NCCL group against
    the sequential stack, forward and the grad of sum(y ** 2)."""
    import torch.nn.functional as F

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.pipeline import pipeline_apply, stack_for_stages

    mesh = make_mesh((1,), ("stage",), "cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    w = (torch.randn(PIPE_L, PIPE_D, PIPE_D, device=dev, generator=g) * 0.1).requires_grad_()
    x = torch.randn(PIPE_K, PIPE_MBS, PIPE_D, device=dev, generator=g)

    def apply_stage(stage_w, h):
        for wl in stage_w:
            h = h + F.silu(h @ wl)
        return h

    y = pipeline_apply(mesh, apply_stage, stack_for_stages(w, 1), x)
    (gp,) = torch.autograd.grad((y ** 2).sum(), w)
    ref = apply_stage(w, x.reshape(-1, PIPE_D)).reshape(x.shape)
    (gr,) = torch.autograd.grad((ref ** 2).sum(), w)
    fwd = float((y - ref).detach().abs().max())
    grad = float((gp - gr).abs().max() / gr.abs().max())
    log("shard", f"pipeline_apply, one stage on {dev}: L={PIPE_L} d={PIPE_D} K={PIPE_K} "
        f"mbs={PIPE_MBS}: forward max |diff| {fwd:.3e}, grad rel {grad:.3e} against the "
        f"sequential stack (bound 1e-5, tests/test_distributed.py's)")
    check(fwd <= 1e-5 and grad <= 1e-5, "the one-stage pipeline disagrees with the stack")


def shard_restore_phase(dev, mesh) -> None:
    """Reduced qwen3-8b params as DTensors on the (1, 1) mesh, saved, and
    restored through restore(shardings=) with placements: each leaf a
    DTensor in its placements, equal to the saved one bit for bit."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import distribute, make_plan, named, param_specs

    arch = get_reduced("qwen3-8b")
    plan = make_plan(mesh, fsdp=True)
    params = lm.init_params(arch, torch.Generator(device=dev).manual_seed(5), torch.float32, dev)
    sh = named(plan, param_specs(arch, plan, params))
    placed = distribute(params, sh)
    template = lm.init_params(arch, torch.Generator(device=dev).manual_seed(6), torch.float32,
                              dev)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(1, {"params": placed}, blocking=True)
        state, _ = mgr.restore({"params": template}, shardings={"params": sh})
    got, want = list(_leaves(state["params"])), list(_leaves(placed))
    same = [isinstance(a, DTensor) and a.placements == b.placements
            and torch.equal(a.to_local(), b.to_local()) for a, b in zip(got, want)]
    log("shard", f"save at (1, 1) and restore(shardings=) with placements: {sum(same)} of "
        f"{len(same)} leaves DTensors in their placements, equal bit for bit")
    check(all(same), "the restore with placements differs from the saved state")


def shard_driver_phase(counters) -> list[tuple[str, dict, dict]]:
    """The train driver as DRIVER_ARGV runs it, for SHARD_DRIVER_STEPS steps,
    under torchrun on one card (a one-rank NCCL group, a (1, 1) mesh, FSDP)
    and in this process; the losses of the two agree to SHARD_REL. Returns
    the in-process run's (label, launches, launches by shape)."""
    from repro_torch.launch import train as driver

    i = DRIVER_ARGV.index("--steps")
    argv = (DRIVER_ARGV[:i] + ["--steps", str(SHARD_DRIVER_STEPS)] + DRIVER_ARGV[i + 2:]
            + ["--log-every", "1"])
    root = pathlib.Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "1", "-m", "repro_torch.launch.train", *argv]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=root,
                         timeout=TORCHRUN_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        print(res.stderr[-4000:], file=sys.stderr)
    check(res.returncode == 0, f"torchrun exited {res.returncode}")
    out = res.stdout.splitlines()
    result = [json.loads(x) for x in out if x.startswith('{"first_loss"')]
    check(len(result) == 1, f"{len(result)} result lines from torchrun, 1 expected")
    ranked = [float(x.split()[3]) for x in out if x.startswith("step ")]

    buf = io.StringIO()
    reset_counts(counters)
    with contextlib.redirect_stdout(buf):
        alone = driver.main(argv)
    counts, shapes = read_counts(counters)
    # each printed step loss against the one of the run alone, to its 4 decimals
    gap = max(abs(a - b) for a, b in zip(ranked, alone["losses"]))
    log("shard", f"torchrun --standalone --nproc-per-node 1 -m repro_torch.launch.train "
        f"{' '.join(argv)}: {seconds:.1f} s (process start, NCCL and the kernels' "
        f"load included), loss {result[0]['first_loss']:.6f} -> {result[0]['last_loss']:.6f}; "
        f"without torchrun {alone['first_loss']:.6f} -> {alone['last_loss']:.6f}; largest "
        f"step loss gap {gap:.3e} over {len(ranked)} steps (printed to 4 decimals); launches "
        f"without torchrun {counts}")
    last_gap = abs(result[0]["last_loss"] - alone["last_loss"]) / abs(alone["last_loss"])
    check(len(ranked) == len(alone["losses"]) and last_gap <= SHARD_REL
          and abs(result[0]["first_loss"] - alone["first_loss"]) <= SHARD_REL * alone["first_loss"]
          and gap <= 1e-4, "the driver under torchrun disagrees with the driver alone")
    check(counts == {k: v // 60 * SHARD_DRIVER_STEPS for k, v in DRIVER_LAUNCHES.items()},
          "driver launches")
    return [(f"driver reduced alone (beside torchrun) x{SHARD_DRIVER_STEPS}", counts, shapes)]


def shard_phase(dev, counters, card: str) -> list[tuple[str, dict, dict]]:
    """Phase 9. Returns (label, launches, launches by shape) of its runs."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    mesh = _one_rank_group(dev)
    try:
        runs = shard_steps_phase(dev, mesh, counters, card)
        runs += shard_ssm_phase(dev, mesh, counters, card)
        runs += shard_moe_phase(dev, mesh, counters, card)
        shard_pipeline_phase(dev)
        shard_restore_phase(dev, mesh)
    finally:
        dist.destroy_process_group()
    _free()
    runs += shard_driver_phase(counters)
    log("shard", f"done in {time.perf_counter() - t0:.1f} s; no collective across cards was "
        f"run: one card, one rank")
    return runs


# --- phase 10: the dry-run --------------------------------------------------

# (a) the sharded serve path: phase 5's qwen3-8b run, 4 prompts x 128 + 32 new
DRYRUN_SERVE = dict(B=4, P=128, N=32, max_len=160)
# (b) phase 9's cell: qwen3-8b at full width, 2 layers, B=4 S=1024, K=1, remat
# "full", FSDP, on a (1, 1) mesh; and one decode step at full depth, B=4,
# against a cache of 1024
DRYRUN_TRAIN_LAYERS = 2
DRYRUN_DECODE = (4, 1024)
DRYRUN_STEPS = 5  # steps timed after the counted one
# the dry-run's FLOPs against the same step's on the card: the same ops are
# counted, so only float rounding of the sums may differ
DRYRUN_FLOP_REL = 1e-9
# the dry-run's predicted per-device memory over max_memory_allocated
DRYRUN_MEM_RATIO = (0.8, 1.25)
# (c) the production cells, each `python -m repro_torch.launch.dryrun` in a
# process of its own at the lowest priority, joined at the end of the phase:
# qwen3-8b's two train cells trace for minutes and start with the script; its
# serve cells and the other dense archs' (seconds each) start with the phase.
# The other archs' train cells trace for minutes each: PERF.md has them from
# a run of the CLI.
DRYRUN_EARLY_CELLS = (("qwen3-8b", "train_4k", "single"), ("qwen3-8b", "train_4k", "multi"))
DRYRUN_LATE_CELLS = tuple((a, s, "single") for a in ("qwen3-8b", "yi-6b", "qwen3-32b",
                                                    "command-r-35b")
                          for s in ("prefill_32k", "decode_32k"))
# the ssm and hybrid archs' 16 production cells (long_500k included): their
# train cells start with the script, the others with the phase
SSM_ARCHS = ("mamba2-370m", "hymba-1.5b")
DRYRUN_EARLY_CELLS += tuple((a, "train_4k", p) for a in SSM_ARCHS for p in ("single", "multi"))
DRYRUN_LATE_CELLS += tuple((a, s, p) for a in SSM_ARCHS
                           for s in ("prefill_32k", "decode_32k", "long_500k")
                           for p in ("single", "multi"))
# (a) the ssm and hybrid archs at full depth: (name, B, prompt, new, max_len);
# hymba's second run fills its ring of 1024 with the prompt (the ring
# prefill) and its decode steps wrap it
DRYRUN_SSM_SERVE = (("mamba2-370m", 4, 128, 32, 160), ("hymba-1.5b", 4, 128, 32, 160),
                    ("hymba-1.5b", 2, 1024, 8, 1024 + 8))
# (a) the moe archs: (name, layers, B, prompt, new, max_len); granite at full
# depth, llama4-scout at full width and 2 of its 48 layers (13 GB in bf16;
# its top-1 routing and its shared expert)
DRYRUN_MOE_SERVE = (("granite-moe-3b-a800m", 32, 4, 128, 32, 160),
                    ("llama4-scout-17b-a16e", 2, 4, 128, 32, 160))
# (c) the moe archs' cells: granite's six, llama4-scout's four serve cells
# (its train_4k cells, 48 layers at d=5120, trace for minutes each: PERF.md
# has them from a run of the CLI); long_500k is SKIP for both (full
# attention)
MOE_ARCHS = ("granite-moe-3b-a800m", "llama4-scout-17b-a16e")
DRYRUN_EARLY_CELLS += tuple(("granite-moe-3b-a800m", "train_4k", p) for p in ("single", "multi"))
DRYRUN_LATE_CELLS += tuple((a, s, p) for a in MOE_ARCHS for s in ("prefill_32k", "decode_32k")
                           for p in ("single", "multi"))
DRYRUN_CELL_TIMEOUT_S = 1000
DRYRUN_OUT = pathlib.Path(__file__).resolve().parent / "build" / "dryrun_smoke"


def start_dryrun_cells(cells, procs: list) -> None:
    """Starts each production cell of ``cells`` as the user would run it,
    `python -m repro_torch.launch.dryrun`, on fake CUDA tensors and a fake
    process group of 256 or 512 ranks, each in its own process at the
    lowest priority (the traces are host work on one core each). Appends
    (cell, process, log path, t0) to ``procs``."""
    root = pathlib.Path(__file__).resolve().parent
    if not procs:
        shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
        DRYRUN_OUT.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    for arch, shape, pods in cells:
        logf = DRYRUN_OUT / f"{arch}__{shape}__{pods}.log"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
               shape, "--pods", pods, "--out", str(DRYRUN_OUT)]
        with open(logf, "w") as f:
            procs.append(((arch, shape, pods), subprocess.Popen(
                cmd, cwd=root, env=env, stdout=f, stderr=subprocess.STDOUT,
                preexec_fn=lambda: os.nice(19)), logf, time.perf_counter()))


def stop_dryrun_cells(procs) -> None:
    for _, proc, _, _ in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _greedy(params, arch, cfg, caches, prompts, N: int, place=None):
    """Prefill and N greedy decode steps through lm.prefill / decode_step;
    place(tokens) lays a token batch out as the params are (DTensors).
    Returns the prefill logits (whole), the (B, P + N) tokens and the decode
    steps' wall ms."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import lm

    def whole(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    place = place or (lambda t: t)
    P = prompts.shape[1]
    logits, _ = lm.prefill(params, arch, cfg, caches, place(prompts))
    first = whole(logits).clone()
    seq, ms = [prompts], []
    nxt = first[:, -1].argmax(-1, keepdim=True)
    for i in range(N):
        seq.append(nxt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = lm.decode_step(params, arch, cfg, caches, place(nxt), P + i)
        nxt = whole(logits)[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return first, torch.cat(seq, dim=1), ms


def _serve_vs_plain(dev, mesh, counters, arch, B: int, P: int, N: int, T: int, seed: int,
                    per_forward: dict) -> tuple[tuple, dict]:
    """Prefill + N greedy steps of P-token prompts (cache of T) in bf16 with
    params, caches and tokens as DTensors on the (1, 1) mesh (the cached path
    on DTensors, the kernels through local_apply) against the same run on
    plain tensors: tokens equal, prefill logits bit for bit, each run's
    launches (N + 1) x ``per_forward``. Returns the DTensor run's (label,
    launches, by shape) and a row for the JSON line."""
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import (batch_spec, cache_specs, distribute, make_plan,
                                               named, param_specs)

    cfg = _serve_cfg(arch, torch.bfloat16)  # moe: capacity factor MOE_SERVE_CAPACITY
    plan = make_plan(mesh, fsdp=True)
    params = lm.init_params(arch, torch.Generator(device=dev).manual_seed(seed), torch.bfloat16,
                            dev)
    prompts = torch.as_tensor(np.random.default_rng(seed - 5).integers(0, arch.vocab,
                                                                       size=(B, P)), device=dev)
    expect = {k: (N + 1) * v for k, v in per_forward.items()}

    reset_counts(counters)
    want_logits, want, plain_ms = _greedy(params, arch, cfg,
                                          lm.init_caches(arch, cfg, B, T, device=dev), prompts, N)
    plain_counts, _ = read_counts(counters)
    dparams = distribute(params, named(plan, param_specs(arch, plan, params)))
    del params
    caches = lm.init_caches(arch, cfg, B, T, device=dev)
    dcaches = distribute(caches, named(plan, cache_specs(arch, plan, caches)))
    del caches

    def place(tokens):
        return distribute({"tokens": tokens}, named(plan, batch_spec(plan, {"tokens": tokens})))[
            "tokens"]

    reset_counts(counters)
    got_logits, got, dt_ms = _greedy(dparams, arch, cfg, dcaches, prompts, N, place)
    counts, shapes = read_counts(counters)
    same_logits = torch.equal(got_logits, want_logits)
    same_tokens = torch.equal(got, want)
    med = {"plain": statistics.median(plain_ms), "dtensor": statistics.median(dt_ms)}
    ring = (f", a ring of {min(T, arch.sliding_window)} slots" if arch.sliding_window else "")
    log("dryrun", f"(a) {arch.name} serve B={B} prompt={P} new={N} max_len={T}{ring}, bf16: "
        f"DTensor params, caches and tokens on the (1, 1) mesh against plain tensors: tokens "
        f"equal {same_tokens}, prefill logits equal bit for bit {same_logits}; median decode "
        f"step plain {med['plain']:.2f} ms, DTensor {med['dtensor']:.2f} ms; launches plain "
        f"{plain_counts}, DTensor {counts} (expect {expect})")
    check(same_tokens and same_logits,
          f"the sharded cached path of {arch.name} disagrees with the plain one")
    check(counts == expect and plain_counts == expect, f"{arch.name} sharded serve launches")
    del dparams, dcaches
    _free()
    return ((f"{arch.name} serve DTensor (1,1) {B}x{P}+{N}", counts, shapes),
            {"arch": arch.name, "batch": B, "prompt": P, "new": N, "max_len": T,
             "tokens_equal": same_tokens, "prefill_logits_equal": same_logits,
             "plain_decode_median_ms": med["plain"], "dtensor_decode_median_ms": med["dtensor"],
             "dtensor_launches": counts})


def dryrun_serve_phase(dev, mesh, counters) -> tuple[list, dict]:
    """(a) qwen3-8b at full width and depth, then mamba2-370m and hymba-1.5b
    (DRYRUN_SSM_SERVE: a cache that never wraps, and hymba's prompt that
    fills its ring of 1024 with decode steps that wrap it), then granite-moe
    and llama4-scout (DRYRUN_MOE_SERVE, capacity factor MOE_SERVE_CAPACITY),
    each served on DTensors against plain tensors (``_serve_vs_plain``).
    Returns the DTensor runs' (label, launches, by shape) and qwen3's row for
    the JSON line with the others' under "ssm" and "moe"."""
    from repro_torch.configs import get_arch

    arch = get_arch("qwen3-8b")
    per_forward = {"rmsnorm_fwd": 4 * arch.num_layers + 1, "flash_attention_fwd": 0,
                   "ssd_scan_fwd": 0}
    run, row = _serve_vs_plain(dev, mesh, counters, arch, *(DRYRUN_SERVE[k] for k in (
        "B", "P", "N", "max_len")), 11, per_forward)
    runs, rows = [run], []
    for name, B, P, N, T in DRYRUN_SSM_SERVE:
        arch = get_arch(name)
        L = arch.num_layers
        # the cached path scans with the plain version (the JAX package's
        # impl="xla" there) and attends through flash_xla: K1 alone
        per_forward = {"rmsnorm_fwd": L + 1 if arch.family == "ssm" else 2 * L + 1,
                       "flash_attention_fwd": 0, "ssd_scan_fwd": 0}
        run, r = _serve_vs_plain(dev, mesh, counters, arch, B, P, N, T, 11, per_forward)
        runs.append(run)
        rows.append(r)
    row["ssm"] = rows
    rows = []
    for name, L, B, P, N, T in DRYRUN_MOE_SERVE:
        arch = dataclasses.replace(get_arch(name), num_layers=L)
        # the cached path attends through flash_xla: K1 on ln1, ln2, the final norm
        per_forward = {"rmsnorm_fwd": 2 * L + 1, "flash_attention_fwd": 0, "ssd_scan_fwd": 0}
        run, r = _serve_vs_plain(dev, mesh, counters, arch, B, P, N, T, 11, per_forward)
        runs.append(run)
        rows.append(dict(r, layers=L, capacity_factor=MOE_SERVE_CAPACITY))
    row["moe"] = rows
    return runs, row


def _dryrun_cell(arch, shape, **kw) -> dict:
    from repro_torch.launch import dryrun
    from repro_torch.parallel.sharding import MeshShape

    rep = dryrun.lower_cell(arch, shape, MeshShape((1, 1), ("data", "model")),
                            device="cuda", **kw)
    log("dryrun", f"lower_cell {arch.name} {shape.name} (1, 1) on fake CUDA tensors:"
        + dryrun.summary_line(rep)[1:])
    return rep


def _train_cell(name: str = "qwen3-8b", L: int = DRYRUN_TRAIN_LAYERS, bs=TRAIN_BS):
    from repro_torch.configs import get_arch
    from repro_torch.core.arch import InputShape

    B, S = bs
    return (dataclasses.replace(get_arch(name), num_layers=L),
            InputShape("phase9_cell", S, B, "train"))


def _mamba2_cell():
    """Phase 9's mamba2 cell."""
    L, bs = SHARD_SSM_CELLS["mamba2-370m"]
    return _train_cell("mamba2-370m", L, bs)


def _granite_cell():
    """Phase 9's granite cell."""
    return _train_cell("granite-moe-3b-a800m", SHARD_MOE_LAYERS, TRAIN_BS)


def _decode_cell():
    from repro_torch.configs import get_arch
    from repro_torch.core.arch import InputShape

    B, T = DRYRUN_DECODE
    return get_arch("qwen3-8b"), InputShape("decode_1k", T, B, "decode")


def dryrun_train_phase(dev, mesh, counters, rep: dict, cell=None,
                       kernel_launches=None) -> tuple[list, dict]:
    """(b) phase 9's cell (``cell``, default qwen3-8b's) through lower_cell
    (``rep``), then the same step on the card ("xla" impls, as the dry-run
    runs it; mamba2's scan the real loop of S steps, which the dry-run
    counts in three) under the same accountant: FLOPs equal, the predicted
    per-device memory against max_memory_allocated, the roofline bound
    against the measured median step; then the same step through the
    kernels (its time, peak and launches, ``kernel_launches`` by default
    qwen3's)."""
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.op_account import OpAccountant
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import batch_spec, distribute, make_plan, named, param_specs
    from repro_torch.train import TrainStepCfg, adamw_init, make_train_step

    arch, shape = cell or _train_cell()
    B, S = shape.global_batch, shape.seq_len
    plan = make_plan(mesh, fsdp=True)
    xla = lm.ModelCfg(dtype=torch.bfloat16, attn_impl="xla", ssm_impl="xla", norm_impl="xla",
                      remat="full")
    rows, runs = {}, []
    for label, cfg in (("xla", xla), ("cuda", dataclasses.replace(
            xla, attn_impl="cuda", norm_impl="cuda", ssm_impl="cuda"))):
        _free()
        base = torch.cuda.memory_allocated()
        params = lm.init_params(arch, torch.Generator(device=dev).manual_seed(0),
                                torch.float32, dev)
        params = distribute(params, named(plan, param_specs(arch, plan, params)))
        opt = adamw_init(params)
        step = make_train_step(arch, cfg, TrainStepCfg(num_microbatches=1,
                                                       batch_axes=plan.batch_axes))
        tokens = torch.randint(0, arch.vocab, (B, S), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(200))
        batch = distribute({"tokens": tokens.int()}, named(plan, batch_spec(plan, {
            "tokens": tokens})))
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counters)
        acc = OpAccountant()
        acc.add_arguments((params, opt, batch))
        with acc:
            params, opt, _ = step(params, opt, batch)
        counts, shapes = read_counts(counters)
        ms = []
        for _ in range(DRYRUN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, _ = step(params, opt, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() - base
        rows[label] = {"flops": acc.totals.flops, "hbm_bytes": acc.totals.bytes,
                       "step_ms": ms, "median_ms": statistics.median(ms), "peak_bytes": peak,
                       "accountant_peak_bytes": acc.memory()["per_device_total"],
                       "launches_counted_step": counts}
        if label == "cuda":
            runs.append((f"{arch.name} dry-run cell through the kernels x1", counts, shapes))
        del params, opt, batch, acc
    _free()
    r, x, k = rep["roofline"], rows["xla"], rows["cuda"]
    flop_rel = abs(r["flops_per_chip"] - x["flops"]) / x["flops"]
    predicted = rep["memory"]["per_device_total"]
    ratio = predicted / x["peak_bytes"]
    bound_ms = max(r["compute_s"], r["memory_s"], r["collective_s"]) * 1e3
    useful = r["model_flops_total"] / r["chips"]
    log("dryrun", f"(b) {arch.name}, {arch.num_layers} layers, B={B} S={S}, K=1, remat full, "
        f"FSDP, (1, 1): FLOPs dry-run {r['flops_per_chip']:.6e} vs the card's step under the "
        f"accountant {x['flops']:.6e} (rel {flop_rel:.2e}, bound {DRYRUN_FLOP_REL}); "
        f"per_device_total {predicted / 1e9:.3f} GB vs max_memory_allocated "
        f"{x['peak_bytes'] / 1e9:.3f} GB, ratio {ratio:.4f} (bound {DRYRUN_MEM_RATIO}); "
        f"the accountant on the card {x['accountant_peak_bytes'] / 1e9:.3f} GB")
    log("dryrun", f"(b) roofline bound {bound_ms:.2f} ms ({r['dominant']}; compute "
        f"{r['compute_s'] * 1e3:.2f} / memory {r['memory_s'] * 1e3:.2f} / collective "
        f"{r['collective_s'] * 1e3:.2f} ms) vs measured median step \"xla\" {x['median_ms']:.2f} ms "
        f"(bound / measured {bound_ms / x['median_ms']:.4f}, useful-FLOPs MFU "
        f"{useful / (x['median_ms'] / 1e3 * rl.PEAK_FLOPS):.4f}); through the kernels "
        f"{k['median_ms']:.2f} ms (MFU {useful / (k['median_ms'] / 1e3 * rl.PEAK_FLOPS):.4f}), "
        f"peak {k['peak_bytes'] / 1e9:.3f} GB, launches {k['launches_counted_step']}")
    check(flop_rel <= DRYRUN_FLOP_REL, "the dry-run's FLOPs differ from the card's step")
    check(DRYRUN_MEM_RATIO[0] <= ratio <= DRYRUN_MEM_RATIO[1],
          "the dry-run's memory is far from the card's")
    # remat "full" runs each layer's forward twice
    want = kernel_launches or {"rmsnorm_fwd": 8 * arch.num_layers + 1,
                               "flash_attention_fwd": 2 * arch.num_layers, "ssd_scan_fwd": 0}
    check(k["launches_counted_step"] == want,
          f"{arch.name} kernel-step launches {k['launches_counted_step']}, expected {want}")
    return runs, {"cell": f"{arch.name} {arch.num_layers} layers B={B} S={S} K=1 (1,1)",
                  "dryrun": {"flops": r["flops_per_chip"], "hbm_bytes": r["hbm_bytes_per_chip"],
                             "per_device_total": predicted, "bound_ms": bound_ms,
                             "dominant": r["dominant"], "lower_s": rep["lower_s"]},
                  "card_xla": x, "card_cuda": k, "flop_rel": flop_rel, "mem_ratio": ratio}


def dryrun_decode_phase(dev, mesh, rep: dict) -> dict:
    """(b) one decode step of qwen3-8b at full depth, B=4, cache of 1024:
    lower_cell's (``rep``) memory term beside the measured step on the card (DTensors
    on the (1, 1) mesh, "xla" impls, at the dry-run's position) and the
    device's busy share while it runs."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.op_account import OpAccountant
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import (batch_spec, cache_specs, distribute, make_plan,
                                               named, param_specs)

    arch, shape = _decode_cell()
    B, T = shape.global_batch, shape.seq_len
    plan = make_plan(mesh, fsdp=True)
    cfg = lm.ModelCfg(dtype=torch.bfloat16, attn_impl="xla", ssm_impl="xla", norm_impl="xla",
                      remat="full")
    _free()
    base = torch.cuda.memory_allocated()
    params = lm.init_params(arch, torch.Generator(device=dev).manual_seed(12), torch.bfloat16,
                            dev)
    params = distribute(params, named(plan, param_specs(arch, plan, params)))
    caches = lm.init_caches(arch, cfg, B, T, device=dev)
    caches = distribute(caches, named(plan, cache_specs(arch, plan, caches)))
    tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    tok = distribute({"tokens": tok}, named(plan, batch_spec(plan, {"tokens": tok})))["tokens"]
    pos = rep["position"]
    torch.cuda.reset_peak_memory_stats()
    acc = OpAccountant()
    with acc:
        lm.decode_step(params, arch, cfg, caches, tok, pos)
    ms = []
    for _ in range(DRYRUN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm.decode_step(params, arch, cfg, caches, tok, pos)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() - base
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm.decode_step(params, arch, cfg, caches, tok, pos)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = device_us(prof) / 1e3
    del params, caches
    _free()
    r = rep["roofline"]
    med = statistics.median(ms)
    flop_rel = abs(r["flops_per_chip"] - acc.totals.flops) / acc.totals.flops
    log("dryrun", f"(b) decode {arch.name} B={B} cache {T} at position {pos}, (1, 1): memory "
        f"term {r['memory_s'] * 1e3:.3f} ms ({r['hbm_bytes_per_chip'] / 1e9:.3f} GB / "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s), compute {r['compute_s'] * 1e3:.4f} ms, dominant "
        f"{r['dominant']}; measured median step {med:.2f} ms (bound / measured "
        f"{r['memory_s'] * 1e3 / med:.4f}); profiled step wall {wall:.2f} ms, device kernels "
        f"{busy:.2f} ms, busy share {busy / wall:.3f}; FLOPs rel {flop_rel:.2e}; "
        f"per_device_total {rep['memory']['per_device_total'] / 1e9:.3f} GB vs "
        f"max_memory_allocated {peak / 1e9:.3f} GB")
    check(flop_rel <= DRYRUN_FLOP_REL, "the dry-run's decode FLOPs differ from the card's step")
    return {"memory_ms": r["memory_s"] * 1e3, "hbm_bytes": r["hbm_bytes_per_chip"],
            "median_ms": med, "step_ms": ms, "busy_share": busy / wall, "flop_rel": flop_rel,
            "per_device_total": rep["memory"]["per_device_total"], "peak_bytes": peak}


def dryrun_cells_phase(procs) -> list[dict]:
    """(c) joins the production cells: each must exit 0 with an `ok`
    artifact; prints the JAX dry-run's summary line of each and its trace's
    wall seconds."""
    cells = []
    for (arch, shape, pods), proc, logf, t0 in procs:
        try:
            rc = proc.wait(timeout=max(DRYRUN_CELL_TIMEOUT_S - (time.perf_counter() - t0), 1))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = None
        wall = time.perf_counter() - t0
        text = logf.read_text()
        mesh = "2x16x16" if pods == "multi" else "16x16"
        tag = re.search(r"^=== (\S+) ===$", text, re.M)
        art = DRYRUN_OUT / f"{tag.group(1) if tag else 'none'}.json"
        rep = json.loads(art.read_text()) if art.exists() else {}
        if not rep.get("ok"):
            print(text[-4000:], file=sys.stderr)
        summary = [x for x in text.splitlines() if x.startswith("  ok ")]
        log("dryrun", f"(c) {arch} {shape} {mesh}: exit {rc}, {wall:.1f} s since it started "
            f"(process start and import included); " + (summary[0].strip() if summary
                                                        else "no summary line"))
        check(rc == 0 and rep.get("ok"), f"the dry-run cell {arch} {shape} {mesh} failed")
        r, m = rep["roofline"], rep["memory"]
        cells.append({"arch": arch, "shape": shape, "mesh": mesh, "lower_s": rep["lower_s"],
                      "compute_s": r["compute_s"], "memory_s": r["memory_s"],
                      "collective_s": r["collective_s"], "dominant": r["dominant"],
                      "roofline_fraction": r["roofline_fraction"],
                      "per_device_total": m["per_device_total"],
                      "fits_h100_80g": m["fits_h100_80g"],
                      "collectives": rep["collectives"]["counts"]})
    return cells


def dryrun_phase(dev, counters, card: str, procs: list) -> list[tuple[str, dict, dict]]:
    """Phase 10; ``procs`` holds the cells started with the script. Returns
    (label, launches, launches by shape) of its runs."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    start_dryrun_cells(DRYRUN_LATE_CELLS, procs)
    # lower_cell starts its own fake process group: before the NCCL one
    train_rep = _dryrun_cell(*_train_cell(), microbatch_rows=TRAIN_BS[0])
    mamba_rep = _dryrun_cell(*_mamba2_cell(), microbatch_rows=SHARD_SSM_CELLS["mamba2-370m"][1][0])
    granite_rep = _dryrun_cell(*_granite_cell(), microbatch_rows=TRAIN_BS[0])
    decode_rep = _dryrun_cell(*_decode_cell())
    mesh = _one_rank_group(dev)
    try:
        runs, serve = dryrun_serve_phase(dev, mesh, counters)
        more, train = dryrun_train_phase(dev, mesh, counters, train_rep)
        runs += more
        L = SHARD_SSM_CELLS["mamba2-370m"][0]
        more, train_mamba = dryrun_train_phase(
            dev, mesh, counters, mamba_rep, _mamba2_cell(),
            {"rmsnorm_fwd": 2 * L + 1, "flash_attention_fwd": 0, "ssd_scan_fwd": 2 * L})
        runs += more
        L = SHARD_MOE_LAYERS
        more, train_granite = dryrun_train_phase(
            dev, mesh, counters, granite_rep, _granite_cell(),
            {"rmsnorm_fwd": 4 * L + 1, "flash_attention_fwd": 2 * L, "ssd_scan_fwd": 0})
        runs += more
        decode = dryrun_decode_phase(dev, mesh, decode_rep)
    finally:
        dist.destroy_process_group()
    _free()
    cells = dryrun_cells_phase(procs)
    print(json.dumps({"dryrun": {"card": card, "serve": serve, "train": train,
                                 "train_mamba2": train_mamba, "train_granite": train_granite,
                                 "decode": decode, "cells": cells}}), flush=True)
    log("dryrun", f"done in {time.perf_counter() - t0:.1f} s")
    return runs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    import repro_torch.launch.dryrun  # noqa: F401  (the sources are there before any process starts)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    procs: list = []
    start_dryrun_cells(DRYRUN_EARLY_CELLS, procs)
    try:
        return _main(dev, t_start, procs)
    finally:
        stop_dryrun_cells(procs)


def _main(dev, t_start: float, procs) -> int:
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd
    from repro_torch.kernels.ssd import ssd_scan_fwd


    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    ptxas = build_kernels()
    log("build", f"{time.perf_counter() - t0:.1f} s")
    for line in _fold_rmsnorm_configs(ptxas) or [
            "no ptxas output: the kernels were built before this run"]:
        log("build", f"ptxas {line}")

    counters = (rmsnorm_fwd, flash_attention_fwd, ssd_scan_fwd)
    with torch.inference_mode():
        entries = [rmsnorm_phase(dev), flash_phase(dev), ssd_phase(dev)]
    log("kernels", f"done at {time.perf_counter() - t_start:.1f} s")

    qwen, mamba = get_arch("qwen3-8b"), get_arch("mamba2-370m")
    hymba, granite = get_arch("hymba-1.5b"), get_arch("granite-moe-3b-a800m")

    runs = model_phases(
        dev, "qwen3-8b", counters,
        {"rmsnorm_fwd": 4 * qwen.num_layers + 1, "flash_attention_fwd": qwen.num_layers,
         "ssd_scan_fwd": 0},
        {"rmsnorm_fwd": 4 * qwen.num_layers + 1, "flash_attention_fwd": 0,
         "ssd_scan_fwd": 0},
        main_bs=(2, 512), compare_bs=(2, 512))
    log("serve", f"qwen3-8b done at {time.perf_counter() - t_start:.1f} s")
    # mamba2's prefill and decode run the plain scan on a cache, as the JAX
    # package does (ssm.py: impl="xla" there), so serve launches no SSD kernel
    runs += model_phases(
        dev, "mamba2-370m", counters,
        {"rmsnorm_fwd": mamba.num_layers + 1, "flash_attention_fwd": 0,
         "ssd_scan_fwd": mamba.num_layers},
        {"rmsnorm_fwd": mamba.num_layers + 1, "flash_attention_fwd": 0,
         "ssd_scan_fwd": 0},
        main_bs=(4, 2048), compare_bs=(2, 512))
    log("serve", f"mamba2-370m done at {time.perf_counter() - t_start:.1f} s")
    # hymba: ln1, ln2 and K3 in each layer, K2 while S <= the window; its
    # cached paths run flash_xla and the plain scan (K1 only)
    runs += model_phases(
        dev, "hymba-1.5b", counters,
        {"rmsnorm_fwd": 2 * hymba.num_layers + 1, "flash_attention_fwd": hymba.num_layers,
         "ssd_scan_fwd": hymba.num_layers},
        {"rmsnorm_fwd": 2 * hymba.num_layers + 1, "flash_attention_fwd": 0,
         "ssd_scan_fwd": 0},
        main_bs=(2, 1024), compare_bs=(2, 1024), extra=hymba_extra,
        serve={"max_len": HYMBA_SERVE_MAX_LEN})
    log("serve", f"hymba-1.5b done at {time.perf_counter() - t_start:.1f} s")
    runs += model_phases(
        dev, "granite-moe-3b-a800m", counters,
        {"rmsnorm_fwd": 2 * granite.num_layers + 1, "flash_attention_fwd": granite.num_layers,
         "ssd_scan_fwd": 0},
        {"rmsnorm_fwd": 2 * granite.num_layers + 1, "flash_attention_fwd": 0,
         "ssd_scan_fwd": 0},
        main_bs=(2, 512), compare_bs=(2, 512), extra=granite_extra)
    log("serve", f"granite-moe-3b-a800m done at {time.perf_counter() - t_start:.1f} s")
    whisper, pixtral = get_arch("whisper-tiny"), get_arch("pixtral-12b")
    enc_L, L = whisper.encoder_layers, whisper.num_layers
    runs += model_phases(
        dev, "whisper-tiny", counters,
        {"rmsnorm_fwd": 2 * enc_L + 1 + 3 * L + 1, "flash_attention_fwd": enc_L + L,
         "ssd_scan_fwd": 0},
        {"rmsnorm_fwd": 3 * L + 1, "flash_attention_fwd": 0, "ssd_scan_fwd": 0},
        main_bs=WHISPER_BS, compare_bs=WHISPER_BS, serve=WHISPER_SERVE,
        cache_pass={"rmsnorm_fwd": 2 * enc_L + 1, "flash_attention_fwd": enc_L})
    log("serve", f"whisper-tiny done at {time.perf_counter() - t_start:.1f} s")
    runs += model_phases(
        dev, "pixtral-12b", counters,
        {"rmsnorm_fwd": 2 * pixtral.num_layers + 1, "flash_attention_fwd": pixtral.num_layers,
         "ssd_scan_fwd": 0},
        {"rmsnorm_fwd": 2 * pixtral.num_layers + 1, "flash_attention_fwd": 0,
         "ssd_scan_fwd": 0},
        main_bs=PIXTRAL_BS, compare_bs=PIXTRAL_BS, serve=PIXTRAL_SERVE,
        f32_layers=PIXTRAL_F32_LAYERS)
    log("serve", f"pixtral-12b done at {time.perf_counter() - t_start:.1f} s")
    runs.append(("serve driver qwen3-8b reduced", *serve_driver_phase(counters)))
    train_runs, train_rows = train_phase(dev, counters, smi)
    runs += train_runs
    runs += ckpt_phase(dev, counters, smi)
    astra_phase(counters, train_rows, smi)
    runs += shard_phase(dev, counters, smi)
    runs += dryrun_phase(dev, counters, smi, procs)
    log("dryrun", f"phase 10 done at {time.perf_counter() - t_start:.1f} s")

    for e in entries:
        e["launches"] = sum(counts[e["name"]] for _, counts, _ in runs)
        e["launches_by_path"] = {label: counts[e["name"]] for label, counts, _ in runs
                                 if counts[e["name"]]}
        steps = {"qwen3-8b": TRAIN_STEPS, "mamba2-370m": 2,
                 "granite-moe-3b-a800m": GRANITE_TRAIN_STEPS}
        e["train_launches_per_step"] = {name: counts[e["name"]] / steps[name]
                                        for (_, counts, _), name in zip(train_runs, steps)}
        e["kernel_ms"] = e["ms"]
        check(e["launches"] > 0, f"{e['name']} never launched on the main path")
    # launches x (device ms - bound ms): RMSNorm over the shapes it ran at
    norm = entries[0]
    norm_shapes = sum((shapes[norm["name"]] for _, _, shapes in runs), collections.Counter())
    check(sum(norm_shapes.values()) == norm["launches"],
          f"RMSNorm launches by shape {sum(norm_shapes.values())} != counted {norm['launches']}")
    with torch.inference_mode():
        norm["shapes"] = rmsnorm_shape_times(dev, norm_shapes)
    gaps = {e["name"]: e["launches"] * (e["ms"] - e["bound_ms"]) for e in entries[1:]}
    gaps[norm["name"]] = sum(r["gap_ms"] for r in norm["shapes"])
    log("order", "launches x (device ms - bound ms) on the main paths: " + ", ".join(
        f"{n} {g:.3f} ms" for n, g in sorted(gaps.items(), key=lambda kv: -kv[1])))
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _leaf_names(tree, prefix=""):
    """The dotted paths of tree's leaves, in _leaves's order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_names(v, f"{prefix}{k}.")
    else:
        yield prefix.rstrip(".")


if __name__ == "__main__":
    sys.exit(main())
