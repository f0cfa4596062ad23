"""Measured step-time traces: the calibration loop's wire-level input.

A :class:`StepTrace` records what a real run observed for one
(workload, pool, strategy) triple — per-step wall times plus, optionally,
op-level (op, seconds) samples from a profiler. Sources:

- ``train``:  ``launch/train.py --emit-traces PATH`` times its own step loop;
- ``serve``:  a ServeEngine reporting measured step times back;
- ``replay``: :func:`simulate_step_trace` / :func:`replay_profile` replaying
  the ground-truth simulator (how tests drive the loop sleep-free);
- ``measured``: anything else (hand-built payloads, external profilers).

Wire discipline matches :mod:`repro_torch.core.wire`: versioned envelope, every
float as ``float.hex`` so the JSON round-trip is bit-exact, optional fields
serialized sparsely. Step-level times alone *detect* drift (predicted vs
measured step time); the op-level samples are what a refit can learn from.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import statistics
from typing import Optional, Sequence

from repro_torch.core import wire
from repro_torch.core.arch import ModelArch
from repro_torch.core.opspec import CommOp, ComputeOp
from repro_torch.core.params import ParallelStrategy

TRACE_KIND = "astra.step_trace"
TRACE_SOURCES = ("measured", "train", "serve", "replay")


@dataclasses.dataclass(frozen=True)
class StepTrace:
    """Measured per-step times for one (workload, pool, strategy) triple."""

    arch: ModelArch
    strategy: ParallelStrategy
    global_batch: int
    seq: int
    step_times: tuple  # seconds, one per measured step
    source: str = "measured"
    # op-level measured (op, seconds) pairs — sparse on the wire; empty for
    # plain step timers, populated by profiler replays (replay_profile)
    compute_samples: tuple = ()
    comm_samples: tuple = ()
    # how many jit-compile warmup steps the emitter measured and DROPPED
    # before building step_times (sparse on the wire; 0 for emitters that
    # never saw a compile). Records the exclusion so drift scoring knows the
    # trace is already clean
    warmup_steps_excluded: int = 0

    def __post_init__(self):
        if self.source not in TRACE_SOURCES:
            raise ValueError(
                f"unknown trace source {self.source!r}; expected one of {TRACE_SOURCES}"
            )
        if not self.step_times:
            raise ValueError("a StepTrace needs at least one step time")
        if self.warmup_steps_excluded < 0:
            raise ValueError(
                f"warmup_steps_excluded must be >= 0, "
                f"got {self.warmup_steps_excluded}"
            )
        object.__setattr__(
            self, "step_times", tuple(float(t) for t in self.step_times)
        )
        object.__setattr__(
            self, "compute_samples",
            tuple((op, float(t)) for op, t in self.compute_samples),
        )
        object.__setattr__(
            self, "comm_samples",
            tuple((op, float(t)) for op, t in self.comm_samples),
        )

    # -- derived keys ------------------------------------------------------
    @property
    def measured_step_time(self) -> float:
        """Median step time — robust to warmup steps and stragglers."""
        return float(statistics.median(self.step_times))

    @property
    def pool_key(self) -> str:
        return f"{self.strategy.device}x{self.strategy.num_devices}"

    @property
    def strategy_key(self) -> str:
        canon = json.dumps(
            self.strategy.to_dict(), sort_keys=True, separators=(",", ":")
        )
        return hashlib.sha256(canon.encode("utf-8")).hexdigest()[:12]

    # -- wire format -------------------------------------------------------
    def to_dict(self) -> dict:
        d = {
            "version": wire.WIRE_VERSION,
            "kind": TRACE_KIND,
            "arch": dataclasses.asdict(self.arch),
            "strategy": self.strategy.to_dict(),
            "global_batch": self.global_batch,
            "seq": self.seq,
            "step_times": wire.dump_floats(self.step_times),
            "source": self.source,
        }
        if self.compute_samples:
            d["compute_samples"] = [
                {"op": dataclasses.asdict(op), "t": wire.dump_float(t)}
                for op, t in self.compute_samples
            ]
        if self.comm_samples:
            d["comm_samples"] = [
                {"op": dataclasses.asdict(op), "t": wire.dump_float(t)}
                for op, t in self.comm_samples
            ]
        if self.warmup_steps_excluded:
            d["warmup_steps_excluded"] = self.warmup_steps_excluded
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "StepTrace":
        wire.check_envelope(d, TRACE_KIND)
        return cls(
            arch=ModelArch(**d["arch"]),
            strategy=ParallelStrategy.from_dict(d["strategy"]),
            global_batch=int(d["global_batch"]),
            seq=int(d["seq"]),
            step_times=tuple(wire.load_floats(d["step_times"])),
            source=d.get("source", "measured"),
            compute_samples=tuple(
                (ComputeOp(**e["op"]), wire.load_float(e["t"]))
                for e in d.get("compute_samples", ())
            ),
            comm_samples=tuple(
                (CommOp(**e["op"]), wire.load_float(e["t"]))
                for e in d.get("comm_samples", ())
            ),
            warmup_steps_excluded=int(d.get("warmup_steps_excluded", 0)),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "StepTrace":
        return cls.from_dict(json.loads(text))


# ---------------------------------------------------------------------------
# JSONL trace files (what --emit-traces appends and the CLI posts)
# ---------------------------------------------------------------------------

def append_trace(path: str, trace: StepTrace) -> None:
    """Append one trace as a JSON line (the ``--emit-traces`` file format)."""
    with open(path, "a") as f:
        f.write(trace.to_json() + "\n")


def read_traces(path: str) -> list[StepTrace]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(StepTrace.from_json(line))
    return out


# ---------------------------------------------------------------------------
# replay: drive the loop from the ground-truth simulator (tests, CI, demos)
# ---------------------------------------------------------------------------

def simulate_step_trace(
    truth,
    arch: ModelArch,
    strategy: ParallelStrategy,
    *,
    global_batch: int,
    seq: int,
    steps: int = 3,
    source: str = "replay",
    compute_samples: Sequence[tuple] = (),
    comm_samples: Sequence[tuple] = (),
) -> StepTrace:
    """Replay ``truth`` (a GroundTruth or any eta-model-shaped object) into a
    measured-looking trace. A fresh CostSimulator per step keeps the truth's
    jitter independent across steps; pass an object with ``.simulate`` to use
    it as-is (memoized => identical steps)."""
    from repro_torch.core.simulate import CostSimulator

    times = []
    for _ in range(max(steps, 1)):
        sim = truth if hasattr(truth, "simulate") else CostSimulator(truth)
        times.append(
            sim.simulate(arch, strategy, global_batch=global_batch, seq=seq).step_time
        )
    return StepTrace(
        arch=arch, strategy=strategy, global_batch=global_batch, seq=seq,
        step_times=tuple(times), source=source,
        compute_samples=tuple(compute_samples), comm_samples=tuple(comm_samples),
    )


def replay_profile(
    truth,
    *,
    n_compute: int = 400,
    n_comm: int = 400,
    seed: int = 0,
    devices: Optional[Sequence[str]] = None,
) -> tuple[tuple, tuple]:
    """Op-level (op, measured seconds) samples replayed from a truth profile —
    the stand-in for a profiler dump. Returns (compute_samples, comm_samples)
    ready to attach to a :class:`StepTrace` or feed to ``refit_eta_model``."""
    import numpy as np

    from repro_torch.calibration.fit import sample_comm_ops, sample_compute_ops
    from repro_torch.hw.catalog import DEVICES

    rng = np.random.default_rng(seed)
    devices = list(devices or DEVICES)
    comp_ops = sample_compute_ops(rng, n_compute, devices)
    comm_ops = sample_comm_ops(rng, n_comm, devices)
    return (
        tuple((op, truth.compute_time(op)) for op in comp_ops),
        tuple((op, truth.comm_time(op)) for op in comm_ops),
    )
