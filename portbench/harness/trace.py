"""Device traces: profiled sub-windows retaken until two agree, the busy
time as a union of intervals, kernel names folded, and the breakdown.

The profiler can lose whole groups of device events, most often right after
it starts. So each trace starts with a short step whose events are dropped,
and a sub-window counts only once a second trace of it holds the same
number of device events; a run in which no two of ``MAX_TRACES`` agree
fails. Device time is summed from the device events themselves, never from
``key_averages()``, where a host op also carries its kernels' time.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import re
import time

MAX_TRACES = 6
LOOK_BACK = 64


class TraceError(RuntimeError):
    pass


@dataclasses.dataclass
class Trace:
    """The device events ``(name, start_ns, end_ns)`` and host ops of one
    profiled sub-window of ``units`` steps or batches, ``window_s`` long on
    the host clock, with the program's launch counters over it."""

    device: list
    host: list
    window_s: float
    units: int
    launches: dict
    counts: list  # device events of every trace taken


def union_s(intervals) -> float:
    """Seconds covered by at least one of the (start_ns, end_ns) intervals:
    overlapping kernels count once."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e9


def gaps(intervals) -> list[tuple[int, int]]:
    """The idle (start_ns, end_ns) stretches between merged intervals."""
    out, end = [], None
    for a, b in sorted(intervals):
        if end is not None and a > end:
            out.append((end, a))
        end = b if end is None else max(end, b)
    return out


_CSRC = re.compile(r"_cu_[0-9a-f]{8}(\d+)")


def fold(name: str) -> str:
    """A kernel's name without its template arguments: ``rmsnorm_vec_kernel``
    from the mangled name of a kernel in an anonymous namespace of the
    port's ``csrc/*.cu``, ``at::native::elementwise_kernel`` from
    ``void at::native::elementwise_kernel<128, 2, ...>(...)``."""
    m = _CSRC.search(name)
    if m:
        return name[m.end():m.end() + int(m.group(1))]
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = min((i for i in (name.find("<"), name.find("(")) if i > 0), default=len(name))
    return name[:cut].strip()[:120] or name[:120]


def device_seconds(trace: Trace, pattern: str, required: bool = False) -> float:
    """Device seconds of the events whose folded name matches ``pattern``;
    with ``required``, a trace that holds none is an error."""
    rx = re.compile(pattern)
    t = sum(b - a for n, a, b in trace.device if rx.search(fold(n))) / 1e9
    if required and t <= 0:
        raise TraceError(f"the wrappers counted launches, but no device event is named "
                         f"{pattern!r}: a kernel renamed, or its events lost")
    return t


def expected_launches(trace: Trace, counter: str, per_unit: int) -> bool:
    """Whether a wrapper's kernel ran in the sub-window: False when its
    counter reads none; an error when it reads other than ``per_unit`` a
    step or batch, since a reading that takes its work from the
    configuration would then measure other work than the kernel's."""
    seen, want = trace.launches.get(counter, 0), per_unit * trace.units
    if seen and seen != want:
        raise TraceError(f"{counter}: {seen} launches in {trace.units} unit(s), the "
                         f"configuration implies {want}; its roofline needs a new reader")
    return bool(seen)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device ops that took most time, and the longest idle gaps named by
    the innermost host op (an aten op or a CUDA runtime call) running when
    each began, among the ``LOOK_BACK`` host ops that began last before it
    (seconds over the whole sub-window)."""
    by_op = collections.Counter()
    for n, a, b in trace.device:
        by_op[fold(n)] += (b - a) / 1e9
    named = collections.Counter()
    host = sorted(trace.host, key=lambda e: e[1])
    starts = [s for _, s, _ in host]
    for a, b in gaps([(s, e) for _, s, e in trace.device]):
        i = bisect.bisect_right(starts, a)
        inner = next((host[j][0] for j in range(i - 1, max(i - LOOK_BACK, 0) - 1, -1)
                      if host[j][2] >= a), "host: no op")
        named[inner] += (b - a) / 1e9
    return {"device_ops": [[k, v] for k, v in by_op.most_common(top)],
            "idle_gaps": [[k, v] for k, v in named.most_common(top)]}


def _events(prof):
    """(device, host) events of a finished profile as (name, start_ns,
    end_ns), read from the kineto results (``prof.events()`` builds a tree of
    every event first, which takes seconds at a hundred thousand)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        row = (e.name(), e.start_ns(), e.end_ns())
        if e.device_type() == DeviceType.CUDA:
            if not row[0].startswith("ProfilerStep#"):  # the step's span, not a kernel
                dev.append(row)
        elif e.device_type() == DeviceType.CPU:
            host.append(row)
    return dev, host


def profile_agreeing(unit, units: int, sync, counters) -> Trace:
    """Profile ``units`` calls of ``unit`` (one step or batch each), after a
    short warm-up step of the profiler whose events are dropped, until two
    traces hold the same number of device events. ``sync()`` waits for the
    device; ``counters()`` reads the program's launch counters."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    counts, seen = [], {}
    for _ in range(MAX_TRACES):
        span = {}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            x = torch.ones(1 << 16, device="cuda")
            for _ in range(64):  # the profiler's warm-up: a few small kernels
                x.mul_(1.0)
            sync()
            prof.step()
            before = counters()
            t0 = time.perf_counter()
            for _ in range(units):
                unit()
            sync()
            span["window_s"] = time.perf_counter() - t0
            span["launches"] = {k: v - before.get(k, 0) for k, v in counters().items()}
            prof.step()
        dev, host = _events(prof)
        counts.append(len(dev))
        if dev and len(dev) in seen:
            return Trace(dev, host, span["window_s"], units, span["launches"], counts)
        if dev:
            seen[len(dev)] = True
    raise TraceError(f"no two of {MAX_TRACES} traces held the same number of device events: "
                     f"{counts}")


def idle_share(trace) -> float | None:
    """1 - busy / window of a traced sub-window, in %; nothing without one."""
    if trace is None or trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - union_s([(a, b) for _, a, b in trace.device]) / trace.window_s)
