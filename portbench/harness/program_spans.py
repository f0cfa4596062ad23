"""The program's own spans and counts (``repro_torch.spans``) inside a traced
run's chosen trace, and what the trace's device and host events say inside
them.

The program records spans only while a profile collects, stamped on the
profiler's clock (Unix ns). A traced run may take several traces before two
agree; the chosen one's window runs from the first to the last of its host
stamps, so the spans of the traces retaken before it fall outside. Every
reader returns None where the program records no span (a program without
``repro_torch.spans``, or no trace), so a metric is left out there.
"""
from __future__ import annotations

import bisect
import re

from portbench.harness.trace import gaps

LAUNCH = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel)")


def in_trace(trace) -> list | None:
    """The spans that began inside ``trace``'s window; None without any."""
    if trace is None or not trace.host:
        return None
    try:
        from repro_torch import spans
    except ImportError:
        return None
    lo = min(s for _, s, _ in trace.host)
    hi = max(e for _, _, e in trace.host)
    got = [s for s in spans.recorded() if lo <= s.start_ns <= hi]
    return got or None


def named(got, name: str) -> list:
    return [s for s in got or () if s.name == name]


def device_ms_per(got, name: str, unit: str) -> float | None:
    """The device milliseconds of the spans ``name`` over the number of spans
    ``unit`` (a step); None without either, or without device time."""
    spans, units = named(got, name), len(named(got, unit))
    ms = [s.device_ms for s in spans]
    if not spans or not units or None in ms:
        return None
    return sum(ms) / units


def idle_ms_inside(trace, spans) -> float:
    """Milliseconds of the trace's idle gaps (between its merged device
    events) that lie inside ``spans``, which do not overlap."""
    idle = gaps([(a, b) for _, a, b in trace.device])
    ends = [b for _, b in idle]
    total = 0
    for s in spans:
        i = bisect.bisect_right(ends, s.start_ns)
        while i < len(idle) and idle[i][0] < s.end_ns:
            total += min(idle[i][1], s.end_ns) - max(idle[i][0], s.start_ns)
            i += 1
    return total / 1e6


def launches_inside(trace, spans) -> int:
    """The host's kernel launches (``cudaLaunchKernel*``, ``cuLaunchKernel*``
    runtime and driver calls) that began inside ``spans``."""
    starts = sorted(s for n, s, _ in trace.host if LAUNCH.match(n))
    return sum(bisect.bisect_right(starts, s.end_ns) - bisect.bisect_left(starts, s.start_ns)
               for s in spans)


def subtree_counts(got, root: str) -> dict:
    """The counts of the spans ``root`` and of every span under them."""
    children = {}
    for s in got or ():
        children.setdefault(s.parent, []).append(s)
    todo, out = named(got, root), {}
    while todo:
        s = todo.pop()
        for k, n in s.counts.items():
            out[k] = out.get(k, 0) + n
        todo += children.get(s.id, [])
    return out
