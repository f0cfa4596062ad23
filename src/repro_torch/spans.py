"""Spans and counts inside the port, on the clock of the profiler's trace.

A span records its name, its id and its parent's, the identifier of the
step or request it belongs to, its start in Unix ns (the clock that
``torch.profiler``'s host and device events are stamped on, so a span lies on
the trace's own timeline) and its duration from a monotonic clock, the
counts made while it was the innermost open span, and with ``device=True``
CUDA events at both ends, whose device time is read after the caller's
synchronise.

Recording is on only while a profile is collecting (its active phase), and
for spans opened while another is open, on whichever thread: the backward of
a CUDA op runs on autograd's device thread, and its span takes the parent and
the identifier of the span open on the thread that called backward. The
calls are synchronous, so one stack serves the whole process. Off, ``span``
returns a shared no-op and ``count`` returns at once; ``timed`` always
measures its interval, for a caller that needs the duration either way.

Not ``torch.profiler.record_function``: its annotation enters the trace's
device events, where it would read as a kernel covering the idle gaps inside
it, and it costs microseconds a call with the profiler off.

Finished spans are kept in memory, the newest ``MAX_SPANS``: ``recorded()``
returns them and ``clear()`` empties the store. Nothing is written out.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import time
from typing import Optional

import torch

MAX_SPANS = 1 << 16

_profiling = torch.autograd._profiler_enabled
_open: list = []  # the open spans, innermost last
_done: collections.deque = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_NOOP = contextlib.nullcontext()


@dataclasses.dataclass
class Span:
    name: str
    id: int
    parent: Optional[int]
    ident: object  # the step or request the span belongs to
    start_ns: int = 0  # Unix ns
    dur_ns: int = 0  # monotonic
    counts: dict = dataclasses.field(default_factory=dict)
    events: Optional[tuple] = None  # CUDA events at both ends

    @property
    def end_ns(self) -> int:
        return self.start_ns + self.dur_ns

    @property
    def device_ms(self) -> Optional[float]:
        """Device milliseconds between the span's CUDA events, once the work
        they bracket has finished; None for a span without them."""
        return None if self.events is None else self.events[0].elapsed_time(self.events[1])


class _Interval:
    """One span's interval: always timed, recorded only while recording is on."""

    __slots__ = ("name", "ident", "device", "ns", "_t0", "_span")

    def __init__(self, name: str, ident, device: bool):
        self.name, self.ident, self.device = name, ident, device
        self.ns = 0

    @property
    def seconds(self) -> float:
        return self.ns / 1e9

    def __enter__(self):
        span = None
        if _open or _profiling():
            parent = _open[-1] if _open else None
            ident = self.ident if self.ident is not None or parent is None else parent.ident
            span = Span(self.name, next(_ids), parent.id if parent else None, ident)
            _open.append(span)
            span.start_ns = time.time_ns()
        self._span = span
        self._t0 = time.perf_counter_ns()
        if span is not None and self.device:
            span.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            span.events[0].record()
        return self

    def __exit__(self, *exc):
        span = self._span
        if span is not None and span.events is not None:
            span.events[1].record()
        self.ns = time.perf_counter_ns() - self._t0
        if span is not None:
            span.dur_ns = self.ns
            if _open and _open[-1] is span:
                _open.pop()
            else:
                _open.remove(span)
            _done.append(span)
        return False


def span(name: str, ident=None, device: bool = False):
    """A context manager recording the span ``name`` while recording is on,
    the shared no-op otherwise. ``ident``: the step or request it belongs to
    (default its parent's). ``device``: bracket it with CUDA events too (for
    work on a card)."""
    if not (_open or _profiling()):
        return _NOOP
    return _Interval(name, ident, device)


def timed(name: str, ident=None) -> _Interval:
    """``span``'s host span, always timed: its ``seconds`` after the block
    are the interval the span records, when one is recorded."""
    return _Interval(name, ident, False)


def count(name: str, n: int) -> None:
    """Add ``n`` to the count ``name`` of the innermost open span; nothing
    while no span is open."""
    if _open:
        counts = _open[-1].counts
        counts[name] = counts.get(name, 0) + n


def counting() -> bool:
    """Whether ``count`` records: a caller whose count takes arithmetic skips it otherwise."""
    return bool(_open)


def recorded() -> list:
    """The finished spans kept, in the order they ended."""
    return list(_done)


def clear() -> None:
    _done.clear()
