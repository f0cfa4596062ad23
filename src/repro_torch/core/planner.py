"""Spec -> plan lowering (the middle layer of the search pipeline).

``build_plan`` turns a declarative :class:`~repro_torch.core.spec.SearchSpec`
into a :class:`SearchPlan`: one or more *tagged candidate streams* plus a
shared funnel-count accumulator. Every pool shape lowers onto the same two
generators (:func:`~repro_torch.core.search.iter_valid_strategies` and
:func:`~repro_torch.core.hetero.iter_hetero_strategies`) behind one memoized
:class:`~repro_torch.core.search.FilterBank`, so rule/memory filter work is
shared across device-count sweeps and placement cells, and every stream is
lazy — the evaluator pulls candidates chunk by chunk and nothing
materializes the candidate set.

Every stream also exposes a deterministic round-robin ``shard(i, n)`` view:
worker ``i`` of ``n`` pulls the disjoint interleaved slice of the stream's
*raw* candidate space whose indices are ``i (mod n)``, filters it through
its own shard of work, and receives ``(seq, strategy)`` pairs where ``seq``
is the candidate's exact position in the serial stream. The union of the
``n`` shards is the serial stream, their funnel counts merge to the serial
counts, and the seq tuples let the mergeable collectors
(:mod:`repro_torch.core.pareto`) reproduce the serial ranking byte-for-byte —
the foundation of every non-serial :mod:`repro_torch.core.backend`.

A plan is a one-shot consumable: drain either each stream's full serial
view or exactly one ``shard`` per stream, never both (the shared ``counts``
would double-tally).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Iterator, Sequence

from repro_torch.core.arch import ModelArch
from repro_torch.core.hetero import iter_hetero_strategies
from repro_torch.core.params import GpuConfig, ParallelStrategy
from repro_torch.core.rules import DEFAULT_RULES
from repro_torch.core.search import FilterBank, SearchCounts, iter_valid_strategies
from repro_torch.core.spec import DeviceSweep, FixedPool, HeteroCaps, SearchSpec

#: pool shape -> report mode label (the paper's three modes)
POOL_MODES = {
    FixedPool: "homogeneous",
    HeteroCaps: "heterogeneous",
    DeviceSweep: "cost",
}


def pool_mode(pool) -> str:
    """Mode label for a pool spec (raises on unknown shapes)."""
    try:
        return POOL_MODES[type(pool)]
    except KeyError:
        raise TypeError(f"unknown pool spec {type(pool).__name__}") from None


@dataclasses.dataclass
class CandidateStream:
    """One lazy, tagged stream of filter-surviving candidates.

    ``strategies`` is the full serial view; ``shard(i, n)`` is the i-th
    round-robin slice as ``(seq, strategy)`` pairs (``seq`` orders the
    serial stream). Both are views over the same one-shot generator state —
    consume one of them, once.
    """

    tag: str
    strategies: Iterable[ParallelStrategy]
    _sharder: Callable[[int, int], Iterator[tuple[tuple, ParallelStrategy]]] = None

    def shard(self, i: int, n: int) -> Iterator[tuple[tuple, ParallelStrategy]]:
        """Deterministic round-robin slice: yields ``(seq, strategy)`` for
        the raw-space indices owned by worker ``i`` of ``n``. Shards
        partition the stream exactly: every serial candidate appears in
        exactly one shard, with the same ``seq``."""
        if self._sharder is None:
            raise TypeError(f"stream {self.tag!r} does not support sharding")
        return self._sharder(i, n)


@dataclasses.dataclass
class SearchPlan:
    """A lowered spec: mode label, funnel counts, candidate streams.

    ``counts`` is shared by every stream and mutated as they are consumed;
    read it only after the evaluator has drained the streams.
    """

    mode: str
    spec: SearchSpec
    counts: SearchCounts
    streams: list[CandidateStream]
    filters: FilterBank


def timed(it: Iterable, counts: SearchCounts) -> Iterator:
    """Accumulate generator wall-time into ``counts.gen_seconds`` so the
    Table-1 search/simulate split stays honest under streaming. Every mode
    goes through this — generation + filtering time is ``search_seconds``,
    the remainder of the e2e wall-time is ``simulate_seconds``. (In a
    sharded run each worker times its own slice, so the merged value is
    total generation CPU time, not wall time.)"""
    it = iter(it)
    while True:
        t0 = time.perf_counter()
        try:
            s = next(it)
        except StopIteration:
            counts.gen_seconds += time.perf_counter() - t0
            return
        counts.gen_seconds += time.perf_counter() - t0
        yield s


def _hetero_stream(
    spec: SearchSpec,
    pool: HeteroCaps,
    bank: FilterBank,
    counts: SearchCounts,
    shard: tuple[int, int] = (0, 1),
    indexed: bool = False,
) -> Iterator[ParallelStrategy]:
    """Mode-2 funnel: the hetero generator only emits arithmetically
    feasible combos (dp*mbs | GB, placements summing to num_layers), so the
    divisible rung equals generated by construction."""
    en = ru = me = 0.0
    t_mark = time.perf_counter()
    try:
        for item in iter_hetero_strategies(
            spec.arch,
            pool.to_pool(),
            spec.workload.global_batch,
            fast=pool.fast,
            base_kwargs=spec.hetero_base,
            prune_slack=pool.prune_slack if pool.fast else None,
            shard=shard,
            indexed=indexed,
        ):
            seq, s = item if indexed else (None, item)
            counts.generated += 1
            counts.divisible += 1
            t1 = time.perf_counter()
            en += t1 - t_mark
            t_mark = t1
            if not bank.rules_ok(s):
                t_mark = time.perf_counter()
                ru += t_mark - t1
                continue
            counts.after_rules += 1
            t1 = time.perf_counter()
            ru += t1 - t_mark
            t_mark = t1
            if not bank.memory_ok(s):
                t_mark = time.perf_counter()
                me += t_mark - t1
                continue
            counts.after_memory += 1
            t1 = time.perf_counter()
            me += t1 - t_mark
            yield (seq, s) if indexed else s
            t_mark = time.perf_counter()
    finally:
        counts.enumerate_seconds += en
        counts.rules_seconds += ru
        counts.memory_seconds += me


def build_plan(
    spec: SearchSpec,
    *,
    rules: Sequence[str] = DEFAULT_RULES,
    filters: FilterBank = None,
) -> SearchPlan:
    """Lower ``spec`` into tagged candidate streams behind one filter bank.

    ``filters`` reuses an existing :class:`FilterBank` (it must have been
    built for this spec's arch/seq and these rules) instead of creating a
    fresh one — a long-lived pool worker passes its cached bank so filter
    verdicts stay memoized *across* searches, not just within one.
    """
    arch, w = spec.arch, spec.workload
    counts = SearchCounts()
    bank = filters if filters is not None else FilterBank(
        arch, w.seq, rules,
        inference=w.inference, global_batch=w.global_batch,
    )
    pool = spec.pool

    # a candidate cap is consumed mid-stream (itertools.islice): only the
    # scalar funnel tallies counts candidate-by-candidate, so capped specs
    # must not vectorize (the columnar funnel counts a whole block at a
    # time, which would diverge from the serial capped counts)
    vectorize = False if spec.limits.max_candidates is not None else None

    if isinstance(pool, FixedPool):
        gpus = [GpuConfig(pool.device, pool.num_devices)]

        def make(i: int, n: int, gpus=gpus):
            return iter_valid_strategies(
                arch, gpus, w.global_batch, w.seq, space=spec.space,
                counts=counts, filters=bank, shard=(i, n), indexed=True,
                vectorize=vectorize,
            )

        stream = iter_valid_strategies(
            arch, gpus, w.global_batch, w.seq, space=spec.space,
            counts=counts, filters=bank, vectorize=vectorize,
        )
        streams = [CandidateStream(
            f"{pool.device}x{pool.num_devices}", stream, make
        )]
        return SearchPlan("homogeneous", spec, counts, streams, bank)

    if isinstance(pool, HeteroCaps):
        tag = "+".join(f"{d}:{c}" for d, c in pool.type_caps)

        def make(i: int, n: int):
            return _hetero_stream(
                spec, pool, bank, counts, shard=(i, n), indexed=True
            )

        streams = [CandidateStream(
            tag, _hetero_stream(spec, pool, bank, counts), make
        )]
        return SearchPlan("heterogeneous", spec, counts, streams, bank)

    if isinstance(pool, DeviceSweep):
        # one tagged stream per device type; all share the bank and counts,
        # so filter verdicts memoize across counts of the same type (and
        # across types for the count-independent memory checks)
        streams = []
        for dev in pool.devices:
            gpus = [GpuConfig(dev, n) for n in pool.counts()]

            def make(i: int, n: int, gpus=gpus):
                return iter_valid_strategies(
                    arch, gpus, w.global_batch, w.seq, space=spec.space,
                    counts=counts, filters=bank, shard=(i, n), indexed=True,
                    vectorize=vectorize,
                )

            streams.append(
                CandidateStream(
                    f"{dev}x{{{','.join(str(g.num_devices) for g in gpus)}}}",
                    iter_valid_strategies(
                        arch, gpus, w.global_batch, w.seq, space=spec.space,
                        counts=counts, filters=bank, vectorize=vectorize,
                    ),
                    make,
                )
            )
        return SearchPlan("cost", spec, counts, streams, bank)

    raise TypeError(f"unknown pool spec {type(pool).__name__}")


def shard_limit(spec: SearchSpec) -> int:
    """Upper bound on the useful shard fan-out for ``spec`` (>= 1).

    Shards deal raw candidate *blocks* (mode 1/3: ``SHARD_BLOCK``-sized
    block-cyclic slices of the product space) or placement *cells* (mode
    2), so a worker count beyond the block/cell count of the largest
    stream only forks processes that will never own work. Backends clamp
    ``Limits.workers`` to this — it tunes fan-out, never results (any
    clamp value >= 1 partitions the stream exactly).
    """
    from repro_torch.core.hetero import count_hetero_cells
    from repro_torch.core.search import SHARD_BLOCK, count_raw_indices

    arch, w, pool = spec.arch, spec.workload, spec.pool
    if isinstance(pool, FixedPool):
        raw = count_raw_indices(
            arch, GpuConfig(pool.device, pool.num_devices), w.global_batch,
            space=spec.space,
        )
        return max(1, -(-raw // SHARD_BLOCK))
    if isinstance(pool, HeteroCaps):
        return max(1, count_hetero_cells(arch, pool.to_pool(), w.global_batch))
    if isinstance(pool, DeviceSweep):
        # workers shard every stream with the same (i, n): a worker index
        # past the largest stream's block count owns nothing anywhere
        best = 1
        for dev in pool.devices:
            raw = sum(
                count_raw_indices(
                    arch, GpuConfig(dev, n), w.global_batch, space=spec.space
                )
                for n in pool.counts()
            )
            best = max(best, -(-raw // SHARD_BLOCK))
        return best
    raise TypeError(f"unknown pool spec {type(pool).__name__}")
