"""Money-limit search (paper §3.6, Eq. 29-33) + incremental ranking.

The optimal pool keeps strategies not dominated in (throughput up, cost
down); the final pick is the highest-throughput pool member whose monetary
cost (Eq. 32: M_i = T_i * N_g * F_g, with T_i the time to train the user's
token budget) fits the user's limit.

Besides the batch functions (``optimal_pool`` / ``sort_strategies`` /
``pick_within_budget``), this module hosts their incremental counterparts —
:class:`TopK` and :class:`ParetoStaircase` — which the streaming evaluator
pushes candidates through one at a time so a search never materializes its
full ``CostedStrategy`` list. Both are proven equivalent to the batch
functions on the same candidate multiset (tests/test_batch_sim.py).

Both collectors are *mergeable*: ``push`` optionally takes an explicit
``seq`` — a tuple that totally orders candidates by their position in the
(sharded) candidate stream — and ``merge`` folds another collector in.
Because full-key ties break on ``seq`` (not on arrival order), N shard
collectors merged in any order reproduce the serial collector exactly,
which is what makes the parallel evaluation engine
(:mod:`repro_torch.core.backend`) byte-identical to a serial search.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import itertools
from typing import Callable, Optional, Sequence

from repro_torch.core import wire
from repro_torch.core.params import ParallelStrategy
from repro_torch.core.simulate import SimResult
from repro_torch.hw.catalog import get_device


@dataclasses.dataclass(frozen=True)
class CostedStrategy:
    strategy: ParallelStrategy
    sim: SimResult
    throughput: float  # P_i (tokens/s)
    money: float  # C_i ($ for the training budget)

    # -- wire format -------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "strategy": self.strategy.to_dict(),
            "sim": self.sim.to_dict(),
            "throughput": wire.dump_float(self.throughput),
            "money": wire.dump_float(self.money),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CostedStrategy":
        return cls(
            strategy=ParallelStrategy.from_dict(d["strategy"]),
            sim=SimResult.from_dict(d["sim"]),
            throughput=wire.load_float(d["throughput"]),
            money=wire.load_float(d["money"]),
        )


def money_cost(sim: SimResult, train_tokens: float) -> float:
    """Eq. 32 for a fixed token budget: T_i = tokens/throughput; M = T * rate."""
    if sim.throughput_tokens <= 0:
        return float("inf")
    hours = train_tokens / sim.throughput_tokens / 3600.0
    return hours * sim.money_per_hour


def strategy_watts(strategy: ParallelStrategy) -> float:
    """Aggregate board power (TDP) of every device a strategy occupies.

    Heterogeneous placements sum per-type: each of the ``m_i`` stages of
    type i holds ``num_devices / P`` devices (the D*T devices per stage)."""
    if strategy.hetero is None:
        return strategy.num_devices * get_device(strategy.device).tdp_watts
    pl = strategy.hetero
    per_stage = strategy.num_devices // max(pl.pp, 1)
    return sum(
        m * per_stage * get_device(dev).tdp_watts
        for dev, m in zip(pl.devices, pl.stages_per_type)
    )


def carbon_cost(
    strategy: ParallelStrategy,
    sim: SimResult,
    train_tokens: float,
    grams_co2_per_kwh: float,
) -> float:
    """kg CO2e to train the token budget: TDP-hours x grid intensity.

    The same shape as :func:`money_cost` with watts standing in for the
    hourly fee — a compute-duration proxy (no PUE, no idle draw), which is
    exactly the granularity the strategy search can influence."""
    if sim.throughput_tokens <= 0:
        return float("inf")
    hours = train_tokens / sim.throughput_tokens / 3600.0
    kwh = strategy_watts(strategy) / 1000.0 * hours
    return kwh * grams_co2_per_kwh / 1000.0


def optimal_pool(candidates: Sequence[CostedStrategy]) -> list[CostedStrategy]:
    """Eq. 30-31: S_opt = non-dominated set (no strictly-better-and-cheaper)."""
    ordered = sort_strategies(candidates)
    pool: list[CostedStrategy] = []
    best_cost = float("inf")
    for c in ordered:  # descending throughput: keep strictly cheaper entries
        if c.money < best_cost:
            pool.append(c)
            best_cost = c.money
    return pool


def sort_strategies(candidates: Sequence[CostedStrategy]) -> list[CostedStrategy]:
    """Eq. 33: throughput descending, ties by cost ascending."""
    return sorted(candidates, key=lambda c: (-c.throughput, c.money))


def pick_within_budget(
    pool: Sequence[CostedStrategy], money_limit: Optional[float]
) -> Optional[CostedStrategy]:
    """Highest-throughput pool entry meeting the money constraint."""
    for c in sort_strategies(pool):
        if money_limit is None or c.money <= money_limit:
            return c
    return None


# ---------------------------------------------------------------------------
# incremental (streaming) counterparts
# ---------------------------------------------------------------------------

def _eq33_key(c: CostedStrategy) -> tuple:
    """Bigger-is-better key realizing the Eq. 33 order."""
    return (c.throughput, -c.money)


class TopK:
    """Incremental top-k under a bigger-is-better key (default: Eq. 33 —
    throughput descending, money-cost tiebreak ascending). Matches
    ``sort_strategies(all)[:k]`` for the default key.

    ``push(c, seq=...)`` pins the candidate's stream position explicitly (a
    tuple; lexicographically smaller = earlier); without it an internal
    arrival counter is used. Full-key ties resolve to the earliest ``seq``,
    so shard collectors pushed with global stream positions merge into the
    exact serial result regardless of merge order.
    """

    def __init__(self, k: int, key: Callable[[CostedStrategy], tuple] = _eq33_key):
        self.k = max(k, 0)
        self.key = key
        # heap entries: (full_key, local_insertion_id, CostedStrategy). The
        # full key ends with the negated seq tuple, so bigger key == better
        # or earlier; the local id keeps heap comparisons away from the
        # (unorderable) CostedStrategy even if two merged entries collide.
        self._heap: list = []
        self._counter = itertools.count()

    def push(self, c: CostedStrategy, seq: Optional[tuple] = None) -> None:
        if self.k == 0:
            return
        if seq is None:
            seq = (next(self._counter),)
        self._push_key(self.key(c) + (tuple(-x for x in seq),), c)

    def _push_key(self, key: tuple, c: CostedStrategy) -> None:
        entry = (key, next(self._counter), c)
        if len(self._heap) < self.k:
            heapq.heappush(self._heap, entry)
        elif key > self._heap[0][0]:
            heapq.heapreplace(self._heap, entry)

    def merge(self, other: "TopK") -> None:
        """Fold another TopK (same ``k`` and key function) into this one.

        Entries keep their original seq-tiebroken keys, so merging the
        per-shard collectors of a partitioned stream — in any order —
        yields exactly the serial collector's top-k."""
        for key, _, c in other._heap:
            self._push_key(key, c)

    def entries(self) -> list[tuple[tuple, CostedStrategy]]:
        """Best-first ``(seq, candidate)`` pairs — the mergeable state, used
        to ship a shard collector across a process boundary."""
        out = []
        for key, _, c in sorted(self._heap, reverse=True):
            out.append((tuple(-x for x in key[-1]), c))
        return out

    def sorted(self) -> list[CostedStrategy]:
        # stable descending sort on the tiebroken key reproduces the batch
        # sort order exactly (earliest-seen wins full-key ties)
        return [c for _, _, c in sorted(self._heap, reverse=True)]


class CellBest:
    """Incremental per-pool-cell champion under a bigger-is-better key.

    A *cell* is one ``(device, num_devices)`` point of the pool — the unit
    elastic re-search (:mod:`repro_torch.core.elastic`) reasons about when a pool
    shrinks or grows. Top-k and the Pareto staircase concentrate on the
    globally best candidates, which often collapse into a single cell; the
    cell champions are what let a warm start vouch for *every* overlapped
    cell: the champion dominates its whole cell under the objective key, so
    re-simulating the champions alone finds the exact best of the retained
    region.

    Mergeable with the same seq discipline as :class:`TopK`: full-key ties
    resolve to the earliest stream position, so shard collectors merge into
    the serial result in any order. State is one entry per cell — bounded
    by the pool shape, not the candidate count.
    """

    def __init__(self, key: Callable[[CostedStrategy], tuple] = _eq33_key):
        self.key = key
        # cell -> (full_key, seq, candidate); full_key ends with the negated
        # seq so bigger == better-or-earlier, exactly like TopK
        self._best: dict[tuple, tuple] = {}
        self._counter = itertools.count()

    @staticmethod
    def cell_of(c: CostedStrategy) -> tuple:
        return (c.strategy.device, c.strategy.num_devices)

    def push(self, c: CostedStrategy, seq: Optional[tuple] = None) -> None:
        if seq is None:
            seq = (next(self._counter),)
        seq = tuple(seq)
        self._push_key(self.key(c) + (tuple(-x for x in seq),), seq, c)

    def _push_key(self, full_key: tuple, seq: tuple, c: CostedStrategy) -> None:
        cell = self.cell_of(c)
        cur = self._best.get(cell)
        if cur is None or full_key > cur[0]:
            self._best[cell] = (full_key, seq, c)

    def merge(self, other: "CellBest") -> None:
        """Fold another CellBest (same key function) in, order-independent."""
        for full_key, seq, c in other._best.values():
            self._push_key(full_key, seq, c)

    def entries(self) -> list[tuple[tuple, CostedStrategy]]:
        """``(seq, champion)`` pairs in deterministic cell order — the
        mergeable state for cross-process transport."""
        return [
            (seq, c) for _, (_, seq, c) in sorted(self._best.items())
        ]

    def sorted(self) -> list[CostedStrategy]:
        """Champions in deterministic cell order (device, then count)."""
        return [c for _, (_, _, c) in sorted(self._best.items())]


class ParetoStaircase:
    """Incremental Eq. 30-31 non-dominated pool.

    Invariant: ``_thr`` ascending, ``_money`` strictly ascending (each pool
    member trades money for throughput). Matches :func:`optimal_pool` on the
    same candidate multiset.

    Like :class:`TopK`, ``push`` takes an optional explicit ``seq`` stream
    position: exact (throughput, money) ties keep the earliest-``seq``
    candidate, which makes the staircase a pure function of the pushed
    multiset — shard staircases ``merge`` into the serial one in any order.
    """

    def __init__(self):
        self._thr: list[float] = []
        self._money: list[float] = []
        self._items: list[CostedStrategy] = []
        self._seqs: list[tuple] = []
        self._counter = itertools.count()

    def push(self, c: CostedStrategy, seq: Optional[tuple] = None) -> None:
        if seq is None:
            seq = (next(self._counter),)
        thr, money = c.throughput, c.money
        i = bisect.bisect_right(self._thr, thr)
        # dominated (or duplicate): an as-fast-or-faster member at most as
        # expensive. Equal-throughput members sit at i-1; strictly faster
        # members start at i with the cheapest of them first.
        if i > 0 and self._thr[i - 1] == thr and self._money[i - 1] <= money:
            # exact-tie point: represented by the earliest-seq candidate
            if self._money[i - 1] == money and seq < self._seqs[i - 1]:
                self._items[i - 1] = c
                self._seqs[i - 1] = seq
            return
        if i < len(self._thr) and self._money[i] <= money:
            return
        # remove members this candidate dominates (<= throughput, >= money)
        k = i
        while k > 0 and self._money[k - 1] >= money:
            k -= 1
        del self._thr[k:i], self._money[k:i], self._items[k:i], self._seqs[k:i]
        self._thr.insert(k, thr)
        self._money.insert(k, money)
        self._items.insert(k, c)
        self._seqs.insert(k, seq)

    def merge(self, other: "ParetoStaircase") -> None:
        """Fold another staircase in (order-independent — see class doc)."""
        for c, seq in zip(other._items, other._seqs):
            self.push(c, seq=seq)

    def entries(self) -> list[tuple[tuple, CostedStrategy]]:
        """``(seq, candidate)`` pairs, throughput descending — the
        mergeable state for cross-process transport."""
        return [(seq, c) for seq, c in
                zip(reversed(self._seqs), reversed(self._items))]

    def sorted(self) -> list[CostedStrategy]:
        return list(reversed(self._items))  # throughput descending
