"""Pluggable search objectives (ranking + budget selection).

An :class:`Objective` owns everything downstream of simulation: the
incremental collector candidates are pushed through while streaming, the
final top ranking, and the best-pick rule. The three built-ins cover the
paper's modes — Eq. 33 throughput ranking, the Eq. 30-31 Pareto pool with
the Eq. 32 money-limit pick, and a cheapest-plan objective — and new
objectives plug in without touching the facade or the planner.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.pareto import (
    CellBest,
    CostedStrategy,
    ParetoStaircase,
    TopK,
    carbon_cost,
    pick_within_budget,
)
from repro_torch.core.spec import ObjectiveSpec

# global-average grid intensity (g CO2e per kWh) when the spec doesn't pin
# a region; the objective only needs a consistent scale to rank plans
DEFAULT_GRAMS_CO2_PER_KWH = 450.0


class Collector:
    """Streaming sink: incremental top-k (+ optional Pareto pool).

    Holds at most ``top_k`` + pool-member candidates no matter how many are
    pushed — this is what lets every mode stream instead of materializing.

    Mergeable: ``push`` forwards an optional explicit stream-position
    ``seq`` to both underlying collectors, and ``merge`` folds another
    collector (same objective, same ``top_k``) in — the primitive the
    parallel evaluation engine reduces shard results with.
    """

    def __init__(self, top_k: int, *, keep_pool: bool, key=None):
        self.topk = TopK(top_k, key) if key is not None else TopK(top_k)
        self.pool = ParetoStaircase() if keep_pool else None
        # per-(device, num_devices) champions under the same key: one entry
        # per pool cell, the seed set elastic re-search warm-starts from
        self.cells = CellBest(key) if key is not None else CellBest()

    def push(self, c: CostedStrategy, seq=None) -> None:
        self.topk.push(c, seq=seq)
        if self.pool is not None:
            self.pool.push(c, seq=seq)
        self.cells.push(c, seq=seq)

    def merge(self, other: "Collector") -> None:
        self.topk.merge(other.topk)
        if self.pool is not None and other.pool is not None:
            self.pool.merge(other.pool)
        self.cells.merge(other.cells)

    def results(self) -> tuple[list[CostedStrategy], list[CostedStrategy]]:
        """(ranked top-k, Pareto pool — empty when the objective keeps none)."""
        return self.topk.sorted(), self.pool.sorted() if self.pool else []


class Objective:
    """Base: rank by Eq. 33, keep no pool, pick the top candidate."""

    wants_pool = False

    def collector(self, top_k: int) -> Collector:
        return Collector(top_k, keep_pool=self.wants_pool)

    def select(
        self, top: list[CostedStrategy], pool: list[CostedStrategy]
    ) -> Optional[CostedStrategy]:
        return top[0] if top else None


class ThroughputObjective(Objective):
    """Fastest plan (modes 1 and 2)."""


@dataclasses.dataclass
class ParetoObjective(Objective):
    """Eq. 29-33 money-limit search: keep the non-dominated pool, pick the
    fastest member whose token-budget cost fits ``budget`` (mode 3)."""

    budget: Optional[float] = None
    wants_pool = True

    def select(self, top, pool):
        return pick_within_budget(pool, self.budget)


@dataclasses.dataclass
class MoneyObjective(Objective):
    """Cheapest plan for the token budget; rank by money ascending with a
    throughput tiebreak. ``budget`` (optional) caps admissible cost."""

    budget: Optional[float] = None
    wants_pool = True

    def collector(self, top_k: int) -> Collector:
        return Collector(
            top_k, keep_pool=True, key=lambda c: (-c.money, c.throughput)
        )

    def select(self, top, pool):
        for c in top:
            if self.budget is None or c.money <= self.budget:
                return c
        return None


@dataclasses.dataclass
class LatencyObjective(Objective):
    """Latency-SLO objective: cheapest plan whose simulated step time meets
    ``slo_seconds``. SLO-satisfiers rank first (money ascending, throughput
    tiebreak); ``select`` returns None when nothing meets the SLO. With no
    SLO it degenerates to the lowest-step-time plan.

    For a serving workload ``sim.step_time`` is the mix-weighted per-token
    decode latency, so ``slo_seconds`` reads as a *per-token* SLO: the
    objective returns the cheapest deployment that generates each token
    within the bound. ``ObjectiveSpec.latency()`` with no explicit SLO
    falls back to the workload's ``inference.slo_per_token`` (see
    :func:`make_objective`).
    """

    slo_seconds: Optional[float] = None
    wants_pool = True

    def meets(self, c: CostedStrategy) -> bool:
        return self.slo_seconds is None or c.sim.step_time <= self.slo_seconds

    def collector(self, top_k: int) -> Collector:
        if self.slo_seconds is None:
            key = lambda c: (-c.sim.step_time, c.throughput)  # noqa: E731
        else:
            key = lambda c: (self.meets(c), -c.money, c.throughput)  # noqa: E731
        return Collector(top_k, keep_pool=True, key=key)

    def select(self, top, pool):
        if top and self.meets(top[0]):
            return top[0]
        return None


@dataclasses.dataclass
class CarbonObjective(Objective):
    """Carbon/energy objective: lowest-emissions plan for the token budget.

    Emissions are TDP-hours x grid intensity (:func:`carbon_cost`), ranked
    ascending with a throughput tiebreak — the same collector-key + select
    shape as the latency-SLO objective. ``budget_kg`` (optional) caps
    admissible kg CO2e; ``select`` returns None when nothing fits.
    """

    budget_kg: Optional[float] = None
    grams_co2_per_kwh: float = DEFAULT_GRAMS_CO2_PER_KWH
    train_tokens: float = 1e9
    wants_pool = True

    def carbon(self, c: CostedStrategy) -> float:
        return carbon_cost(
            c.strategy, c.sim, self.train_tokens, self.grams_co2_per_kwh
        )

    def collector(self, top_k: int) -> Collector:
        return Collector(
            top_k, keep_pool=True,
            key=lambda c: (-self.carbon(c), c.throughput),
        )

    def select(self, top, pool):
        for c in top:
            if self.budget_kg is None or self.carbon(c) <= self.budget_kg:
                return c
        return None


def make_objective(
    spec: ObjectiveSpec, *, train_tokens: float = 1e9, inference=None
) -> Objective:
    """Lower a declarative :class:`ObjectiveSpec` onto its implementation.

    ``train_tokens`` (the workload's token budget) parameterizes the
    objectives whose metric integrates over the whole training run.
    ``inference`` (the workload's :class:`~repro_torch.core.spec.InferenceShape`,
    when serving) supplies the default per-token SLO for a latency
    objective that doesn't pin its own ``slo_seconds``."""
    if spec.kind == "throughput":
        return ThroughputObjective()
    if spec.kind == "money":
        return MoneyObjective(budget=spec.budget)
    if spec.kind == "pareto":
        return ParetoObjective(budget=spec.budget)
    if spec.kind == "latency":
        slo = spec.slo_seconds
        if slo is None and inference is not None:
            slo = inference.slo_per_token
        return LatencyObjective(slo_seconds=slo)
    if spec.kind == "carbon":
        return CarbonObjective(
            budget_kg=spec.budget,
            grams_co2_per_kwh=(
                spec.grams_co2_per_kwh
                if spec.grams_co2_per_kwh is not None
                else DEFAULT_GRAMS_CO2_PER_KWH
            ),
            train_tokens=train_tokens,
        )
    raise ValueError(f"unknown objective kind {spec.kind!r}")
