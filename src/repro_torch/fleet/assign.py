"""Job -> pool assignment under capacity constraints, and the FleetPlan.

Given the searched grid (:mod:`repro_torch.fleet.grid`), every workload has a
Pareto frontier of placements per pool; an :class:`Option` is one frontier
entry costed *at the pool's own price and grid intensity* (the search runs
at catalog prices — Eq. 32 is linear in the hourly fee, so a pool price
override is a pure rescale applied here).

The solver is deterministic and byte-stable in the :class:`~repro_torch.core.
pareto.TopK` spirit: every stage iterates the canonically-sorted fleet,
ranks with explicit tiebreaks ending in names/indices, and the final pick
among solver candidates compares ``(score, signature)`` where the signature
totally orders assignments. Three solvers run on every plan:

* ``exhaustive`` — exact DFS over (option | skip) per workload, only when
  the combination count fits ``EXHAUSTIVE_LIMIT``;
* ``greedy`` — greedy-with-regret: repeatedly assign the workload with the
  highest (priority, regret, gain), where regret is the gap between its
  best and second-best remaining option;
* ``naive`` — the best *single-pool-per-job* baseline: each job
  independently takes its locally-best placement in priority order.

The emitted plan is the best-scoring of the three (ties keep the earlier
solver), so the plan's aggregate objective is ≥ the naive baseline by
construction — the acceptance floor the paper's money-saving claim scales
up to.

Scores order lexicographically: total assigned priority first (capacity
scarcity drops low-priority jobs first), then the fleet objective value
(aggregate tokens/s, or tokens/s per $/hr), then cheaper-then-cleaner
tiebreaks. A carbon-budgeted fleet treats the budget as a hard constraint.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

from repro_torch.core import wire
from repro_torch.core.api import SearchReport
from repro_torch.core.objectives import DEFAULT_GRAMS_CO2_PER_KWH
from repro_torch.core.pareto import CostedStrategy, carbon_cost
from repro_torch.core.search import SearchCounts
from repro_torch.fleet.spec import FleetObjective, FleetSpec
from repro_torch.hw.catalog import get_device

_PLAN_KIND = "astra.fleet_plan"

# exact assignment below this many (option|skip) combinations; above it the
# greedy-with-regret heuristic carries (still floored by the naive baseline)
EXHAUSTIVE_LIMIT = 20_000


@dataclasses.dataclass(frozen=True)
class Option:
    """One admissible placement: a frontier entry costed at pool prices."""

    workload: str
    pool: str
    devices: int
    choice: CostedStrategy  # the cell report's pool entry (catalog-priced)
    throughput: float  # tokens/s
    dollars_per_hour: float  # at the pool's (possibly overridden) price
    money: float  # $ for the workload's token budget, pool-priced
    train_hours: float
    carbon_kg: float  # at the pool's grid intensity


def build_options(
    canon: FleetSpec, cells
) -> tuple[dict[str, list[Option]], dict[str, str]]:
    """Per-workload placement options from the searched grid.

    ``canon`` must be the canonical fleet (sorted pools/workloads, see
    :meth:`FleetSpec.canonical`). Returns ``(options, empty_reasons)``:
    options sorted deterministically (throughput desc, cost asc, pool name,
    devices), and a reason string per workload that ended up with none.
    """
    pools = {p.name: p for p in canon.pools}
    reports: dict[tuple[str, str], SearchReport] = {
        (c.workload, c.pool): c.report for c in cells
    }
    options: dict[str, list[Option]] = {}
    empty_reasons: dict[str, str] = {}
    for w in canon.workloads:
        opts: list[Option] = []
        frontier_entries = 0
        for p in canon.pools:
            report = reports.get((w.name, p.name))
            if report is None:
                raise ValueError(
                    f"grid is missing cell ({w.name!r}, {p.name!r})"
                )
            scale = (
                p.price_per_hour / get_device(p.device).price_per_hour
                if p.price_per_hour is not None else 1.0
            )
            intensity = (
                p.grams_co2_per_kwh
                if p.grams_co2_per_kwh is not None
                else DEFAULT_GRAMS_CO2_PER_KWH
            )
            for c in report.pool:
                if c.throughput <= 0:
                    continue
                n = c.strategy.num_devices
                if n > p.capacity:
                    continue
                frontier_entries += 1
                train_hours = w.train_tokens / c.throughput / 3600.0
                if (w.deadline_hours is not None
                        and train_hours > w.deadline_hours):
                    continue
                opts.append(Option(
                    workload=w.name,
                    pool=p.name,
                    devices=n,
                    choice=c,
                    throughput=c.throughput,
                    dollars_per_hour=c.sim.money_per_hour * scale,
                    money=c.money * scale,
                    train_hours=train_hours,
                    carbon_kg=carbon_cost(
                        c.strategy, c.sim, w.train_tokens, intensity
                    ),
                ))
        opts.sort(key=lambda o: (
            -o.throughput, o.dollars_per_hour, o.pool, o.devices
        ))
        options[w.name] = opts
        if not opts:
            empty_reasons[w.name] = (
                "deadline_hours filters every placement"
                if frontier_entries else
                "no feasible strategy on any pool"
            )
    return options, empty_reasons


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------

def _value(thr: float, dph: float, objective: FleetObjective) -> float:
    if objective.kind == "throughput_per_dollar":
        return thr / dph if dph > 0 else 0.0
    return thr


def _totals(canon, options, assign):
    thr = dph = carbon = 0.0
    weight = 0
    for i, j in enumerate(assign):
        if j is None:
            continue
        w = canon.workloads[i]
        o = options[w.name][j]
        thr += o.throughput
        dph += o.dollars_per_hour
        carbon += o.carbon_kg
        weight += w.priority
    return weight, thr, dph, carbon


def _score(canon, options, objective, assign) -> Optional[tuple]:
    """Bigger-is-better lexicographic score; None = budget-infeasible."""
    weight, thr, dph, carbon = _totals(canon, options, assign)
    if (objective.kind == "carbon"
            and objective.carbon_budget_kg is not None
            and carbon > objective.carbon_budget_kg):
        return None
    return (weight, _value(thr, dph, objective), -dph, -carbon)


def _signature(assign) -> tuple:
    """Total order on assignments (canonical workload positions; assigned
    before skipped, then lowest option index) — the byte-stability
    tiebreak when two solver candidates score identically."""
    return tuple((0, j) if j is not None else (1, -1) for j in assign)


def _budget_blocks(carbon: float, o: Option, objective: FleetObjective) -> bool:
    return (objective.kind == "carbon"
            and objective.carbon_budget_kg is not None
            and carbon + o.carbon_kg > objective.carbon_budget_kg)


# ---------------------------------------------------------------------------
# the three solvers (all return an option-index-or-None list aligned with
# the canonical workload order)
# ---------------------------------------------------------------------------

def _naive(canon, options, objective):
    """Best single-pool-per-job: each job takes its locally-best placement
    in (priority desc, name) order — the baseline the plan must beat."""
    n = len(canon.workloads)
    assign: list[Optional[int]] = [None] * n
    cap = {p.name: p.capacity for p in canon.pools}
    carbon = 0.0
    order = sorted(
        range(n), key=lambda i: (-canon.workloads[i].priority,
                                 canon.workloads[i].name),
    )
    for i in order:
        w = canon.workloads[i]
        best = None
        for j, o in enumerate(options[w.name]):
            if o.devices > cap[o.pool] or _budget_blocks(carbon, o, objective):
                continue
            if objective.kind == "throughput_per_dollar":
                v = (o.throughput / o.dollars_per_hour
                     if o.dollars_per_hour > 0 else 0.0)
            else:
                v = o.throughput
            if best is None or v > best[0]:
                best = (v, j)
        if best is not None:
            j = best[1]
            o = options[w.name][j]
            assign[i] = j
            cap[o.pool] -= o.devices
            carbon += o.carbon_kg
    return assign


def _greedy(canon, options, objective):
    """Greedy-with-regret: each round, every unassigned workload names its
    best and second-best feasible option by *marginal aggregate* value; the
    workload with the highest (priority, regret, gain) commits its best.
    A single-option workload has infinite regret — it places first, before
    flexible jobs eat its only slot."""
    n = len(canon.workloads)
    assign: list[Optional[int]] = [None] * n
    cap = {p.name: p.capacity for p in canon.pools}
    thr = dph = carbon = 0.0
    unassigned = set(range(n))
    while True:
        best_per: dict[int, tuple[float, int, float]] = {}
        for i in sorted(unassigned):
            w = canon.workloads[i]
            feas = []
            for j, o in enumerate(options[w.name]):
                if (o.devices > cap[o.pool]
                        or _budget_blocks(carbon, o, objective)):
                    continue
                v = _value(thr + o.throughput, dph + o.dollars_per_hour,
                           objective)
                feas.append((v, j))
            if feas:
                feas.sort(key=lambda t: (-t[0], t[1]))
                g1, j1 = feas[0]
                g2 = feas[1][0] if len(feas) > 1 else float("-inf")
                best_per[i] = (g1, j1, g1 - g2)
        if not best_per:
            break
        i = min(best_per, key=lambda i: (
            -canon.workloads[i].priority,  # priority first
            -best_per[i][2],  # then regret
            -best_per[i][0],  # then gain
            canon.workloads[i].name,
        ))
        g1, j1, _ = best_per[i]
        o = options[canon.workloads[i].name][j1]
        assign[i] = j1
        cap[o.pool] -= o.devices
        thr += o.throughput
        dph += o.dollars_per_hour
        carbon += o.carbon_kg
        unassigned.discard(i)
    return assign


def _combo_count(canon, options) -> int:
    count = 1
    for w in canon.workloads:
        count *= len(options[w.name]) + 1
        if count > 10 * EXHAUSTIVE_LIMIT:
            break  # big enough; the exact value no longer matters
    return count


def _exhaustive(canon, options, objective):
    """Exact DFS over (option | skip) per workload with capacity pruning —
    the optimum whenever the combination count admits it."""
    n = len(canon.workloads)
    cap = {p.name: p.capacity for p in canon.pools}
    cur: list[Optional[int]] = [None] * n
    best = {"assign": list(cur), "score": None, "sig": None}

    def leaf():
        score = _score(canon, options, objective, cur)
        if score is None:
            return
        sig = _signature(cur)
        if (best["score"] is None or score > best["score"]
                or (score == best["score"] and sig < best["sig"])):
            best["assign"] = list(cur)
            best["score"] = score
            best["sig"] = sig

    def dfs(i: int, carbon: float):
        if i == n:
            leaf()
            return
        w = canon.workloads[i]
        for j, o in enumerate(options[w.name]):
            if o.devices > cap[o.pool] or _budget_blocks(carbon, o, objective):
                continue
            cap[o.pool] -= o.devices
            cur[i] = j
            dfs(i + 1, carbon + o.carbon_kg)
            cur[i] = None
            cap[o.pool] += o.devices
        dfs(i + 1, carbon)  # skip this workload

    dfs(0, 0.0)
    return best["assign"]


# ---------------------------------------------------------------------------
# the plan (wire-native, exact round-trip)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class JobAssignment:
    """One placed job: where it runs, what it costs, and the cell report
    (the full per-job :class:`~repro_torch.core.api.SearchReport`) it came from."""

    workload: str
    pool: str
    devices: int
    choice: CostedStrategy
    throughput: float
    dollars_per_hour: float
    money: float
    train_hours: float
    carbon_kg: float
    report: SearchReport

    def to_dict(self) -> dict:
        return {
            "workload": self.workload,
            "pool": self.pool,
            "devices": self.devices,
            "choice": self.choice.to_dict(),
            "throughput": wire.dump_float(self.throughput),
            "dollars_per_hour": wire.dump_float(self.dollars_per_hour),
            "money": wire.dump_float(self.money),
            "train_hours": wire.dump_float(self.train_hours),
            "carbon_kg": wire.dump_float(self.carbon_kg),
            "report": self.report.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "JobAssignment":
        return cls(
            workload=d["workload"],
            pool=d["pool"],
            devices=int(d["devices"]),
            choice=CostedStrategy.from_dict(d["choice"]),
            throughput=wire.load_float(d["throughput"]),
            dollars_per_hour=wire.load_float(d["dollars_per_hour"]),
            money=wire.load_float(d["money"]),
            train_hours=wire.load_float(d["train_hours"]),
            carbon_kg=wire.load_float(d["carbon_kg"]),
            report=SearchReport.from_dict(d["report"]),
        )


@dataclasses.dataclass
class PoolUsage:
    """Per-pool utilization: devices claimed vs capacity."""

    pool: str
    device: str
    capacity: int
    used: int

    @property
    def leftover(self) -> int:
        return self.capacity - self.used

    @property
    def utilization(self) -> float:
        return self.used / self.capacity if self.capacity else 0.0

    def to_dict(self) -> dict:
        return {
            "pool": self.pool,
            "device": self.device,
            "capacity": self.capacity,
            "used": self.used,
            "leftover": self.leftover,  # derived; readers shouldn't subtract
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PoolUsage":
        return cls(
            pool=d["pool"], device=d["device"],
            capacity=int(d["capacity"]), used=int(d["used"]),
        )


@dataclasses.dataclass
class FleetPlan:
    """The planner's output: placements, leftovers, totals, and the merged
    search-funnel counters of the distinct grid cells that fed it.

    Wire-native like :class:`~repro_torch.core.api.SearchReport`:
    ``from_json(p.to_json()).to_json() == p.to_json()`` bit for bit, and a
    plan built from a warm grid is byte-identical to the cold one (nothing
    run-dependent — wall-times, warm-hit counts — is stored here; the
    nested reports carry the cached cold-run timings verbatim).
    """

    objective: FleetObjective
    solver: str  # which candidate won: exhaustive | greedy | naive
    assignments: list[JobAssignment]
    unassigned: list[dict]  # {"workload": ..., "reason": ...}
    pools: list[PoolUsage]
    counts: SearchCounts  # merged funnel over distinct grid cells
    total_throughput: float
    total_dollars_per_hour: float
    total_carbon_kg: float
    eta_model_version: Optional[str] = None

    @property
    def throughput_per_dollar(self) -> float:
        if self.total_dollars_per_hour <= 0:
            return 0.0
        return self.total_throughput / self.total_dollars_per_hour

    # -- wire format -------------------------------------------------------
    def to_dict(self) -> dict:
        d = {
            "version": wire.WIRE_VERSION,
            "kind": _PLAN_KIND,
            "objective": dataclasses.asdict(self.objective),
            "solver": self.solver,
            "assignments": [a.to_dict() for a in self.assignments],
            "unassigned": [dict(u) for u in self.unassigned],
            "pools": [p.to_dict() for p in self.pools],
            "counts": self.counts.to_dict(),
            "total_throughput": wire.dump_float(self.total_throughput),
            "total_dollars_per_hour": wire.dump_float(
                self.total_dollars_per_hour
            ),
            "total_carbon_kg": wire.dump_float(self.total_carbon_kg),
        }
        if self.eta_model_version is not None:
            d["eta_model_version"] = self.eta_model_version
        return d

    def to_json(self, *, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict) -> "FleetPlan":
        wire.check_envelope(d, _PLAN_KIND)
        return cls(
            objective=FleetObjective(**(d.get("objective") or {})),
            solver=d["solver"],
            assignments=[
                JobAssignment.from_dict(a) for a in d["assignments"]
            ],
            unassigned=[dict(u) for u in d.get("unassigned", [])],
            pools=[PoolUsage.from_dict(p) for p in d["pools"]],
            counts=SearchCounts.from_dict(d["counts"]),
            total_throughput=wire.load_float(d["total_throughput"]),
            total_dollars_per_hour=wire.load_float(
                d["total_dollars_per_hour"]
            ),
            total_carbon_kg=wire.load_float(d["total_carbon_kg"]),
            eta_model_version=d.get("eta_model_version"),
        )

    @classmethod
    def from_json(cls, text: str) -> "FleetPlan":
        return cls.from_dict(json.loads(text))


def solve(
    fspec: FleetSpec,
    cells,
    counts: Optional[SearchCounts] = None,
    *,
    eta_model_version: Optional[str] = None,
    exhaustive_limit: int = EXHAUSTIVE_LIMIT,
) -> FleetPlan:
    """Assign the searched grid: the best-scoring of exhaustive (when the
    combination count fits ``exhaustive_limit``), greedy-with-regret, and
    the naive single-pool-per-job baseline. Deterministic and
    permutation-invariant: the plan depends only on the fleet's canonical
    content and the cell reports."""
    canon = fspec.canonical()
    options, empty_reasons = build_options(canon, cells)
    objective = canon.objective

    candidates: list[tuple[str, list[Optional[int]]]] = []
    if _combo_count(canon, options) <= exhaustive_limit:
        candidates.append(
            ("exhaustive", _exhaustive(canon, options, objective))
        )
    candidates.append(("greedy", _greedy(canon, options, objective)))
    candidates.append(("naive", _naive(canon, options, objective)))

    best = None  # (label, assign, score, sig); ties keep the earlier solver
    for label, assign in candidates:
        score = _score(canon, options, objective, assign)
        if score is None:
            continue  # a budget-infeasible candidate never ships
        sig = _signature(assign)
        if (best is None or score > best[2]
                or (score == best[2] and sig < best[3])):
            best = (label, assign, score, sig)
    if best is None:  # every candidate infeasible: ship the empty plan
        empty = [None] * len(canon.workloads)
        best = ("naive", empty, _score(canon, options, objective, empty),
                _signature(empty))
    label, assign, _, _ = best

    reports = {(c.workload, c.pool): c.report for c in cells}
    assignments: list[JobAssignment] = []
    unassigned: list[dict] = []
    used = {p.name: 0 for p in canon.pools}
    for i, w in enumerate(canon.workloads):
        j = assign[i]
        if j is None:
            reason = empty_reasons.get(w.name)
            if reason is None:
                reason = (
                    "carbon budget exhausted"
                    if (objective.kind == "carbon"
                        and objective.carbon_budget_kg is not None)
                    else "insufficient pool capacity"
                )
            unassigned.append({"workload": w.name, "reason": reason})
            continue
        o = options[w.name][j]
        used[o.pool] += o.devices
        assignments.append(JobAssignment(
            workload=w.name, pool=o.pool, devices=o.devices,
            choice=o.choice, throughput=o.throughput,
            dollars_per_hour=o.dollars_per_hour, money=o.money,
            train_hours=o.train_hours, carbon_kg=o.carbon_kg,
            report=reports[(w.name, o.pool)],
        ))
    _, thr, dph, carbon = _totals(canon, options, assign)
    merged = SearchCounts()
    if counts is not None:
        merged.merge(counts)
    else:
        seen: set[str] = set()
        for c in cells:
            if c.key not in seen:
                seen.add(c.key)
                merged.merge(c.report.counts)
    return FleetPlan(
        objective=objective,
        solver=label,
        assignments=assignments,
        unassigned=unassigned,
        pools=[
            PoolUsage(pool=p.name, device=p.device, capacity=p.capacity,
                      used=used[p.name])
            for p in canon.pools
        ],
        counts=merged,
        total_throughput=thr,
        total_dollars_per_hour=dph,
        total_carbon_kg=carbon,
        eta_model_version=eta_model_version,
    )
