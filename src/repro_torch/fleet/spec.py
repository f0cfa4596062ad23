"""Declarative fleet-planning specification (the planner's input).

A :class:`FleetSpec` describes one capacity-planning problem: *which pools*
(named heterogeneous GPU pools with a device type, a capacity, an optional
price override and an optional grid carbon intensity), *which jobs* (a queue
of named training workloads with priorities and optional deadline hints),
and *what the fleet optimizes* (aggregate throughput, aggregate
throughput-per-dollar, or throughput under a fleet-wide carbon budget).

The planner (:mod:`repro_torch.fleet.grid` + :mod:`repro_torch.fleet.assign`) lowers the
workload x pool grid onto ordinary :class:`~repro_torch.core.spec.SearchSpec`s, so
every cell rides the existing search pipeline, execution backends, and the
service's spec-keyed cache.

Specs follow the :mod:`repro_torch.core.spec` discipline: JSON round-trip via
``to_json``/``from_json``, a canonical content identity via
``canonicalize()``/``cache_key()`` that is insensitive to JSON spelling
*and* to pool/workload ordering (the grid and the assignment solver are
permutation-invariant, so a re-ordered fleet must hit the same cached plan).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional

from repro_torch.core.arch import ModelArch
from repro_torch.core.spec import Limits, _canonical


@dataclasses.dataclass(frozen=True)
class GpuPool:
    """One named homogeneous slice of the fleet.

    ``price_per_hour`` (per device) overrides the catalog list price —
    reserved-capacity discounts, spot pricing — and ``grams_co2_per_kwh``
    pins the pool's grid carbon intensity (regional fleets). Both default
    to the catalog / global values. The price and intensity are *assignment*
    parameters, not search parameters: grid cells are searched at catalog
    prices so pools with the same device type and capacity share cache
    entries, and the override is applied as a linear rescale when the
    solver costs an option (Eq. 32 money is linear in the hourly fee).
    """

    name: str
    device: str
    capacity: int
    price_per_hour: Optional[float] = None
    grams_co2_per_kwh: Optional[float] = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("pool name must be non-empty")
        if self.capacity < 1:
            raise ValueError(
                f"pool {self.name!r}: capacity must be >= 1, got {self.capacity}"
            )
        if self.price_per_hour is not None and self.price_per_hour <= 0:
            raise ValueError(
                f"pool {self.name!r}: price_per_hour must be positive"
            )
        if self.grams_co2_per_kwh is not None and self.grams_co2_per_kwh <= 0:
            raise ValueError(
                f"pool {self.name!r}: grams_co2_per_kwh must be positive"
            )


@dataclasses.dataclass(frozen=True)
class FleetWorkload:
    """One queued training job.

    ``priority`` orders jobs when capacity is scarce (higher wins — the
    solver maximizes total assigned priority before the fleet objective).
    ``deadline_hours``, when set, drops any placement whose simulated
    training time for ``train_tokens`` exceeds it. ``space`` is the
    per-cell parameter-space override forwarded to every lowered
    :class:`~repro_torch.core.spec.SearchSpec` (Eq. 9).
    """

    name: str
    arch: ModelArch
    global_batch: int
    seq: int
    train_tokens: float = 1e9
    priority: int = 1
    deadline_hours: Optional[float] = None
    space: Optional[dict] = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("workload name must be non-empty")
        if self.priority < 0:
            raise ValueError(
                f"workload {self.name!r}: priority must be >= 0"
            )
        if self.deadline_hours is not None and self.deadline_hours <= 0:
            raise ValueError(
                f"workload {self.name!r}: deadline_hours must be positive"
            )


FLEET_OBJECTIVE_KINDS = ("throughput", "throughput_per_dollar", "carbon")


@dataclasses.dataclass(frozen=True)
class FleetObjective:
    """What the fleet optimizes across all assigned jobs.

    ``throughput``            — maximize aggregate tokens/s.
    ``throughput_per_dollar`` — maximize aggregate tokens/s per aggregate
                                $/hr (the paper's money-saving mode, fleet
                                scale).
    ``carbon``                — maximize aggregate tokens/s subject to the
                                summed training emissions staying within
                                ``carbon_budget_kg`` (None = report-only).
    """

    kind: str = "throughput_per_dollar"
    carbon_budget_kg: Optional[float] = None

    def __post_init__(self):
        if self.kind not in FLEET_OBJECTIVE_KINDS:
            raise ValueError(
                f"unknown fleet objective {self.kind!r};"
                f" expected one of {FLEET_OBJECTIVE_KINDS}"
            )
        if self.carbon_budget_kg is not None:
            if self.kind != "carbon":
                raise ValueError(
                    "carbon_budget_kg only applies to the carbon objective,"
                    f" not {self.kind!r}"
                )
            if self.carbon_budget_kg <= 0:
                raise ValueError("carbon_budget_kg must be positive")

    @staticmethod
    def throughput() -> "FleetObjective":
        return FleetObjective("throughput")

    @staticmethod
    def throughput_per_dollar() -> "FleetObjective":
        return FleetObjective("throughput_per_dollar")

    @staticmethod
    def carbon(budget_kg: Optional[float] = None) -> "FleetObjective":
        return FleetObjective("carbon", carbon_budget_kg=budget_kg)


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """One declarative fleet-planning problem. See the module docstring.

    ``limits`` is forwarded to every lowered cell spec; like
    :class:`~repro_torch.core.spec.SearchSpec`, its ``workers``/``fleet`` fields
    are execution details excluded from the plan's cache identity.
    """

    pools: tuple[GpuPool, ...]
    workloads: tuple[FleetWorkload, ...]
    objective: FleetObjective = FleetObjective()
    limits: Limits = Limits()

    def __post_init__(self):
        if not self.pools:
            raise ValueError("FleetSpec needs at least one pool")
        if not self.workloads:
            raise ValueError("FleetSpec needs at least one workload")
        names = [p.name for p in self.pools]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate pool names in {names}")
        names = [w.name for w in self.workloads]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate workload names in {names}")

    # -- canonical ordering ------------------------------------------------
    def canonical(self) -> "FleetSpec":
        """The same fleet with pools and workloads sorted by name — the
        order every planner stage iterates in, so the emitted plan is a
        pure function of the fleet's *content*, not its spelling."""
        return dataclasses.replace(
            self,
            pools=tuple(sorted(self.pools, key=lambda p: p.name)),
            workloads=tuple(sorted(self.workloads, key=lambda w: w.name)),
        )

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        limits_d = dataclasses.asdict(self.limits)
        if limits_d.get("fleet") is None:
            limits_d.pop("fleet", None)
        else:
            limits_d["fleet"] = list(limits_d["fleet"])
        return {
            "version": 1,
            "pools": [dataclasses.asdict(p) for p in self.pools],
            "workloads": [dataclasses.asdict(w) for w in self.workloads],
            "objective": dataclasses.asdict(self.objective),
            "limits": limits_d,
        }

    def to_json(self, *, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict) -> "FleetSpec":
        version = d.get("version", 1)
        if version != 1:
            raise ValueError(f"unsupported FleetSpec version {version!r}")
        workloads = []
        for wd in d["workloads"]:
            wd = dict(wd)
            wd["arch"] = ModelArch(**wd["arch"])
            workloads.append(FleetWorkload(**wd))
        from repro_torch.core.spec import _limits_from_dict

        return cls(
            pools=tuple(GpuPool(**pd) for pd in d["pools"]),
            workloads=tuple(workloads),
            objective=FleetObjective(**(d.get("objective") or {})),
            limits=_limits_from_dict(d.get("limits")),
        )

    @classmethod
    def from_json(cls, text: str) -> "FleetSpec":
        return cls.from_dict(json.loads(text))

    # -- canonical identity ------------------------------------------------
    def canonicalize(self) -> dict:
        """Canonical content dict (see :meth:`SearchSpec.canonicalize`):
        derived from the constructed dataclasses with ``None`` dropped,
        integral floats normalized, pools/workloads sorted by name, and the
        execution-detail limits (``workers``/``fleet``) removed."""
        d = _canonical(self.canonical().to_dict())
        d.get("limits", {}).pop("workers", None)
        d.get("limits", {}).pop("fleet", None)
        return d

    def canonical_json(self) -> str:
        return json.dumps(
            self.canonicalize(), sort_keys=True, separators=(",", ":")
        )

    def cache_key(self) -> str:
        """Stable content hash — the identity a
        :class:`~repro_torch.serve.search_service.SearchService` caches the
        serialized :class:`~repro_torch.fleet.assign.FleetPlan` under."""
        return hashlib.sha256(self.canonical_json().encode()).hexdigest()
