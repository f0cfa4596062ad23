"""Declarative search specification (the unified entry point's input).

A :class:`SearchSpec` is a serializable description of one Astra search:
*what* to search (arch + workload), *over which pool* (one of the three
``PoolSpec`` shapes, unifying the paper's three modes), *optimizing what*
(an :class:`ObjectiveSpec`), under which space/limits. The planner
(:mod:`repro_torch.core.planner`) lowers a spec into tagged candidate streams and
the streaming evaluator scores them — no mode-specific code paths.

Specs round-trip through JSON (``to_json`` / ``from_json``) so a search can
be shipped to a service, queued, or replayed byte-for-byte.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional, Union

from repro_torch.core.arch import ModelArch
from repro_torch.core.hetero import HeteroPool


@dataclasses.dataclass(frozen=True)
class InferenceShape:
    """The serving shape of a :class:`Workload` (absent for training).

    ``prefill_len`` is the dense prompt forward, ``decode_len`` the number
    of autoregressive per-token steps scored per request. ``batch_mix`` is
    the request-arrival mix as ``(batch_size, weight)`` pairs — empty means
    one batch at ``Workload.global_batch`` with weight 1. ``slo_per_token``
    is the per-token decode-latency SLO in seconds; when set it is the
    default bound for :meth:`ObjectiveSpec.latency`.
    """

    prefill_len: int
    decode_len: int
    batch_mix: tuple[tuple[int, float], ...] = ()
    slo_per_token: Optional[float] = None

    def __post_init__(self):
        if self.prefill_len < 1:
            raise ValueError(
                f"prefill_len must be >= 1, got {self.prefill_len}"
            )
        if self.decode_len < 1:
            raise ValueError(f"decode_len must be >= 1, got {self.decode_len}")
        for b, w in self.batch_mix:
            if b < 1:
                raise ValueError(f"batch_mix batch sizes must be >= 1, got {b}")
            if w <= 0:
                raise ValueError(f"batch_mix weights must be > 0, got {w}")
        if self.slo_per_token is not None and self.slo_per_token <= 0:
            raise ValueError(
                f"slo_per_token must be positive, got {self.slo_per_token}"
            )

    def mix(self, global_batch: int) -> tuple[tuple[int, float], ...]:
        """The effective request mix: ``batch_mix`` normalized to sum to 1,
        or a single entry at ``global_batch`` when no mix was given."""
        if not self.batch_mix:
            return ((int(global_batch), 1.0),)
        total = sum(w for _, w in self.batch_mix)
        return tuple((int(b), w / total) for b, w in self.batch_mix)

    def to_dict(self) -> dict:
        d = {"prefill_len": self.prefill_len, "decode_len": self.decode_len}
        # sparse: defaults stay off the wire, like limits.fleet
        if self.batch_mix:
            d["batch_mix"] = [[int(b), float(w)] for b, w in self.batch_mix]
        if self.slo_per_token is not None:
            d["slo_per_token"] = self.slo_per_token
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "InferenceShape":
        return cls(
            prefill_len=int(d["prefill_len"]),
            decode_len=int(d["decode_len"]),
            batch_mix=tuple(
                (int(b), float(w)) for b, w in d.get("batch_mix") or ()
            ),
            slo_per_token=d.get("slo_per_token"),
        )


@dataclasses.dataclass(frozen=True)
class Workload:
    """The workload a strategy is scored on: a training step by default,
    or batched serving when ``inference`` is set."""

    global_batch: int
    seq: int
    train_tokens: float = 1e9  # token budget for the Eq. 32 money cost
    inference: Optional[InferenceShape] = None


# ---------------------------------------------------------------------------
# pool union: the paper's three GPU-pool shapes as one declarative type
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FixedPool:
    """Mode 1: one device type at a fixed count."""

    device: str
    num_devices: int

    kind = "fixed"


@dataclasses.dataclass(frozen=True)
class HeteroCaps:
    """Mode 2: total budget + per-type caps (paper Eq. 2).

    ``fast`` picks the water-filling placement solver over the paper's full
    enumeration; ``prune_slack`` bounds the per-composition water-filling
    minimax and skips dominated compositions (``None`` disables pruning).
    """

    total_devices: int
    type_caps: tuple[tuple[str, int], ...]
    fast: bool = True
    # calibrated default: tests/test_prune_calibration.py measures the
    # tightest optimum-preserving slack at 1.0 on every seed fixture
    # (including the 64- and 48-device pools); 1.2 keeps a safety margin
    # over the FLOPs-proxy gap while pruning harder than the old 1.5
    prune_slack: Optional[float] = 1.2

    kind = "hetero"

    def to_pool(self) -> HeteroPool:
        return HeteroPool(
            total_devices=self.total_devices, type_caps=self.type_caps
        )

    @staticmethod
    def of(pool: HeteroPool, *, fast: bool = True,
           prune_slack: Optional[float] = 1.2) -> "HeteroCaps":
        return HeteroCaps(
            total_devices=pool.total_devices, type_caps=pool.type_caps,
            fast=fast, prune_slack=prune_slack,
        )


@dataclasses.dataclass(frozen=True)
class DeviceSweep:
    """Mode 3: device type(s) x power-of-two count sweep up to a cap."""

    devices: tuple[str, ...]
    max_devices: int
    min_devices: int = 2

    kind = "sweep"

    def __post_init__(self):
        # min_devices=0 would spin counts() forever (0 *= 2 stays 0) and
        # min > max would silently sweep nothing — both are spec errors
        if self.min_devices < 1:
            raise ValueError(
                f"min_devices must be >= 1, got {self.min_devices}"
            )
        if self.min_devices > self.max_devices:
            raise ValueError(
                f"min_devices ({self.min_devices}) must be <= "
                f"max_devices ({self.max_devices})"
            )

    def counts(self) -> list[int]:
        out, n = [], self.min_devices
        while n <= self.max_devices:
            out.append(n)
            n *= 2
        return out


PoolSpec = Union[FixedPool, HeteroCaps, DeviceSweep]
_POOL_KINDS = {"fixed": FixedPool, "hetero": HeteroCaps, "sweep": DeviceSweep}


# ---------------------------------------------------------------------------
# objective + limits
# ---------------------------------------------------------------------------

OBJECTIVE_KINDS = ("throughput", "money", "pareto", "latency", "carbon")


@dataclasses.dataclass(frozen=True)
class ObjectiveSpec:
    """What the search optimizes.

    ``throughput`` — fastest plan (Eq. 33 ranking).
    ``money``      — cheapest plan for the token budget (optionally under
                     ``budget`` dollars).
    ``pareto``     — keep the Eq. 30-31 non-dominated pool; the best pick is
                     the fastest pool member within ``budget`` (the paper's
                     money-limit mode; ``budget=None`` means unlimited).
    ``latency``    — cheapest plan whose simulated step time meets
                     ``slo_seconds`` (``slo_seconds=None`` degenerates to
                     the lowest-step-time plan).
    ``carbon``     — lowest-emissions plan for the token budget (TDP-hours
                     x ``grams_co2_per_kwh`` grid intensity; ``budget``,
                     when set, caps admissible kg CO2e).
    """

    kind: str = "throughput"
    budget: Optional[float] = None
    slo_seconds: Optional[float] = None
    grams_co2_per_kwh: Optional[float] = None

    def __post_init__(self):
        if self.kind not in OBJECTIVE_KINDS:
            raise ValueError(
                f"unknown objective {self.kind!r}; expected one of {OBJECTIVE_KINDS}"
            )
        if self.slo_seconds is not None:
            if self.kind != "latency":
                raise ValueError(
                    f"slo_seconds only applies to the latency objective, "
                    f"not {self.kind!r}"
                )
            if self.slo_seconds <= 0:
                raise ValueError("slo_seconds must be positive")
        if self.grams_co2_per_kwh is not None:
            if self.kind != "carbon":
                raise ValueError(
                    f"grams_co2_per_kwh only applies to the carbon "
                    f"objective, not {self.kind!r}"
                )
            if self.grams_co2_per_kwh <= 0:
                raise ValueError("grams_co2_per_kwh must be positive")

    @staticmethod
    def throughput() -> "ObjectiveSpec":
        return ObjectiveSpec("throughput")

    @staticmethod
    def money(budget: Optional[float] = None) -> "ObjectiveSpec":
        return ObjectiveSpec("money", budget)

    @staticmethod
    def pareto(budget: Optional[float] = None) -> "ObjectiveSpec":
        return ObjectiveSpec("pareto", budget)

    @staticmethod
    def latency(slo_seconds: Optional[float] = None) -> "ObjectiveSpec":
        return ObjectiveSpec("latency", slo_seconds=slo_seconds)

    @staticmethod
    def carbon(
        budget_kg: Optional[float] = None,
        grams_co2_per_kwh: Optional[float] = None,
    ) -> "ObjectiveSpec":
        """Lowest-emissions plan; ``grams_co2_per_kwh=None`` uses the
        objective's default grid intensity."""
        return ObjectiveSpec(
            "carbon", budget=budget_kg, grams_co2_per_kwh=grams_co2_per_kwh
        )


@dataclasses.dataclass(frozen=True)
class Limits:
    """Search-side resource knobs (all optional).

    ``workers`` is the parallel-evaluation fan-out: 1 (the default) runs
    the serial path, N > 1 shards every candidate stream round-robin over N
    workers (a long-lived warm ``fork`` process pool where available,
    threads otherwise), and 0 means one worker per CPU core. ``fleet`` is
    the multi-host fan-out: a tuple of worker-service base URLs (hosts
    running ``python -m repro_torch.serve.search_service serve``) the shards are
    shipped to over HTTP instead — when set it takes precedence over
    ``workers``.

    Both are *execution* details, not search semantics: results are
    byte-identical across worker counts and fleets (modulo wall-time
    fields), so :meth:`SearchSpec.canonicalize` drops them both and a
    serial, a multi-core, and a fleet search of the same spec are cache
    hits for each other. With ``max_candidates`` set the search always runs
    serially (a candidate cap is defined on the serial stream order).
    """

    top_k: int = 5
    chunk_size: Optional[int] = None  # None -> the facade's default
    max_candidates: Optional[int] = None  # cap on candidates streamed
    workers: int = 1  # 0 = one per CPU core; execution detail, not identity
    fleet: Optional[tuple[str, ...]] = None  # worker URLs; not identity

    def __post_init__(self):
        if self.workers < 0:
            raise ValueError(f"workers must be >= 0, got {self.workers}")
        if self.fleet is not None:
            if not self.fleet:
                raise ValueError("fleet must name at least one worker URL")
            if not all(isinstance(u, str) and u for u in self.fleet):
                raise ValueError(f"fleet must be URL strings, got {self.fleet!r}")


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SearchSpec:
    """One declarative Astra search. See the module docstring."""

    arch: ModelArch
    pool: PoolSpec
    workload: Workload
    objective: ObjectiveSpec = ObjectiveSpec()
    space: Optional[dict] = None  # parameter-space override (Eq. 9), mode 1/3
    hetero_base: Optional[dict] = None  # base strategy fields, mode 2
    limits: Limits = Limits()

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        pool_d = dataclasses.asdict(self.pool)
        pool_d["kind"] = self.pool.kind
        limits_d = dataclasses.asdict(self.limits)
        if limits_d.get("fleet") is None:
            # sparse: non-fleet specs keep their pre-fleet wire bytes
            limits_d.pop("fleet", None)
        else:
            limits_d["fleet"] = list(limits_d["fleet"])
        workload_d = dataclasses.asdict(self.workload)
        if self.workload.inference is None:
            # sparse: training-only specs keep their pre-serving wire bytes
            workload_d.pop("inference", None)
        else:
            workload_d["inference"] = self.workload.inference.to_dict()
        return {
            "version": 1,
            "arch": dataclasses.asdict(self.arch),
            "pool": pool_d,
            "workload": workload_d,
            "objective": dataclasses.asdict(self.objective),
            "space": self.space,
            "hetero_base": self.hetero_base,
            "limits": limits_d,
        }

    def to_json(self, *, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict) -> "SearchSpec":
        version = d.get("version", 1)
        if version != 1:
            raise ValueError(f"unsupported SearchSpec version {version!r}")
        pool_d = dict(d["pool"])
        kind = pool_d.pop("kind")
        try:
            pool_cls = _POOL_KINDS[kind]
        except KeyError:
            raise ValueError(
                f"unknown pool kind {kind!r}; expected one of {sorted(_POOL_KINDS)}"
            ) from None
        if pool_cls is HeteroCaps:
            pool_d["type_caps"] = tuple(
                (str(dev), int(cap)) for dev, cap in pool_d["type_caps"]
            )
        if pool_cls is DeviceSweep:
            pool_d["devices"] = tuple(pool_d["devices"])
        pool = pool_cls(**pool_d)
        workload_d = dict(d["workload"])
        inference_d = workload_d.pop("inference", None)
        if inference_d is not None:
            workload_d["inference"] = InferenceShape.from_dict(inference_d)
        return cls(
            arch=ModelArch(**d["arch"]),
            pool=pool,
            workload=Workload(**workload_d),
            objective=ObjectiveSpec(**(d.get("objective") or {})),
            space=d.get("space"),
            hetero_base=d.get("hetero_base"),
            limits=_limits_from_dict(d.get("limits")),
        )

    @classmethod
    def from_json(cls, text: str) -> "SearchSpec":
        return cls.from_dict(json.loads(text))

    # -- canonical identity ------------------------------------------------
    def canonicalize(self) -> dict:
        """Canonical content dict: the semantic identity of this search.

        Two specs that compare equal — regardless of how their JSON was
        spelled (key order, explicit nulls, omitted default sections,
        ``2e9`` vs ``2000000000``) — canonicalize to the same dict, because
        the form is derived from the constructed dataclasses (defaults
        already applied) with ``None`` entries dropped and integral floats
        normalized to ints.

        ``limits.workers`` and ``limits.fleet`` are dropped entirely: the
        parallel/fleet fan-out is an execution detail that cannot change
        the result, so a spec searched serially, over 8 local workers, or
        across a 16-host fleet must share one cache key (and one
        wire-identical cached report).
        """
        d = _canonical(self.to_dict())
        d.get("limits", {}).pop("workers", None)
        d.get("limits", {}).pop("fleet", None)
        return d

    def canonical_json(self) -> str:
        return json.dumps(
            self.canonicalize(), sort_keys=True, separators=(",", ":")
        )

    def cache_key(self) -> str:
        """Stable content hash of :meth:`canonicalize` — the identity a
        result cache (see :class:`repro_torch.serve.search_service.SearchService`)
        keys a :class:`~repro_torch.core.api.SearchReport` on."""
        return hashlib.sha256(self.canonical_json().encode()).hexdigest()

    def family_key(self) -> str:
        """Stable content hash of the spec *minus its pool*: two specs that
        differ only in pool shape/size share a family. Elastic re-search
        (``POST /v1/search?elastic=1``) uses this to find the prior report
        of the same search when the device pool shrank or grew."""
        d = self.canonicalize()
        d.pop("pool", None)
        text = json.dumps(d, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(text.encode()).hexdigest()


def _limits_from_dict(d: Optional[dict]) -> Limits:
    """JSON-shaped limits dict -> Limits (the fleet URL list re-tuples so a
    round-tripped spec compares equal to the constructed one)."""
    d = dict(d or {})
    if d.get("fleet") is not None:
        d["fleet"] = tuple(str(u) for u in d["fleet"])
    return Limits(**d)


def _canonical(v):
    """Recursive canonical form: sorted keys, no None entries, integral
    floats as ints (JSON ``2e9`` == ``2000000000``), tuples as lists."""
    if isinstance(v, dict):
        return {
            k: _canonical(x) for k, x in sorted(v.items()) if x is not None
        }
    if isinstance(v, (list, tuple)):
        return [_canonical(x) for x in v]
    if isinstance(v, float) and not isinstance(v, bool) and v.is_integer():
        return int(v)
    return v
