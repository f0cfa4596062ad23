"""Astra's top-level API: one declarative, wire-native search pipeline.

The primary entry point is :meth:`Astra.search`, which takes a
:class:`~repro_torch.core.spec.SearchSpec` — a serializable description of the
model, the GPU pool (one of three shapes), the workload, and the objective
— and runs it through a fixed pipeline::

    SearchSpec --(planner)--> tagged candidate streams
               --(streaming evaluator)--> costed candidates
               --(objective)--> SearchReport

The paper's three modes are three pool shapes of the same spec:

    mode 1 (homogeneous): ``FixedPool(device, n)``        -> best strategy
    mode 2 (heterogeneous): ``HeteroCaps(total, caps)``   -> best hetero plan
    mode 3 (cost): ``DeviceSweep(devices, max_devices)``
                   + ``ObjectiveSpec.pareto(budget)``     -> best affordable
                                                             strategy

Both ends of the pipeline are wire formats. The input side serializes via
``SearchSpec.to_json/from_json`` and has a canonical identity
(:meth:`~repro_torch.core.spec.SearchSpec.cache_key` — a content hash insensitive
to JSON key order and no-op defaults). The output side — :class:`SearchReport`
and everything it nests (:class:`~repro_torch.core.params.ParallelStrategy`,
:class:`~repro_torch.core.simulate.SimResult`,
:class:`~repro_torch.core.pareto.CostedStrategy`,
:class:`~repro_torch.core.search.SearchCounts`) — round-trips exactly through
``to_json/from_json`` with a versioned envelope; ranking-sensitive floats are
encoded with ``float.hex`` so ``SearchReport.from_json(r.to_json()) == r``
bit for bit (see :mod:`repro_torch.core.wire`).

That pair is what makes search a shared fleet resource: a client POSTs a
spec to the :class:`~repro_torch.serve.search_service.SearchService` endpoint,
the service runs (or replays from its spec-keyed cache) the search, and the
report JSON it returns is the exact in-process report::

    spec = SearchSpec(
        arch=llama7b,
        pool=FixedPool("A800", 64),
        workload=Workload(global_batch=512, seq=4096),
    )
    report = Astra(eta_model).search(spec)          # in-process
    # or through the service wire (cached across the fleet):
    service = SearchService(Astra(eta_model))
    report2 = service.search(spec)                  # == report, via JSON
    # or over HTTP: POST spec.to_json() to /v1/search

Every search returns a SearchReport carrying the funnel counts and the
search/simulation wall-times (the paper's Table-1 columns); the split is
measured by wrapping the candidate streams in :func:`_timed`, so generation
+ filtering time lands in ``search_seconds`` and the rest in
``simulate_seconds`` for all modes alike.

All specs evaluate through the batched engine
(:class:`repro_torch.core.batch.BatchedCostSimulator`) by default; pass
``use_batched=False`` to fall back to the scalar reference simulator (the
pipeline is identical — the scalar engine just replaces ``simulate_batch``).
Candidates always stream through chunked evaluation with incremental top-k
/ Pareto tracking, so no mode materializes its candidate list: peak held
candidates are bounded by the chunk size plus the collector's survivors.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional, Sequence

from repro_torch.core import wire
from repro_torch.core.backend import (
    ExecutionBackend,
    FleetBackend,
    LocalPoolBackend,
    SerialBackend,
)
from repro_torch.core.objectives import make_objective
from repro_torch.core.params import ParallelStrategy
from repro_torch.core.pareto import CostedStrategy
from repro_torch.core.planner import pool_mode
from repro_torch.core.rules import DEFAULT_RULES
from repro_torch.core.search import SearchCounts
from repro_torch.core.simulate import SimResult
from repro_torch.core.spec import SearchSpec

_REPORT_KIND = "astra.search_report"


def _eta_version(eta_model) -> Optional[str]:
    """The eta model's content-hash version, if it declares one.

    Duck-typed (``version_string()``) so this module never imports
    :mod:`repro_torch.calibration` — the dependency points the other way. Engines
    without an identity (raw truth simulators, test doubles) stamp nothing.
    """
    fn = getattr(eta_model, "version_string", None)
    if fn is None:
        return None
    try:
        v = fn()
    except Exception:
        return None
    return v if isinstance(v, str) else None


@dataclasses.dataclass
class SearchReport:
    mode: str
    best: Optional[ParallelStrategy]
    best_sim: Optional[SimResult]
    top: list[CostedStrategy]
    counts: SearchCounts
    search_seconds: float
    simulate_seconds: float
    pool: list[CostedStrategy] = dataclasses.field(default_factory=list)
    evaluated: int = 0  # candidates streamed through the evaluator
    # per-(device, num_devices) champions under the objective's key — one
    # entry per pool cell, sorted by cell. Top-k keeps the global winners
    # (often all in one cell); the champions keep every *covered* cell's
    # best, which is what elastic re-search warm-starts from when the pool
    # shrinks (repro_torch.core.elastic)
    cells: list[CostedStrategy] = dataclasses.field(default_factory=list)
    # content-hash version of the eta model that ranked this report (see
    # repro_torch.calibration.registry); None for engines that don't declare one
    eta_model_version: Optional[str] = None

    @property
    def e2e_seconds(self) -> float:
        return self.search_seconds + self.simulate_seconds

    # -- wire format -------------------------------------------------------
    def to_dict(self) -> dict:
        """Versioned wire envelope; exact (``from_dict(to_dict(r)) == r``)."""
        d = {
            "version": wire.WIRE_VERSION,
            "kind": _REPORT_KIND,
            "mode": self.mode,
            "best": self.best.to_dict() if self.best is not None else None,
            "best_sim": self.best_sim.to_dict()
            if self.best_sim is not None else None,
            "top": [c.to_dict() for c in self.top],
            "counts": self.counts.to_dict(),
            "search_seconds": wire.dump_float(self.search_seconds),
            "simulate_seconds": wire.dump_float(self.simulate_seconds),
            "pool": [c.to_dict() for c in self.pool],
            "evaluated": self.evaluated,
        }
        # sparse: pre-calibration wire bytes are unchanged when unstamped
        if self.eta_model_version is not None:
            d["eta_model_version"] = self.eta_model_version
        # sparse: pre-elastic report bytes are unchanged when empty
        if self.cells:
            d["cells"] = [c.to_dict() for c in self.cells]
        return d

    def to_json(self, *, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict) -> "SearchReport":
        wire.check_envelope(d, _REPORT_KIND)
        best = d.get("best")
        best_sim = d.get("best_sim")
        return cls(
            mode=d["mode"],
            best=ParallelStrategy.from_dict(best) if best is not None else None,
            best_sim=SimResult.from_dict(best_sim)
            if best_sim is not None else None,
            top=[CostedStrategy.from_dict(c) for c in d["top"]],
            counts=SearchCounts.from_dict(d["counts"]),
            search_seconds=wire.load_float(d["search_seconds"]),
            simulate_seconds=wire.load_float(d["simulate_seconds"]),
            pool=[CostedStrategy.from_dict(c) for c in d.get("pool", [])],
            evaluated=int(d.get("evaluated", 0)),
            eta_model_version=d.get("eta_model_version"),
            cells=[CostedStrategy.from_dict(c) for c in d.get("cells", [])],
        )

    @classmethod
    def from_json(cls, text: str) -> "SearchReport":
        return cls.from_dict(json.loads(text))

    def normalized_json(self) -> str:
        """Report JSON with the wall-time fields zeroed — the canonical
        comparator for "same search result": two reports of one spec (e.g.
        a serial and a parallel run, or two hosts) must agree on this
        string byte-for-byte even though their timings differ. Every field
        that legitimately varies between runs is normalized here and
        nowhere else."""
        return dataclasses.replace(
            self,
            search_seconds=0.0,
            simulate_seconds=0.0,
            counts=self.counts.normalized(),
        ).to_json()


class Astra:
    """Facade over the spec -> backend -> stream pipeline.

    Execution is delegated to an :class:`~repro_torch.core.backend.ExecutionBackend`
    chosen per spec (see :meth:`_backend_for`): the serial in-process loop,
    the long-lived warm local process pool, or an HTTP fleet coordinator.
    Every backend returns the identical (collector, counts, evaluated)
    triple, so the report is a pure function of the spec — execution is an
    implementation detail the report never reveals (wall-times aside).
    """

    def __init__(
        self,
        eta_model,
        rules: Sequence[str] = DEFAULT_RULES,
        *,
        use_batched: bool = True,
        chunk_size: int = 512,
        backend: Optional[ExecutionBackend] = None,
    ):
        self.eta = eta_model
        self.eta_version = _eta_version(eta_model)
        self.rules = rules
        self.use_batched = use_batched
        self.chunk_size = chunk_size
        # the serial backend owns the shared warm engines (and the
        # try-acquire lease that lets a multi-threaded service overlap);
        # it doubles as the worker half of the fleet protocol (run_shard)
        self._serial = SerialBackend(
            eta_model, rules, use_batched=use_batched, chunk_size=chunk_size
        )
        self.simulator = self._serial.simulator
        self.batched = self._serial.batched
        self._backend = backend  # constructor override: every search uses it
        self._local: Optional[LocalPoolBackend] = None
        self._fleets: dict[tuple, FleetBackend] = {}

    @property
    def _engine_lock(self):
        """The serial backend's warm-engine lease (kept for callers that
        pin the shared engines to force private-engine evaluation)."""
        return self._serial._engine_lock

    # -- backend selection -------------------------------------------------
    def _backend_for(self, spec: SearchSpec) -> ExecutionBackend:
        """Pick the execution backend for one spec.

        Precedence: a ``max_candidates`` cap forces the serial loop (the
        cap is defined on the serial stream order and cannot be
        distributed); a constructor ``backend=`` override wins next;
        then ``Limits.fleet`` (HTTP coordinator, one cached
        :class:`FleetBackend` per distinct worker-URL tuple); then
        ``Limits.workers != 1`` (the shared warm local pool); else serial.
        """
        if spec.limits.max_candidates is not None:
            return self._serial
        if self._backend is not None:
            return self._backend
        if spec.limits.fleet:
            key = spec.limits.fleet
            fleet = self._fleets.get(key)
            if fleet is None:
                fleet = self._fleets[key] = FleetBackend(key)
            return fleet
        if spec.limits.workers != 1:
            if self._local is None:
                self._local = LocalPoolBackend(
                    self.eta, self.rules, use_batched=self.use_batched,
                    chunk_size=self.chunk_size,
                )
            return self._local
        return self._serial

    # -- the unified entry point -------------------------------------------
    def search(self, spec: SearchSpec) -> SearchReport:
        """Run one declarative search spec end to end.

        ``spec.limits`` picks the execution backend — ``workers`` (1 =
        serial, N > 1 or 0 = one per core on the warm local pool, clamped
        to the spec's shard count) or ``fleet`` (remote HTTP workers with
        work-stealing and reassignment) — and every backend produces the
        same report, same funnel counts, wall-time fields aside. A spec
        with ``max_candidates`` always runs serially (the cap is defined
        on the serial stream order).

        ``search_seconds`` is the summed generation CPU time across
        workers (funnel counts merge exactly; wall-time is what shrinks),
        and ``simulate_seconds`` is clamped at zero when the summed
        generation time exceeds the realized wall-time.
        """
        t0 = time.perf_counter()
        objective = make_objective(
            spec.objective, train_tokens=spec.workload.train_tokens,
            inference=spec.workload.inference,
        )
        backend = self._backend_for(spec)
        collector, counts, evaluated = backend.run(spec, objective)
        top, pool = collector.results()
        best = objective.select(top, pool)
        total = time.perf_counter() - t0
        search_seconds = counts.gen_seconds
        return SearchReport(
            mode=pool_mode(spec.pool),
            best=best.strategy if best else None,
            best_sim=best.sim if best else None,
            top=top,
            counts=counts,
            search_seconds=search_seconds,
            simulate_seconds=max(total - search_seconds, 0.0),
            pool=pool,
            evaluated=evaluated,
            eta_model_version=self.eta_version,
            cells=collector.cells.sorted(),
        )

    def search_elastic(
        self,
        spec: SearchSpec,
        prior_spec: SearchSpec,
        prior: SearchReport,
    ) -> Optional[SearchReport]:
        """Warm-start ``spec`` from a prior report of the same search
        family (:meth:`~repro_torch.core.spec.SearchSpec.family_key`) on a
        different pool: re-simulate the prior winners that still fit, and
        stream only the newly-feasible region (see
        :mod:`repro_torch.core.elastic`). Returns ``None`` when the warm start
        doesn't apply — the caller runs :meth:`search` cold instead."""
        from repro_torch.core.elastic import elastic_search

        return elastic_search(self, spec, prior_spec, prior)

    # -- fleet worker half -------------------------------------------------
    def run_shard(
        self,
        spec: SearchSpec,
        shard: tuple[int, int],
        *,
        chunk_size: Optional[int] = None,
    ) -> dict:
        """Evaluate one ``(i, n)`` shard of ``spec`` and return the
        mergeable wire payload — what a fleet worker serves from
        ``POST /v1/shard`` (see :class:`~repro_torch.core.backend.FleetBackend`
        for the coordinator half). Always runs on the serial backend's
        warm engines, whatever ``spec.limits`` says."""
        return self._serial.run_shard(spec, shard, chunk_size=chunk_size)

    def close(self) -> None:
        """Tear down held execution resources (the warm local pool)."""
        if self._local is not None:
            self._local.close()
            self._local = None
        if self._backend is not None:
            self._backend.close()
