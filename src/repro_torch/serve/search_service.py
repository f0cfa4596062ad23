"""Spec-keyed search service: strategy search as a shared fleet resource.

The paper's headline costs (1.27 s mode-1 search, ~1 min simulation sweeps)
only pay off at fleet scale when results are cached and reusable. This
module wraps :class:`~repro_torch.core.api.Astra` behind a :class:`SearchService`
that

* caches serialized :class:`~repro_torch.core.api.SearchReport` JSON in a
  pluggable :class:`~repro_torch.serve.store.ReportStore` keyed on
  :meth:`~repro_torch.core.spec.SearchSpec.cache_key` (the canonical content
  hash — re-ordered or default-padded spec JSON hits the same entry).
  The default is the in-process LRU+TTL :class:`~repro_torch.serve.store.MemoryStore`;
  ``sqlite:PATH`` / ``tiered:PATH`` stores make reports survive restarts
  and be shared across replicas,
* single-flights identical concurrent specs (one search runs; the other
  callers wait on it and share the result),
* optionally authenticates callers with static bearer tokens and enforces
  per-token request / cold-search quotas (401 / 429; see
  :class:`AuthQuota`), and
* serves the whole thing over stdlib ``http.server``:

      POST /v1/search            body = SearchSpec JSON -> report envelope
      POST /v1/search?async=1    -> 202 {key, status}; poll the result
      POST /v1/search?refresh=stale  -> a warm hit ranked by an outdated
                                        eta model re-searches under the
                                        current one instead of being served
      POST /v1/search?elastic=1  -> a cold search whose *family* (the spec
                                    minus its pool) was searched before
                                    warm-starts from that prior report:
                                    prior winners still inside the new pool
                                    are re-simulated and only the
                                    newly-feasible region streams through
                                    the funnel (see repro_torch.core.elastic); an
                                    unchanged pool is an ordinary warm hit
                                    (byte-identical report, zero searches)
      POST /v1/shard             body = {spec, shard: [i, n]} -> shard payload
      POST /v1/traces            body = StepTrace JSON -> calibration ack
      POST /v1/plan              body = FleetSpec JSON -> fleet plan envelope
      GET  /v1/results/<key>     -> 200 report | 202 pending | 404 unknown
      GET  /v1/stats             -> cache/store counters + per-token usage
      GET  /metrics              -> the same counters, Prometheus text format

``POST /v1/plan`` is the fleet capacity planner (see :mod:`repro_torch.fleet`):
the body names heterogeneous pools and a workload queue, the service
searches the workload x pool grid through its own spec-keyed cache (warm
cells are free — re-planning after adding one job only searches the new
job's cells) and returns the solved ``astra.fleet_plan`` envelope, itself
cached under the fleet's canonical cache key.

``POST /v1/traces`` is the calibration feedback inlet (see
:mod:`repro_torch.calibration.loop`): a service built with a
:class:`~repro_torch.calibration.loop.CalibrationLoop` scores every ingested
measured :class:`~repro_torch.calibration.traces.StepTrace` against its live eta
model, and when the rolling accuracy decays below the paper's 95% bar the
loop refits, registers the new model version, and the service swaps its
engine — subsequent searches are ranked (and stamped) by the refit model.
Cached reports stamped by an older version are *stale*: they are still
served (and counted in ``stale_hits``) unless the caller asks for
``?refresh=stale``, which forces a re-search under the current model.

``POST /v1/shard`` is the *worker role* of a fleet search: the body names
one ``(i, n)`` shard of a spec, the response is the mergeable collector
payload (``astra.shard_result`` wire dict) a
:class:`~repro_torch.core.backend.FleetBackend` coordinator merges. It shares
the auth gate and the bounded search executor with ``/v1/search``, and a
service started with ``serve --fleet URL,URL`` plays the *coordinator
role*: every cold search fans out to those workers and the merged report
lands in this service's store — one binary, both parts.

Every result a caller sees — cached or fresh, in-process or over HTTP —
passes through ``SearchReport.to_json``/``from_json``, so the serialized
path is the only path and is exact by construction (see
:mod:`repro_torch.core.wire`).

A small CLI rides along::

    python -m repro_torch.serve.search_service serve --port 8123 \\
        [--store sqlite:reports.db] [--auth-tokens tokens.txt] \\
        [--fleet http://worker1:8123,http://worker2:8123]
    python -m repro_torch.serve.search_service search --url http://host:8123 \\
        --spec spec.json [--token TOKEN] [--async-poll]
    python -m repro_torch.serve.search_service traces --url http://host:8123 \\
        --traces steps.jsonl [--token TOKEN]
    python -m repro_torch.serve.search_service plan --url http://host:8123 \\
        --spec fleet.json [--token TOKEN]
    python -m repro_torch.serve.search_service stats --url http://host:8123
"""
from __future__ import annotations

import argparse
import dataclasses
import http.server
import json
import threading
import time
import urllib.parse
from collections import OrderedDict
from typing import Callable, Optional

from repro_torch.core.api import Astra, SearchReport
from repro_torch.core.backend import DEFAULT_SHARD_TIMEOUT, FleetBackend
from repro_torch.core.http_client import (
    DEFAULT_RETRIES,
    DEFAULT_SEARCH_TIMEOUT,
    DEFAULT_TIMEOUT,
    http_json as _http_json,
)
from repro_torch.core.spec import SearchSpec
from repro_torch.serve.store import MemoryStore, ReportStore, parse_store_url

DEFAULT_MAX_BODY_BYTES = 1 << 20  # 1 MiB: specs are small; reports never POST


@dataclasses.dataclass
class ServiceStats:
    """Service-level counters behind ``GET /v1/stats`` (store counters —
    evictions/expirations/corruptions — live on the store and are merged
    in by :meth:`SearchService.stats_dict`)."""

    hits: int = 0
    misses: int = 0
    coalesced: int = 0  # callers that joined an in-flight identical search
    store_put_errors: int = 0  # store failed mid-write; result still served
    store_get_errors: int = 0  # store failed a read; treated as a miss
    searching: int = 0  # cold searches executing right now
    peak_searching: int = 0  # high-water mark of concurrent cold searches
    shards: int = 0  # fleet worker role: /v1/shard requests served
    shard_errors: int = 0  # /v1/shard requests that failed
    traces: int = 0  # calibration traces ingested via /v1/traces
    trace_errors: int = 0  # trace ingestions that failed
    refits: int = 0  # engine swaps after a calibration refit
    stale_hits: int = 0  # cache hits stamped by an outdated eta model
    stale_refreshes: int = 0  # stale hits re-searched via refresh=stale
    plans: int = 0  # fleet plans computed (cold /v1/plan requests)
    grid_cells: int = 0  # workload x pool cells planned over
    grid_warm_hits: int = 0  # grid cells served without running a search
    elastic_searches: int = 0  # requests that asked for ?elastic=1
    elastic_warm_starts: int = 0  # cold elastic searches warm-started from
    # a prior same-family report (the rest were warm hits or ran cold)
    # cumulative cold-search funnel wall-time split by rung, accumulated
    # from each cold report's SearchCounts (seconds; monotonic)
    funnel_enumerate_seconds: float = 0.0
    funnel_rules_seconds: float = 0.0
    funnel_memory_seconds: float = 0.0
    funnel_simulate_seconds: float = 0.0

    @property
    def requests(self) -> int:
        return self.hits + self.misses + self.coalesced

    @property
    def hit_rate(self) -> float:
        return self.hits / self.requests if self.requests else 0.0

    def to_dict(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "coalesced": self.coalesced,
            "store_put_errors": self.store_put_errors,
            "store_get_errors": self.store_get_errors,
            "requests": self.requests,
            "hit_rate": round(self.hit_rate, 4),
            "searching": self.searching,
            "peak_searching": self.peak_searching,
            "shards": self.shards,
            "shard_errors": self.shard_errors,
            "traces": self.traces,
            "trace_errors": self.trace_errors,
            "refits": self.refits,
            "stale_hits": self.stale_hits,
            "stale_refreshes": self.stale_refreshes,
            "plans": self.plans,
            "grid_cells": self.grid_cells,
            "grid_warm_hits": self.grid_warm_hits,
            "elastic_searches": self.elastic_searches,
            "elastic_warm_starts": self.elastic_warm_starts,
            "funnel_enumerate_seconds": round(self.funnel_enumerate_seconds, 6),
            "funnel_rules_seconds": round(self.funnel_rules_seconds, 6),
            "funnel_memory_seconds": round(self.funnel_memory_seconds, 6),
            "funnel_simulate_seconds": round(self.funnel_simulate_seconds, 6),
        }


class _Flight:
    """One in-flight search other callers of the same key can wait on."""

    def __init__(self):
        self.done = threading.Event()
        self.report_json: Optional[str] = None
        self.error: Optional[BaseException] = None


class QuotaExceeded(Exception):
    """A per-token quota rejected this request (HTTP 429)."""


class SearchService:
    """Single-flight search dedup over a pluggable report store.

    The store holds report *JSON text*; :meth:`search` deserializes it, so
    a caller can never observe an object that didn't round-trip the wire.
    With ``store=None`` the service builds a
    :class:`~repro_torch.serve.store.MemoryStore` from ``max_entries`` /
    ``ttl_seconds`` / ``clock`` (the original in-process behavior); pass a
    :class:`~repro_torch.serve.store.SqliteStore` or
    :class:`~repro_torch.serve.store.TieredStore` for durability and
    cross-replica sharing. A store that raises is contained: failed writes
    still serve the fresh result (counted in ``store_put_errors``), failed
    reads count as misses.

    Cold searches of *distinct* specs run concurrently, bounded by
    ``search_concurrency`` (a semaphore; identical specs are still
    single-flighted above it). The engine stays correct under that
    concurrency: sharded searches (``workers != 1``) share no mutable
    state, and concurrent serial searches fall back to private engines
    when the shared warm ones are already in use (see
    :meth:`~repro_torch.core.api.Astra.search`). ``/v1/stats`` reports
    ``searching`` (cold searches executing now) and ``peak_searching``
    (the concurrency high-water mark). ``workers`` (when not None)
    overrides ``Limits.workers`` on every cold search — an execution
    detail, so the cached report and its key are unchanged by it.

    Sizing: total parallelism is ``search_concurrency x workers`` worker
    processes at peak — keep that product around the host's core count
    (e.g. prefer ``search_concurrency=2, workers=cores//2`` over
    ``4 x cores``); oversubscribing slows every search below serial.
    """

    def __init__(
        self,
        astra: Astra,
        *,
        max_entries: int = 128,
        ttl_seconds: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        store: Optional[ReportStore] = None,
        search_concurrency: int = 4,
        workers: Optional[int] = None,
        calibration=None,
        engine_factory: Optional[Callable] = None,
    ):
        self.astra = astra
        # calibration feedback: a repro_torch.calibration.loop.CalibrationLoop
        # scoring ingested traces; engine_factory(model) rebuilds the search
        # engine after a refit (default: same knobs as the current engine)
        self.calibration = calibration
        self._engine_factory = engine_factory
        if store is not None:
            # time-based behavior lives entirely in the store; a clock (or
            # TTL/bound) passed alongside one would be silently dead state
            if (clock is not time.monotonic or ttl_seconds is not None
                    or max_entries != 128):
                raise ValueError(
                    "store= carries its own max_entries/ttl_seconds/clock;"
                    " configure them on the store, not the service"
                )
            self.store = store
        else:
            self.store = MemoryStore(
                max_entries=max_entries, ttl_seconds=ttl_seconds, clock=clock,
            )
        if search_concurrency < 1:
            raise ValueError(
                f"search_concurrency must be >= 1, got {search_concurrency}"
            )
        self.search_concurrency = search_concurrency
        self.workers = workers
        self.stats = ServiceStats()
        self._inflight: dict[str, _Flight] = {}
        self._errors: "OrderedDict[str, str]" = OrderedDict()
        # completed reports whose store write failed: kept reachable here
        # (bounded) so async pollers aren't stranded by a flaky store
        self._orphans: "OrderedDict[str, str]" = OrderedDict()
        # elastic re-search memory: family_key -> (cache_key, spec) of the
        # most recent successful search in that family. Bounded; in-process
        # only (a restart just means the next ?elastic=1 runs cold)
        self._families: "OrderedDict[str, tuple[str, SearchSpec]]" = (
            OrderedDict()
        )
        self._fills = 0  # bumped whenever a flight completes (see below)
        self._lock = threading.Lock()  # stats + flight bookkeeping
        # bounded executor for cold searches: distinct specs overlap up to
        # this limit (identical specs never reach it — single-flight wins)
        self._search_sem = threading.BoundedSemaphore(search_concurrency)

    # -- store access (error-contained; never call with _lock held) --------
    def _store_get(self, key: str) -> Optional[str]:
        try:
            return self.store.get(key)
        except Exception:
            with self._lock:  # counters are read-modify-write: lock them
                self.stats.store_get_errors += 1
            return None

    # -- core entry points -------------------------------------------------
    def search_json(
        self,
        spec_json: str,
        *,
        on_cold: Optional[Callable[[], None]] = None,
        refresh_stale: bool = False,
        elastic: bool = False,
    ) -> tuple[str, str, bool]:
        """Run (or replay) the search described by ``spec_json``.

        Returns ``(cache_key, report_json, cached)`` where ``cached`` is
        True when the report came from the store or an in-flight search
        rather than a fresh run owned by this caller. ``on_cold`` (the
        quota hook) is invoked only when this caller would start a fresh
        search; raising from it aborts before any work runs.
        ``refresh_stale`` turns a warm hit whose ``eta_model_version`` no
        longer matches the calibration loop's live model into a re-search
        (charged as cold); without a calibration loop it is a no-op.

        ``elastic`` is the pool-change fast path (``?elastic=1``): a cold
        search whose family (the spec minus its pool —
        :meth:`~repro_torch.core.spec.SearchSpec.family_key`) has a prior report
        warm-starts from it instead of searching from scratch — prior
        winners that still fit the new pool are re-simulated and only the
        newly-feasible region streams through the funnel. An unchanged
        pool short-circuits earlier as an ordinary warm hit (byte-identical
        report, zero engine evaluations), and a family never seen (or a
        warm start the engine declines) runs cold; either way the caller
        always gets a correct report. Still charged as one cold search.
        """
        spec = SearchSpec.from_json(spec_json)
        key = spec.cache_key()
        if elastic:
            with self._lock:
                self.stats.elastic_searches += 1
        hit, flight, leader = self._join_or_lead(
            key, on_cold=on_cold, refresh_stale=refresh_stale
        )
        if hit is not None:
            self._remember_family(spec, key)
            return key, hit, True
        if leader:
            prior = self._family_prior(spec, key) if elastic else None
            if prior is not None:
                produce = lambda: self._elastic_text(spec, *prior)  # noqa: E731
            else:
                produce = lambda: self._search_text(spec)  # noqa: E731
            self._run_flight(key, flight, produce)
        else:
            flight.done.wait()
        if flight.error is not None:
            raise flight.error
        self._remember_family(spec, key)
        return key, flight.report_json, not leader

    # -- elastic re-search -------------------------------------------------
    def _remember_family(self, spec: SearchSpec, key: str) -> None:
        """Record ``spec`` as its family's latest successful search so a
        future ``elastic=True`` miss of the same family can warm-start."""
        fam = spec.family_key()
        with self._lock:
            self._families[fam] = (key, spec)
            self._families.move_to_end(fam)
            while len(self._families) > 256:
                self._families.popitem(last=False)

    def _family_prior(
        self, spec: SearchSpec, key: str
    ) -> Optional[tuple[SearchSpec, SearchReport]]:
        """The prior (spec, report) of ``spec``'s family, if one is still
        retrievable and actually differs from ``spec`` (same key would be
        a store hit upstream, never a warm start)."""
        with self._lock:
            entry = self._families.get(spec.family_key())
        if entry is None or entry[0] == key:
            return None
        prior_key, prior_spec = entry
        text = self._store_get(prior_key)
        if text is None:
            return None
        try:
            return prior_spec, SearchReport.from_json(text)
        except Exception:
            return None  # an undecodable prior is just a cold search

    def _elastic_text(
        self, spec: SearchSpec, prior_spec: SearchSpec, prior: SearchReport
    ) -> str:
        """One elastic fill: try the engine's warm start, fall back cold.

        The warm start runs under the bounded executor like any cold
        search; engines without ``search_elastic`` (or ones that decline —
        no surviving winner, non-cell pools) degrade to :meth:`_search_text`.
        """
        warm = getattr(self.astra, "search_elastic", None)
        if warm is not None:
            with self._search_sem:
                with self._lock:
                    self.stats.searching += 1
                    self.stats.peak_searching = max(
                        self.stats.peak_searching, self.stats.searching
                    )
                try:
                    report = warm(spec, prior_spec, prior)
                finally:
                    with self._lock:
                        self.stats.searching -= 1
            if report is not None:
                with self._lock:
                    self.stats.elastic_warm_starts += 1
                return report.to_json()
        return self._search_text(spec)

    def search(self, spec: SearchSpec) -> SearchReport:
        """Spec in, report out — always through the wire format."""
        _, text, _ = self.search_json(spec.to_json())
        return SearchReport.from_json(text)

    # -- fleet planning ----------------------------------------------------
    def plan_json(
        self,
        fleet_json: str,
        *,
        on_cold: Optional[Callable[[], None]] = None,
        refresh_stale: bool = False,
        elastic: bool = False,
    ) -> tuple[str, str, bool]:
        """Run (or replay) the fleet plan described by ``fleet_json``
        (``POST /v1/plan``; see :mod:`repro_torch.fleet`).

        Returns ``(fleet_cache_key, plan_json, cached)``. Plans reuse the
        whole search machinery: cached in the same store under
        :meth:`~repro_torch.fleet.spec.FleetSpec.cache_key`, single-flighted per
        key, and ``on_cold`` charged once per cold *plan* — the grid cells
        a cold plan fans out to are never cold-charged individually (a
        warm cell is a store read; a cold one is work the plan already
        paid for). Cell searches count into ``hits``/``misses`` as usual,
        plus ``grid_cells``/``grid_warm_hits``; the plan itself counts
        into ``plans``. Like reports, a cached plan stamped by an outdated
        eta model is stale: served (and counted) unless ``refresh_stale``
        forces a re-plan — warm cells keep it cheap.

        ``elastic`` is the fleet *re-plan* hook (``POST /v1/plan?elastic=1``):
        after a pool shrinks or grows, each changed grid cell warm-starts
        from its family's prior cell report instead of searching cold
        (unchanged cells are warm hits as always), so re-planning a resized
        fleet costs a fraction of the first plan.
        """
        from repro_torch.fleet.spec import FleetSpec

        fspec = FleetSpec.from_json(fleet_json)
        key = fspec.cache_key()
        hit, flight, leader = self._join_or_lead(
            key, on_cold=on_cold, refresh_stale=refresh_stale
        )
        if hit is not None:
            return key, hit, True
        if leader:
            # NOT bounded by the search semaphore: the plan only
            # orchestrates; its cells take the semaphore themselves (a plan
            # holding a slot while its cells wait for one would deadlock at
            # search_concurrency=1)
            self._run_flight(
                key, flight, lambda: self._plan_text(fspec, elastic=elastic)
            )
        else:
            flight.done.wait()
        if flight.error is not None:
            raise flight.error
        return key, flight.report_json, not leader

    def plan(self, fspec) -> "FleetPlan":  # noqa: F821 (lazy import below)
        """FleetSpec in, FleetPlan out — always through the wire format."""
        from repro_torch.fleet.assign import FleetPlan

        _, text, _ = self.plan_json(fspec.to_json())
        return FleetPlan.from_json(text)

    def _plan_text(self, fspec, *, elastic: bool = False) -> str:
        """Produce one fleet plan: search the grid through this service's
        own cache, then solve the assignment. ``elastic`` warm-starts the
        cold cells from their families' prior reports (the re-plan path)."""
        from repro_torch.fleet.assign import solve
        from repro_torch.fleet.grid import search_grid

        cells, warm, counts = search_grid(self, fspec, elastic=elastic)
        with self._lock:
            self.stats.grid_cells += len(cells)
            self.stats.grid_warm_hits += warm
        plan = solve(
            fspec, cells, counts,
            eta_model_version=getattr(self.astra, "eta_version", None),
        )
        with self._lock:
            self.stats.plans += 1
        return plan.to_json()

    def submit_json(
        self,
        spec_json: str,
        *,
        on_cold: Optional[Callable[[], None]] = None,
        refresh_stale: bool = False,
        elastic: bool = False,
    ) -> tuple[str, str, Optional[str]]:
        """Async variant: start (or join) the search, return immediately.

        Returns ``(cache_key, status, report_json)``: status ``ready`` with
        the cached report (fetched atomically with the lookup, so a TTL
        expiry cannot strand the caller), or ``pending`` with None (running
        in a background thread; poll :meth:`result_json`). ``elastic`` has
        :meth:`search_json` semantics — the background fill warm-starts
        from the family's prior report when one exists.
        """
        spec = SearchSpec.from_json(spec_json)
        key = spec.cache_key()
        if elastic:
            with self._lock:
                self.stats.elastic_searches += 1
        hit, flight, leader = self._join_or_lead(
            key, on_cold=on_cold, refresh_stale=refresh_stale
        )
        if hit is not None:
            self._remember_family(spec, key)
            return key, "ready", hit
        if leader:
            prior = self._family_prior(spec, key) if elastic else None
            if prior is not None:
                produce = lambda: self._elastic_text(spec, *prior)  # noqa: E731
            else:
                produce = lambda: self._search_text(spec)  # noqa: E731

            def fill():
                self._run_flight(key, flight, produce)
                if flight.error is None:
                    self._remember_family(spec, key)

            threading.Thread(target=fill, daemon=True).start()
        return key, "pending", None

    def shard_json(self, body_json: str) -> dict:
        """Worker role: evaluate one shard of a spec (``POST /v1/shard``).

        ``body_json`` is ``{"spec": <spec dict>, "shard": [i, n],
        "chunk_size"?: int}``; the return value is the mergeable
        ``astra.shard_result`` wire payload from
        :meth:`~repro_torch.core.api.Astra.run_shard`. Runs under the same
        bounded executor as cold searches, so a worker serving shards and
        searches at once never exceeds ``search_concurrency``. Raises
        ``NotImplementedError`` when the engine has no ``run_shard`` (the
        HTTP layer maps it to 501), and ``ValueError``/``KeyError``/
        ``TypeError`` on malformed bodies (mapped to 400); anything else
        counts into ``shard_errors``.
        """
        run_shard = getattr(self.astra, "run_shard", None)
        if run_shard is None:
            raise NotImplementedError(
                "this service's engine does not support shard evaluation"
            )
        body = json.loads(body_json)
        if not isinstance(body, dict):
            raise ValueError("shard request body must be a JSON object")
        spec = SearchSpec.from_dict(body["spec"])
        i, n = (int(x) for x in body["shard"])
        chunk_size = body.get("chunk_size")
        if chunk_size is not None:
            chunk_size = int(chunk_size)
        try:
            with self._search_sem:
                with self._lock:
                    self.stats.searching += 1
                    self.stats.peak_searching = max(
                        self.stats.peak_searching, self.stats.searching
                    )
                try:
                    payload = run_shard(spec, (i, n), chunk_size=chunk_size)
                finally:
                    with self._lock:
                        self.stats.searching -= 1
        except Exception:
            with self._lock:
                self.stats.shard_errors += 1
            raise
        with self._lock:
            self.stats.shards += 1
        return payload

    def ingest_trace_json(self, body_json: str) -> dict:
        """Calibration inlet: one measured ``StepTrace`` in, one ack out
        (``POST /v1/traces``).

        The trace is scored by the :class:`~repro_torch.calibration.loop.
        CalibrationLoop` against the live eta model; if that trips a refit,
        this service's engine is rebuilt around the refit model (via the
        ``engine_factory`` passed at construction, defaulting to an engine
        with the current one's knobs), so every subsequent cold search is
        ranked and stamped by the new version. Raises
        ``NotImplementedError`` when the service has no calibration loop
        (HTTP 501) and ``ValueError``/``KeyError``/``TypeError`` on
        malformed payloads (400); anything else counts ``trace_errors``.
        """
        if self.calibration is None:
            raise NotImplementedError(
                "this service has no calibration loop (start with a"
                " CalibrationLoop / --calibration to ingest traces)"
            )
        from repro_torch.calibration.traces import StepTrace

        try:
            body = json.loads(body_json)
            if not isinstance(body, dict):
                raise ValueError("trace body must be a JSON object")
            trace = StepTrace.from_dict(body)
            ack = self.calibration.ingest(trace)
        except Exception:
            # malformed payloads and scoring failures alike: a rejected
            # submission is a rejected submission to the counter
            with self._lock:
                self.stats.trace_errors += 1
            raise
        with self._lock:
            self.stats.traces += 1
        if ack.get("refit"):
            self._swap_engine()
        return ack

    def _swap_engine(self) -> None:
        """Rebuild the search engine around the calibration loop's current
        model. In-flight searches keep the engine they started with; the
        swap only steers searches that begin after it."""
        factory = self._engine_factory
        if factory is None:
            old = self.astra
            factory = lambda model: Astra(  # noqa: E731
                model, old.rules,
                use_batched=old.use_batched, chunk_size=old.chunk_size,
            )
        new_engine = factory(self.calibration.model)
        with self._lock:
            self.astra = new_engine
            self.stats.refits += 1

    def result_json(self, key: str) -> tuple[str, Optional[str]]:
        """Poll a key: ``(status, report_json|error|None)`` with status one
        of ``ready`` / ``pending`` / ``failed`` / ``unknown``."""
        with self._lock:
            if key in self._inflight:
                return "pending", None
        text = self._store_get(key)
        if text is not None:
            return "ready", text
        with self._lock:
            if key in self._inflight:  # filled between the two checks
                return "pending", None
            if key in self._orphans:  # completed, but the store write failed
                return "ready", self._orphans[key]
            if key in self._errors:
                return "failed", self._errors[key]
        return "unknown", None

    # -- calibration staleness ---------------------------------------------
    def _is_stale(self, report_json: str) -> bool:
        """A cached report is stale when the version that ranked it differs
        from the calibration loop's live model (an unstamped report under a
        calibrating service is stale too — it can't be attributed at all).
        Without a calibration loop nothing is ever stale."""
        if self.calibration is None:
            return False
        try:
            stamped = json.loads(report_json).get("eta_model_version")
        except Exception:
            return False  # undecodable text is the store's problem, not ours
        return stamped != self.calibration.version

    # -- single-flight machinery -------------------------------------------
    def _join_or_lead(
        self,
        key: str,
        *,
        on_cold: Optional[Callable[[], None]] = None,
        refresh_stale: bool = False,
    ) -> tuple[Optional[str], Optional[_Flight], bool]:
        """One lookup: ``(cached_json, flight, leader)`` — a hit returns
        the text; otherwise join the in-flight search or lead a fresh one
        (after the ``on_cold`` quota hook admits it).

        Store reads always happen *outside* the service lock (a slow
        durable read must not stall unrelated keys). The race against a
        flight that completes between our read and the lock is closed by
        the ``_fills`` generation counter: completion bumps it atomically
        with deregistration, so a stale read forces one retry instead of a
        duplicate search.

        A hit stamped by an outdated eta model counts into ``stale_hits``
        and is served anyway — unless ``refresh_stale`` asks for a
        re-search, which falls through to the miss path (joining an
        in-flight refresh of the same key like any other search, and
        charged as cold: a forced re-search is exactly the work the cold
        quota meters)."""
        while True:
            with self._lock:
                gen = self._fills
            text = self._store_get(key)  # no lock held: may be slow I/O
            # staleness is judged outside the lock too (json decode of a
            # potentially large report); the worst a race with a concurrent
            # refit can do is mis-count one hit as fresh/stale
            stale = text is not None and self._is_stale(text)
            with self._lock:
                if text is not None:
                    if stale:
                        self.stats.stale_hits += 1
                    if not (stale and refresh_stale):
                        self.stats.hits += 1
                        return text, None, False
                    self.stats.stale_refreshes += 1
                    # fall through: lead (or join) a re-search of this key
                flight = self._inflight.get(key)
                if flight is not None:
                    self.stats.coalesced += 1
                    return None, flight, False
                if self._fills != gen:
                    continue  # a flight completed since our read: re-read
                if key in self._orphans:
                    # completed earlier but the store write failed; serve
                    # it and retry the write now the store may have healed
                    text = self._orphans[key]
                    self.stats.hits += 1
                else:
                    if on_cold is not None:
                        on_cold()  # may raise QuotaExceeded: no flight/miss
                    flight = _Flight()
                    self._inflight[key] = flight
                    self.stats.misses += 1
                    self._errors.pop(key, None)
                    return None, flight, True
            # orphan hit: heal outside the lock
            try:
                self.store.put(key, text)
                with self._lock:
                    self._orphans.pop(key, None)
            except Exception:
                with self._lock:
                    self.stats.store_put_errors += 1
            return text, None, False

    def _search_text(self, spec: SearchSpec) -> str:
        """One cold search under the bounded executor -> report JSON."""
        if self.workers is not None and spec.limits.workers != self.workers:
            # execution-detail override: never changes the cache key or
            # the report (workers is dropped from spec identity)
            spec = dataclasses.replace(
                spec,
                limits=dataclasses.replace(spec.limits, workers=self.workers),
            )
        with self._search_sem:
            with self._lock:
                self.stats.searching += 1
                self.stats.peak_searching = max(
                    self.stats.peak_searching, self.stats.searching
                )
            try:
                report = self.astra.search(spec)
            finally:
                with self._lock:
                    self.stats.searching -= 1
        with self._lock:
            c = report.counts
            self.stats.funnel_enumerate_seconds += c.enumerate_seconds
            self.stats.funnel_rules_seconds += c.rules_seconds
            self.stats.funnel_memory_seconds += c.memory_seconds
            self.stats.funnel_simulate_seconds += c.sim_seconds
        return report.to_json()

    def _run_flight(
        self, key: str, flight: _Flight, produce: Callable[[], str]
    ) -> None:
        """Lead one single-flighted fill: run ``produce`` (a cold search or
        a fleet plan), store the text, and wake every waiter. A plan's
        ``produce`` must not hold the search semaphore itself — its grid
        cells re-enter :meth:`search_json`, which does."""
        try:
            text = produce()
            try:
                self.store.put(key, text)
                with self._lock:
                    self._orphans.pop(key, None)
            except Exception:
                # store failed mid-write: the completed report must stay
                # reachable (sync callers get it from the flight; async
                # pollers from the orphan map)
                with self._lock:
                    self.stats.store_put_errors += 1
                    self._orphans[key] = text
                    while len(self._orphans) > 32:
                        self._orphans.popitem(last=False)
            flight.report_json = text
        except BaseException as e:  # propagate to every waiter
            flight.error = e
            with self._lock:
                self._errors[key] = f"{type(e).__name__}: {e}"
                while len(self._errors) > 128:  # keep bounded
                    self._errors.pop(next(iter(self._errors)))
        finally:
            with self._lock:
                self._inflight.pop(key, None)
                self._fills += 1  # atomic with deregistration: lets
                # _join_or_lead detect a fill between its read and lock
            flight.done.set()

    def stats_dict(self) -> dict:
        with self._lock:
            d = self.stats.to_dict()
            d["inflight"] = len(self._inflight)
        try:  # a live store read: contained like every other store fault
            d.update(self.store.counters())
            d["entries"] = len(self.store)
        except Exception as e:
            with self._lock:
                self.stats.store_get_errors += 1
            d["entries"] = None
            d["store_error"] = f"{type(e).__name__}: {e}"
        d["store"] = self.store.kind
        d["max_entries"] = getattr(self.store, "max_entries", None)
        d["ttl_seconds"] = getattr(self.store, "ttl_seconds", None)
        d["search_concurrency"] = self.search_concurrency
        d["search_workers"] = self.workers
        if self.calibration is not None:
            d["calibration"] = self.calibration.stats_dict()
        return d

    def close(self) -> None:
        self.store.close()


# ---------------------------------------------------------------------------
# Prometheus exposition (GET /metrics)
# ---------------------------------------------------------------------------

# monotonic stats_dict keys -> *_total counters; everything else numeric in
# the metric allowlist below is a point-in-time gauge
_METRIC_COUNTERS = (
    "hits", "misses", "coalesced", "requests",
    "store_put_errors", "store_get_errors",
    "shards", "shard_errors", "traces", "trace_errors",
    "refits", "stale_hits", "stale_refreshes",
    "plans", "grid_cells", "grid_warm_hits",
    "elastic_searches", "elastic_warm_starts",
    "evictions", "expirations", "corruptions",
)
_METRIC_GAUGES = (
    "searching", "peak_searching", "inflight", "entries", "hit_rate",
    "search_concurrency",
    "funnel_enumerate_seconds", "funnel_rules_seconds",
    "funnel_memory_seconds", "funnel_simulate_seconds",
)


def metrics_text(
    service: "SearchService", auth: Optional["AuthQuota"] = None
) -> str:
    """``/v1/stats`` counters in Prometheus text exposition format.

    Cheap by design (tinygrad's global op-counters in spirit): one
    ``stats_dict()`` snapshot formatted as ``astra_<name>_total`` counters
    and ``astra_<name>`` gauges, plus per-identity auth counters labeled
    ``{identity="..."}``. Non-numeric entries (store kind, calibration
    sub-dict) stay on ``/v1/stats``.
    """
    d = service.stats_dict()
    lines: list[str] = []

    def emit(name: str, kind: str, value, labels: str = "") -> None:
        if not any(ln.startswith(f"# TYPE {name} ") for ln in lines):
            lines.append(f"# TYPE {name} {kind}")
        v = float(value)
        lines.append(f"{name}{labels} {int(v) if v.is_integer() else v}")

    for k in _METRIC_COUNTERS:
        v = d.get(k)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            emit(f"astra_{k}_total", "counter", v)
    for k in _METRIC_GAUGES:
        v = d.get(k)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            emit(f"astra_{k}", "gauge", v)
    if auth is not None:
        a = auth.stats_dict()
        emit("astra_unauthorized_total", "counter", a["unauthorized"])
        for ident in sorted(a["tokens"]):
            t = a["tokens"][ident]
            labels = '{identity="%s"}' % ident.replace('"', '\\"')
            emit("astra_token_requests_total", "counter",
                 t["requests"], labels)
            emit("astra_token_cold_searches_total", "counter",
                 t["cold_searches"], labels)
            emit("astra_token_throttled_total", "counter",
                 t["throttled"], labels)
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# auth / quota
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TokenInfo:
    """One static bearer token and its per-window quotas (None = unlimited)."""

    token: str
    identity: str
    requests_per_window: Optional[int] = None
    cold_per_window: Optional[int] = None


class AuthQuota:
    """Static bearer-token auth + per-token token-bucket (sliding) quotas.

    Token file format (see ``examples/README.md``): one token per line,
    whitespace-separated fields ``TOKEN IDENTITY [REQS [COLD]]`` where the
    optional quotas are integers or ``-`` for unlimited; blank lines and
    ``#`` comments are skipped. A quota of Q is a token bucket of capacity
    Q refilled continuously at ``Q / window_seconds`` per second (measured
    on the injected ``clock``), so the limit is a true sliding rate: a
    burst of Q is admitted from a full bucket, then requests are admitted
    at the refill rate — there is no fixed-window boundary at which a
    caller can double-spend (the old minute-boundary burst artifact).
    ``REQS`` rates all authenticated requests, ``COLD`` rates requests that
    would start a fresh (cold) search — cache hits and coalesced joins
    never spend it. Over any window of ``window_seconds`` the admitted
    count is at most 2Q (bucket + refill), and exactly Q per window in
    sustained operation — the same steady-state budget the fixed windows
    granted, without the boundary spike.

    ``/v1/stats`` reports per-identity usage; the service never logs or
    serves the tokens themselves.
    """

    def __init__(
        self,
        tokens: list[TokenInfo],
        *,
        window_seconds: float = 60.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if len({t.token for t in tokens}) != len(tokens):
            raise ValueError("duplicate token in token list")
        self._by_token = {t.token: t for t in tokens}
        self.window_seconds = window_seconds
        self.clock = clock
        self._lock = threading.Lock()
        self.unauthorized = 0
        # buckets are per *token* (the unit the quotas are declared on —
        # several tokens may share an identity without sharing budgets) and
        # start full; lifetime totals aggregate per identity for /v1/stats
        self._usage: dict[str, dict] = {
            t.token: {
                "requests_level": float(t.requests_per_window or 0),
                "cold_level": float(t.cold_per_window or 0),
                "refilled_at": None,
            }
            for t in tokens
        }
        self._totals: dict[str, dict] = {}
        for t in tokens:
            self._totals.setdefault(t.identity, {
                "requests": 0, "cold_searches": 0, "throttled": 0,
            })

    @classmethod
    def from_file(cls, path: str, **kw) -> "AuthQuota":
        tokens = []
        with open(path) as f:
            for ln, line in enumerate(f, 1):
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) < 2:
                    raise ValueError(
                        f"{path}:{ln}: expected 'TOKEN IDENTITY [REQS [COLD]]'"
                    )
                quotas = []
                for raw in parts[2:4]:
                    if raw == "-":
                        quotas.append(None)
                        continue
                    q = int(raw)
                    if q < 0:
                        raise ValueError(
                            f"{path}:{ln}: quota must be >= 0"
                            f" (or '-' for unlimited), got {raw!r}"
                        )
                    quotas.append(q)
                quotas += [None] * (2 - len(quotas))
                tokens.append(TokenInfo(parts[0], parts[1], *quotas))
        if not tokens:
            raise ValueError(f"{path}: no tokens defined")
        return cls(tokens, **kw)

    def identify(self, auth_header: Optional[str]) -> Optional[TokenInfo]:
        """Resolve an ``Authorization: Bearer <token>`` header (also accepts
        the bare token). None means 401."""
        if not auth_header:
            with self._lock:
                self.unauthorized += 1
            return None
        token = auth_header.strip()
        if token.lower().startswith("bearer "):
            token = token[len("bearer "):].strip()
        info = self._by_token.get(token)
        if info is None:
            with self._lock:
                self.unauthorized += 1
        return info

    def _refill(self, info: TokenInfo, u: dict, now: float) -> dict:
        """Continuous token-bucket refill up to capacity (the quota)."""
        last = u["refilled_at"]
        u["refilled_at"] = now
        if last is None:
            return u  # buckets start full
        dt = max(now - last, 0.0)
        if info.requests_per_window is not None:
            u["requests_level"] = min(
                float(info.requests_per_window),
                u["requests_level"]
                + dt * info.requests_per_window / self.window_seconds,
            )
        if info.cold_per_window is not None:
            u["cold_level"] = min(
                float(info.cold_per_window),
                u["cold_level"] + dt * info.cold_per_window / self.window_seconds,
            )
        return u

    def charge_request(self, info: TokenInfo) -> bool:
        """Spend one request; False means the quota rejected it (429)."""
        with self._lock:
            u = self._refill(info, self._usage[info.token], self.clock())
            if info.requests_per_window is not None:
                if u["requests_level"] < 1.0:
                    self._totals[info.identity]["throttled"] += 1
                    return False
                u["requests_level"] -= 1.0
            self._totals[info.identity]["requests"] += 1
            return True

    def cold_hook(self, info: TokenInfo) -> Callable[[], None]:
        """The ``on_cold`` callback for this token: spends one cold-search
        unit or raises :class:`QuotaExceeded`."""

        def charge() -> None:
            with self._lock:
                u = self._refill(info, self._usage[info.token], self.clock())
                if info.cold_per_window is not None:
                    if u["cold_level"] < 1.0:
                        self._totals[info.identity]["throttled"] += 1
                        raise QuotaExceeded(
                            f"cold-search quota exceeded for {info.identity!r}"
                            f" ({info.cold_per_window}/{self.window_seconds:g}s"
                            f" sustained)"
                        )
                    u["cold_level"] -= 1.0
                self._totals[info.identity]["cold_searches"] += 1

        return charge

    def stats_dict(self) -> dict:
        with self._lock:
            return {
                "unauthorized": self.unauthorized,
                "tokens": {
                    ident: dict(t) for ident, t in self._totals.items()
                },
            }


# ---------------------------------------------------------------------------
# HTTP layer (stdlib http.server)
# ---------------------------------------------------------------------------

class _Handler(http.server.BaseHTTPRequestHandler):
    service: SearchService  # bound by make_server via a subclass attribute
    auth: Optional[AuthQuota] = None
    max_body_bytes: int = DEFAULT_MAX_BODY_BYTES
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by default; tests and CLIs
        pass  # read the structured responses instead

    def _reply(self, status: int, payload: dict, *, close: bool = False) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if close:
            self.send_header("Connection", "close")
            self.close_connection = True
        self.end_headers()
        self.wfile.write(body)

    def _reply_text(self, status: int, text: str) -> None:
        body = text.encode()
        self.send_response(status)
        self.send_header(
            "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
        )
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _authorize(self) -> tuple[bool, Optional[TokenInfo]]:
        """401/429 gate shared by every endpoint. Returns (admitted, token);
        on False a response has already been sent."""
        if self.auth is None:
            return True, None
        info = self.auth.identify(self.headers.get("Authorization"))
        if info is None:
            self._reply(401, {"error": "missing or unknown bearer token"})
            return False, None
        if not self.auth.charge_request(info):
            self._reply(429, {
                "error": f"request quota exceeded for {info.identity!r}"
            })
            return False, info
        return True, info

    def do_POST(self):
        url = urllib.parse.urlsplit(self.path)
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            length = -1
        if length < 0:  # absent/garbage/negative: never rfile.read(-1)
            return self._reply(400, {
                "error": "bad Content-Length header"
            }, close=True)
        if length > self.max_body_bytes:
            # refuse without reading: draining an oversized body defeats the
            # point, so give up on this connection after replying
            return self._reply(413, {
                "error": f"body of {length} bytes exceeds the"
                         f" {self.max_body_bytes}-byte limit"
            }, close=True)
        # always drain the body first: replying while it sits unread desyncs
        # HTTP/1.1 keep-alive connections
        spec_json = self.rfile.read(length).decode(errors="replace")
        admitted, token = self._authorize()
        if not admitted:
            return
        if url.path == "/v1/shard":
            return self._do_shard(spec_json)
        if url.path == "/v1/traces":
            return self._do_traces(spec_json)
        if url.path == "/v1/plan":
            return self._do_plan(spec_json, url, token)
        if url.path != "/v1/search":
            return self._reply(404, {"error": f"unknown path {url.path}"})
        try:
            SearchSpec.from_json(spec_json)
        except Exception as e:
            return self._reply(400, {"error": f"bad spec: {e}"})
        query = urllib.parse.parse_qs(url.query)
        want_async = query.get("async", ["0"])[-1] not in ("0", "", "false")
        refresh_stale = query.get("refresh", [""])[-1] == "stale"
        elastic = query.get("elastic", ["0"])[-1] not in ("0", "", "false")
        on_cold = (
            self.auth.cold_hook(token)
            if self.auth is not None and token is not None else None
        )
        try:
            if want_async:
                key, status, text = self.service.submit_json(
                    spec_json, on_cold=on_cold, refresh_stale=refresh_stale,
                    elastic=elastic,
                )
                if status == "ready":
                    return self._reply(200, {
                        "key": key, "status": "ready", "cached": True,
                        "report": json.loads(text),
                    })
                return self._reply(202, {"key": key, "status": "pending"})
            key, text, cached = self.service.search_json(
                spec_json, on_cold=on_cold, refresh_stale=refresh_stale,
                elastic=elastic,
            )
            return self._reply(200, {
                "key": key, "status": "ready", "cached": cached,
                "report": json.loads(text),
            })
        except QuotaExceeded as e:
            return self._reply(429, {"error": str(e)})
        except Exception as e:  # the spec parsed; this is a search failure
            return self._reply(500, {
                "error": f"search failed: {type(e).__name__}: {e}"
            })

    def _do_shard(self, body_json: str):
        """Fleet worker endpoint: one shard in, one mergeable payload out.

        Charges the request quota like every endpoint but never the cold
        quota — a shard is a slice of someone else's search, and a
        coordinator overshards, so cold-charging each slice would
        multiply the spend by the shard count."""
        try:
            payload = self.service.shard_json(body_json)
        except NotImplementedError as e:
            return self._reply(501, {"error": str(e)})
        except (ValueError, KeyError, TypeError) as e:
            return self._reply(400, {
                "error": f"bad shard request: {type(e).__name__}: {e}"
            })
        except Exception as e:
            return self._reply(500, {
                "error": f"shard failed: {type(e).__name__}: {e}"
            })
        return self._reply(200, payload)

    def _do_plan(self, body_json: str, url, token: Optional[TokenInfo]):
        """Fleet planner endpoint: FleetSpec JSON in, FleetPlan envelope out.

        Shares the auth/request-quota gate; the cold quota is charged once
        per cold *plan*, never per grid cell (see
        :meth:`SearchService.plan_json`). ``?refresh=stale`` re-plans a
        cached plan stamped by an outdated eta model; ``?elastic=1``
        re-plans a resized fleet with changed cells warm-started from
        their prior family reports."""
        from repro_torch.fleet.spec import FleetSpec

        try:
            FleetSpec.from_json(body_json)
        except Exception as e:
            return self._reply(400, {"error": f"bad fleet spec: {e}"})
        query = urllib.parse.parse_qs(url.query)
        refresh_stale = query.get("refresh", [""])[-1] == "stale"
        elastic = query.get("elastic", ["0"])[-1] not in ("0", "", "false")
        on_cold = (
            self.auth.cold_hook(token)
            if self.auth is not None and token is not None else None
        )
        try:
            key, text, cached = self.service.plan_json(
                body_json, on_cold=on_cold, refresh_stale=refresh_stale,
                elastic=elastic,
            )
            return self._reply(200, {
                "key": key, "status": "ready", "cached": cached,
                "plan": json.loads(text),
            })
        except QuotaExceeded as e:
            return self._reply(429, {"error": str(e)})
        except Exception as e:  # the fleet parsed; this is a planning failure
            return self._reply(500, {
                "error": f"plan failed: {type(e).__name__}: {e}"
            })

    def _do_traces(self, body_json: str):
        """Calibration inlet: one StepTrace in, one scoring ack out.

        Shares the auth/request-quota gate; never charges the cold quota
        (a trace is telemetry, not a search)."""
        try:
            ack = self.service.ingest_trace_json(body_json)
        except NotImplementedError as e:
            return self._reply(501, {"error": str(e)})
        except (ValueError, KeyError, TypeError) as e:
            return self._reply(400, {
                "error": f"bad trace: {type(e).__name__}: {e}"
            })
        except Exception as e:
            return self._reply(500, {
                "error": f"trace ingestion failed: {type(e).__name__}: {e}"
            })
        return self._reply(200, ack)

    def do_GET(self):
        try:
            return self._do_get()
        except Exception as e:  # never a traceback + dropped socket
            return self._reply(500, {
                "error": f"{type(e).__name__}: {e}"
            }, close=True)

    def _do_get(self):
        admitted, _ = self._authorize()
        if not admitted:
            return
        url = urllib.parse.urlsplit(self.path)
        if url.path == "/v1/stats":
            stats = self.service.stats_dict()
            if self.auth is not None:
                stats["auth"] = self.auth.stats_dict()
            return self._reply(200, stats)
        if url.path == "/metrics":
            return self._reply_text(
                200, metrics_text(self.service, self.auth)
            )
        prefix = "/v1/results/"
        if url.path.startswith(prefix):
            key = url.path[len(prefix):]
            status, text = self.service.result_json(key)
            if status == "ready":
                return self._reply(200, {
                    "key": key, "status": status, "cached": True,
                    "report": json.loads(text),
                })
            if status == "pending":
                return self._reply(202, {"key": key, "status": status})
            if status == "failed":
                return self._reply(500, {
                    "key": key, "status": status, "error": text,
                })
            return self._reply(404, {"key": key, "status": status})
        return self._reply(404, {"error": f"unknown path {url.path}"})


def make_server(
    service: SearchService,
    host: str = "127.0.0.1",
    port: int = 8123,
    *,
    auth: Optional[AuthQuota] = None,
    max_body_bytes: int = DEFAULT_MAX_BODY_BYTES,
) -> http.server.ThreadingHTTPServer:
    """Bind the service to a threading HTTP server (``port=0`` for an
    ephemeral port; the bound one is on ``server.server_address``)."""
    handler = type("SearchServiceHandler", (_Handler,), {
        "service": service, "auth": auth, "max_body_bytes": max_body_bytes,
    })
    return http.server.ThreadingHTTPServer((host, port), handler)


def serve_forever(
    service: SearchService, host: str, port: int,
    *, auth: Optional[AuthQuota] = None,
) -> None:
    server = make_server(service, host, port, auth=auth)
    bound = server.server_address
    print(f"search service listening on http://{bound[0]}:{bound[1]}"
          f" (store={service.store.kind}"
          f"{', auth on' if auth is not None else ''})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


# ---------------------------------------------------------------------------
# CLI client
# ---------------------------------------------------------------------------

def post_spec(
    base_url: str,
    spec_json: str,
    *,
    token: Optional[str] = None,
    timeout: float = DEFAULT_SEARCH_TIMEOUT,
    retries: int = DEFAULT_RETRIES,
    elastic: bool = False,
) -> tuple[str, SearchReport, bool]:
    """Client half of the sync endpoint: POST a spec JSON to a running
    service and return ``(cache_key, report, cached)``. The one place that
    understands the response envelope — CLIs and examples share it. Goes
    through the hardened client (:mod:`repro_torch.core.http_client`): a dead
    server fails within ``timeout`` instead of hanging, transient
    transport faults retry with backoff, HTTP error statuses never do.
    ``elastic`` posts ``?elastic=1`` — warm-start from the family's prior
    report after a pool resize."""
    path = "/v1/search?elastic=1" if elastic else "/v1/search"
    status, payload = _http_json(
        f"{base_url.rstrip('/')}{path}", spec_json.encode(),
        token=token, timeout=timeout, retries=retries,
    )
    if status != 200:
        raise RuntimeError(
            f"search service answered {status}: "
            f"{payload.get('error', payload)}"
        )
    return (
        payload["key"],
        SearchReport.from_dict(payload["report"]),
        bool(payload.get("cached")),
    )


def post_plan(
    base_url: str,
    fleet_json: str,
    *,
    token: Optional[str] = None,
    timeout: float = DEFAULT_SEARCH_TIMEOUT,
    retries: int = DEFAULT_RETRIES,
    elastic: bool = False,
) -> tuple[str, "FleetPlan", bool]:  # noqa: F821 (lazy import)
    """Client half of ``POST /v1/plan``: returns ``(key, plan, cached)``.
    ``elastic`` posts ``?elastic=1`` — the re-plan path for a resized
    fleet (changed cells warm-start from their prior family reports)."""
    from repro_torch.fleet.assign import FleetPlan

    path = "/v1/plan?elastic=1" if elastic else "/v1/plan"
    status, payload = _http_json(
        f"{base_url.rstrip('/')}{path}", fleet_json.encode(),
        token=token, timeout=timeout, retries=retries,
    )
    if status != 200:
        raise RuntimeError(
            f"search service answered {status}: "
            f"{payload.get('error', payload)}"
        )
    return (
        payload["key"],
        FleetPlan.from_dict(payload["plan"]),
        bool(payload.get("cached")),
    )


def _cmd_serve(args) -> int:
    from repro_torch.calibration.fit import load_or_train

    eta, _ = load_or_train()
    backend = None
    if args.fleet:
        if args.search_workers is not None:
            print("--fleet and --search-workers are mutually exclusive: "
                  "a coordinator's fan-out is its worker list")
            return 2
        urls = [u.strip() for u in args.fleet.split(",") if u.strip()]
        backend = FleetBackend(
            urls, token=args.fleet_token, timeout=args.fleet_timeout,
        )
    store = parse_store_url(
        args.store, max_entries=args.max_entries, ttl_seconds=args.ttl,
    )
    calibration = None
    if args.calibration:
        from repro_torch.calibration.loop import CalibrationLoop
        from repro_torch.calibration.registry import parse_registry_url

        calibration = CalibrationLoop(
            eta,
            registry=parse_registry_url(args.calibration),
            threshold=args.calibration_threshold,
        )
    service = SearchService(
        Astra(eta, backend=backend), store=store,
        search_concurrency=args.search_concurrency,
        workers=args.search_workers,
        calibration=calibration,
    )
    auth = AuthQuota.from_file(args.auth_tokens) if args.auth_tokens else None
    serve_forever(service, args.host, args.port, auth=auth)
    return 0


def _cmd_search(args) -> int:
    with open(args.spec) as f:
        spec_json = f.read()
    SearchSpec.from_json(spec_json)  # fail fast on malformed specs
    base = args.url.rstrip("/")
    if args.async_poll:
        q = "async=1&elastic=1" if args.elastic else "async=1"
        status, payload = _http_json(
            f"{base}/v1/search?{q}", spec_json.encode(),
            token=args.token, timeout=args.timeout, retries=args.retries,
        )
        while status == 202:
            time.sleep(args.poll_interval)
            status, payload = _http_json(
                f"{base}/v1/results/{payload['key']}", token=args.token,
                timeout=args.timeout, retries=args.retries,
            )
        if status != 200:
            print(json.dumps(payload, indent=2))
            return 1
        key, cached = payload["key"], payload.get("cached")
        report = SearchReport.from_dict(payload["report"])
    else:
        try:
            key, report, cached = post_spec(
                base, spec_json, token=args.token,
                timeout=args.timeout, retries=args.retries,
                elastic=args.elastic,
            )
        except (RuntimeError, OSError) as e:
            print(e)
            return 1
    b = report.best
    print(f"key={key} cached={cached}")
    if b is None:
        print(f"{report.mode}: no feasible strategy")
    else:
        print(f"{report.mode}: {b.device} x{b.num_devices} "
              f"tp={b.tensor_parallel} pp={b.pipeline_parallel} "
              f"dp={b.data_parallel} -> "
              f"{report.best_sim.throughput_tokens:,.0f} tok/s simulated")
    return 0


def _cmd_traces(args) -> int:
    """POST a JSONL trace file (one StepTrace per line, the --emit-traces
    format) to a calibration-enabled service and print each ack."""
    from repro_torch.calibration.traces import StepTrace

    base = args.url.rstrip("/")
    rc = 0
    with open(args.traces) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                StepTrace.from_json(line)  # fail fast on malformed lines
            except Exception as e:
                print(f"{args.traces}:{ln}: bad trace: {e}")
                return 1
            status, payload = _http_json(
                f"{base}/v1/traces", line.encode(), token=args.token,
                timeout=args.timeout, retries=args.retries,
            )
            if status != 200:
                print(f"{args.traces}:{ln}: {status}:"
                      f" {payload.get('error', payload)}")
                rc = 1
                continue
            line_out = (
                f"{args.traces}:{ln}: accuracy={payload['accuracy']:.4f}"
                f" rolling={payload['rolling_accuracy']:.4f}"
                f" model={payload['eta_model_version']}"
            )
            if payload.get("refit"):
                line_out += f" REFIT -> {payload['new_version']}"
            print(line_out)
    return rc


def _cmd_plan(args) -> int:
    """POST a FleetSpec file to /v1/plan and print the plan summary."""
    from repro_torch.fleet.spec import FleetSpec

    with open(args.spec) as f:
        fleet_json = f.read()
    FleetSpec.from_json(fleet_json)  # fail fast on malformed fleets
    try:
        key, plan, cached = post_plan(
            args.url, fleet_json, token=args.token,
            timeout=args.timeout, retries=args.retries,
            elastic=args.elastic,
        )
    except (RuntimeError, OSError) as e:
        print(e)
        return 1
    print(f"key={key} cached={cached} solver={plan.solver}"
          f" objective={plan.objective.kind}")
    for a in plan.assignments:
        b = a.choice.strategy
        print(f"  {a.workload} -> {a.pool} ({b.device} x{a.devices}"
              f" tp={b.tensor_parallel} pp={b.pipeline_parallel}"
              f" dp={b.data_parallel}): {a.throughput:,.0f} tok/s,"
              f" ${a.dollars_per_hour:,.2f}/hr, {a.train_hours:,.1f} h,"
              f" {a.carbon_kg:,.1f} kg CO2e")
    for u in plan.unassigned:
        print(f"  {u['workload']}: UNASSIGNED ({u['reason']})")
    for p in plan.pools:
        print(f"  pool {p.pool} ({p.device}): {p.used}/{p.capacity} devices"
              f" used, {p.leftover} left")
    print(f"  totals: {plan.total_throughput:,.0f} tok/s,"
          f" ${plan.total_dollars_per_hour:,.2f}/hr,"
          f" {plan.throughput_per_dollar:,.0f} tok/s per $/hr,"
          f" {plan.total_carbon_kg:,.1f} kg CO2e")
    return 0


def _cmd_stats(args) -> int:
    try:
        status, payload = _http_json(
            f"{args.url.rstrip('/')}/v1/stats", token=args.token,
            timeout=args.timeout, retries=args.retries,
        )
    except OSError as e:
        print(e)
        return 1
    print(json.dumps(payload, indent=2))
    return 0 if status == 200 else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.serve.search_service")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("serve", help="run the HTTP search service")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8123)
    p.add_argument("--max-entries", type=int, default=128)
    p.add_argument("--ttl", type=float, default=None,
                   help="result TTL in seconds (default: no expiry)")
    p.add_argument("--store", default="memory", metavar="URL",
                   help="report store: memory | sqlite:PATH | tiered:PATH "
                        "(durable stores survive restarts and are shared "
                        "across replicas)")
    p.add_argument("--auth-tokens", default=None, metavar="FILE",
                   help="enable bearer-token auth/quota from FILE "
                        "(lines: TOKEN IDENTITY [REQS_PER_MIN [COLD_PER_MIN]])")
    p.add_argument("--search-concurrency", type=int, default=4,
                   help="max cold searches of distinct specs running "
                        "concurrently (identical specs still single-flight)")
    p.add_argument("--search-workers", type=int, default=None, metavar="N",
                   help="override Limits.workers on every cold search "
                        "(0 = one worker per CPU core; execution detail — "
                        "never changes a spec's cache key or its report)")
    p.add_argument("--fleet", default=None, metavar="URL[,URL...]",
                   help="coordinator mode: fan every cold search out to "
                        "these worker services (POST /v1/shard, "
                        "work-stealing + reassignment) and merge here; "
                        "the merged report lands in this service's store. "
                        "Mutually exclusive with --search-workers")
    p.add_argument("--fleet-token", default=None, metavar="TOKEN",
                   help="bearer token this coordinator presents to "
                        "auth-enabled fleet workers")
    p.add_argument("--fleet-timeout", type=float,
                   default=DEFAULT_SHARD_TIMEOUT, metavar="SECONDS",
                   help="per-shard HTTP timeout before the shard is "
                        "reassigned (default %(default)s)")
    p.add_argument("--calibration", default=None, metavar="URL",
                   help="enable the calibration feedback loop with this "
                        "model registry: memory | sqlite:PATH "
                        "(POST /v1/traces ingests measured StepTraces; "
                        "accuracy decay below the threshold refits the eta "
                        "model and swaps the engine)")
    p.add_argument("--calibration-threshold", type=float, default=0.95,
                   metavar="FRAC",
                   help="rolling-accuracy bar that triggers a refit "
                        "(default %(default)s, the paper's 95%% claim)")
    p.set_defaults(fn=_cmd_serve)

    p = sub.add_parser("search", help="POST a spec file to a running service")
    p.add_argument("--url", required=True)
    p.add_argument("--spec", required=True, metavar="SPEC_JSON")
    p.add_argument("--token", default=None,
                   help="bearer token for an auth-enabled service")
    p.add_argument("--async-poll", action="store_true",
                   help="submit with ?async=1 and poll /v1/results/<key>")
    p.add_argument("--elastic", action="store_true",
                   help="POST with ?elastic=1: warm-start from the "
                        "family's prior report after a pool resize")
    p.add_argument("--poll-interval", type=float, default=0.5)
    p.add_argument("--timeout", type=float, default=DEFAULT_SEARCH_TIMEOUT,
                   metavar="SECONDS",
                   help="connect/read timeout per request; a sync search "
                        "blocks for the whole cold search, hence the large "
                        "default (%(default)s)")
    p.add_argument("--retries", type=int, default=DEFAULT_RETRIES,
                   help="additional attempts on transport faults "
                        "(connection refused/reset/timeout; HTTP error "
                        "statuses are never retried)")
    p.set_defaults(fn=_cmd_search)

    p = sub.add_parser("traces",
                       help="POST a JSONL StepTrace file to /v1/traces")
    p.add_argument("--url", required=True)
    p.add_argument("--traces", required=True, metavar="TRACES_JSONL",
                   help="one StepTrace JSON per line (the launch/train.py "
                        "--emit-traces format)")
    p.add_argument("--token", default=None,
                   help="bearer token for an auth-enabled service")
    p.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT,
                   metavar="SECONDS")
    p.add_argument("--retries", type=int, default=DEFAULT_RETRIES)
    p.set_defaults(fn=_cmd_traces)

    p = sub.add_parser("plan",
                       help="POST a FleetSpec file to /v1/plan")
    p.add_argument("--url", required=True)
    p.add_argument("--spec", required=True, metavar="FLEET_JSON")
    p.add_argument("--elastic", action="store_true",
                   help="POST with ?elastic=1: re-plan a resized fleet "
                        "with changed cells warm-started from their "
                        "prior family reports")
    p.add_argument("--token", default=None,
                   help="bearer token for an auth-enabled service")
    p.add_argument("--timeout", type=float, default=DEFAULT_SEARCH_TIMEOUT,
                   metavar="SECONDS",
                   help="connect/read timeout; a cold plan blocks for the "
                        "whole grid search (default %(default)s)")
    p.add_argument("--retries", type=int, default=DEFAULT_RETRIES)
    p.set_defaults(fn=_cmd_plan)

    p = sub.add_parser("stats", help="print /v1/stats of a running service")
    p.add_argument("--url", required=True)
    p.add_argument("--token", default=None,
                   help="bearer token for an auth-enabled service")
    p.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT,
                   metavar="SECONDS")
    p.add_argument("--retries", type=int, default=DEFAULT_RETRIES)
    p.set_defaults(fn=_cmd_stats)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
