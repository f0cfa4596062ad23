"""Execution backends: one interface from serial loop to multi-host fleet.

Astra's headline claim is search *speed*, and strategy-space evaluation is
embarrassingly parallel: candidates are independent, the cost model is
pure, and the collectors (:class:`~repro_torch.core.pareto.TopK`,
:class:`~repro_torch.core.pareto.ParetoStaircase`,
:class:`~repro_torch.core.search.SearchCounts`) are mergeable with deterministic
tie-breaking. This module turns that observation into a single interface —
:class:`ExecutionBackend` — with three implementations that differ only in
*where* the shards run:

* :class:`SerialBackend` — the in-process streaming loop (one shard, the
  facade's shared warm engines). Also the *worker half* of the fleet
  protocol: :meth:`SerialBackend.run_shard` evaluates one ``(i, n)`` shard
  and returns the wire payload a coordinator merges.
* :class:`LocalPoolBackend` — fans shards over a **long-lived warm**
  ``fork`` process pool. The pool is created once (lazily) and reused
  across searches, so repeat searches skip interpreter + pool spin-up and
  worker processes keep hot per-process caches: their evaluation engine
  and their memoized :class:`~repro_torch.core.search.FilterBank` survive from
  one search to the next. Falls back to threads when the platform has no
  ``fork`` or the pool breaks mid-search.
* :class:`FleetBackend` — ships ``(spec_json, shard_i, n)`` to remote
  workers over HTTP (``POST /v1/shard`` on a
  :class:`~repro_torch.serve.search_service.SearchService`), streams collector
  payload dicts back and merges them at the coordinator. Shards are
  *oversharded* relative to the worker count and drained from a shared
  queue, so fast workers steal the stragglers' backlog; a shard lost to a
  worker death, timeout or garbage response is re-queued and reassigned
  (bounded attempts), and a worker that keeps failing is retired.

Every backend reduces to the same primitive — :func:`evaluate_shard` over
the deterministic ``shard(i, n)`` stream views of one plan — and merges
with the same seq-tiebroken collectors, so **all three produce the exact
serial report** for any spec, worker count, shard count or merge order
(wall-time fields aside). Shard results cross process and host boundaries
as wire dicts (``CostedStrategy.to_dict``), exact by the same argument as
the report wire format.

Execution is an *execution detail* by construction: ``Limits.workers`` and
``Limits.fleet`` are dropped from
:meth:`~repro_torch.core.spec.SearchSpec.canonicalize`, so serial, pooled and
fleet searches of one spec share a cache key and a byte-identical report.
"""
from __future__ import annotations

import collections
import itertools
import json
import multiprocessing
import os
import threading
import time
import warnings
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from typing import Iterable, Optional

from repro_torch.core import wire
from repro_torch.core.batch import (
    BatchedCostSimulator,
    stream_evaluate,
    stream_evaluate_indexed,
)
from repro_torch.core.http_client import TransportError, http_json
from repro_torch.core.objectives import Collector, make_objective
from repro_torch.core.params import ParallelStrategy
from repro_torch.core.pareto import CostedStrategy
from repro_torch.core.planner import build_plan, shard_limit, timed
from repro_torch.core.rules import DEFAULT_RULES
from repro_torch.core.search import FilterBank, SearchCounts
from repro_torch.core.simulate import CostSimulator
from repro_torch.core.spec import SearchSpec

_SHARD_KIND = "astra.shard_result"

#: default per-shard HTTP timeout for the fleet coordinator (a shard is a
#: bounded slice of the search, not the whole search)
DEFAULT_SHARD_TIMEOUT = 300.0


def resolve_workers(workers: int, limit: Optional[int] = None) -> int:
    """``Limits.workers`` semantics: 0 -> one per CPU core, else >= 1.

    ``limit`` caps the answer at the spec's useful shard fan-out
    (:func:`~repro_torch.core.planner.shard_limit`) so tiny searches stop
    forking processes that would never own a block of work — a pure
    execution clamp, results are identical at any worker count.
    """
    n = max(os.cpu_count() or 1, 1) if workers == 0 else max(workers, 1)
    if limit is not None:
        n = min(n, max(limit, 1))
    return n


def _make_engine(eta_model, use_batched: bool):
    return (
        BatchedCostSimulator(eta_model) if use_batched
        else CostSimulator(eta_model)
    )


def evaluate_shard(
    spec: SearchSpec,
    *,
    eta_model=None,
    engine=None,
    rules=DEFAULT_RULES,
    use_batched: bool = True,
    chunk_size: int = 512,
    shard: tuple[int, int] = (0, 1),
    filters: Optional[FilterBank] = None,
) -> tuple[Collector, SearchCounts, int]:
    """Run one worker's share of a search: build a private plan, drain the
    ``shard`` view of every stream, return (collector, this shard's funnel
    counts, candidates evaluated). ``shard=(0, 1)`` is a full serial
    evaluation through the same code path.

    Pass ``engine`` to evaluate on an existing (warm) engine instead of
    building one from ``eta_model``; pass ``filters`` to reuse a memoized
    :class:`FilterBank` (same arch/seq/rules) across calls — both are what
    keep a long-lived worker's caches hot from one search to the next.
    """
    i, n = shard
    plan = build_plan(spec, rules=rules, filters=filters)
    objective = make_objective(
        spec.objective, train_tokens=spec.workload.train_tokens,
        inference=spec.workload.inference,
    )
    collector = objective.collector(spec.limits.top_k)
    if engine is None:
        engine = _make_engine(eta_model, use_batched)
    w = spec.workload
    evaluated = 0
    gen0 = plan.counts.gen_seconds
    t0 = time.perf_counter()
    for si, stream in enumerate(plan.streams):
        pairs = timed(stream.shard(i, n), plan.counts)
        evaluated += stream_evaluate_indexed(
            engine, spec.arch, pairs,
            lambda c, seq, si=si: collector.push(c, seq=(si,) + seq),
            global_batch=w.global_batch, seq=w.seq,
            train_tokens=w.train_tokens, chunk_size=chunk_size,
            inference=w.inference,
        )
    # simulate rung: evaluation wall-time minus this shard's generation time
    plan.counts.sim_seconds += max(
        time.perf_counter() - t0 - (plan.counts.gen_seconds - gen0), 0.0
    )
    return collector, plan.counts, evaluated


# -- shard transport (wire dicts; exact by construction) ---------------------

def dump_shard_payload(
    collector: Collector,
    counts: SearchCounts,
    evaluated: int,
    *,
    shard: Optional[tuple[int, int]] = None,
) -> dict:
    """One shard's mergeable state as a versioned wire dict — the body a
    fleet worker returns from ``POST /v1/shard`` and the in-process pool
    ships across the fork boundary."""
    d = {
        "version": wire.WIRE_VERSION,
        "kind": _SHARD_KIND,
        "top": [
            (list(seq), c.to_dict()) for seq, c in collector.topk.entries()
        ],
        "pool": [
            (list(seq), c.to_dict()) for seq, c in collector.pool.entries()
        ] if collector.pool is not None else [],
        "cells": [
            (list(seq), c.to_dict()) for seq, c in collector.cells.entries()
        ],
        "counts": counts.to_dict(),
        "evaluated": evaluated,
    }
    if shard is not None:
        d["shard"] = list(shard)
    return d


def load_shard_payload(
    payload: dict,
    objective,
    top_k: int,
    *,
    shard: Optional[tuple[int, int]] = None,
) -> tuple[Collector, SearchCounts, int]:
    """Parse and validate a shard payload into a *fresh* collector.

    Raises ``ValueError``/``KeyError``/``TypeError`` on anything malformed
    (wrong envelope, wrong shard echo, garbage rows) *before* any merged
    state is touched — a lying fleet worker can cost a retry, never a
    corrupted result.
    """
    if not isinstance(payload, dict):
        raise TypeError(f"shard payload must be a dict, got {type(payload).__name__}")
    wire.check_envelope(payload, _SHARD_KIND)
    if shard is not None and "shard" in payload:
        got = tuple(payload["shard"])
        if got != tuple(shard):
            raise ValueError(f"shard payload for {got}, expected {tuple(shard)}")
    collector = objective.collector(top_k)
    for seq, d in payload["top"]:
        collector.topk.push(CostedStrategy.from_dict(d), seq=tuple(seq))
    if collector.pool is not None:
        for seq, d in payload.get("pool", []):
            collector.pool.push(CostedStrategy.from_dict(d), seq=tuple(seq))
    for seq, d in payload.get("cells", []):
        collector.cells.push(CostedStrategy.from_dict(d), seq=tuple(seq))
    counts = SearchCounts.from_dict(payload["counts"])
    return collector, counts, int(payload["evaluated"])


def merge_shard_payload(
    collector: Collector, counts: SearchCounts, p: dict
) -> int:
    """Fold one shard payload into shared merged state; returns the
    shard's evaluated count. (For untrusted payloads, validate through
    :func:`load_shard_payload` first.)"""
    counts.merge(SearchCounts.from_dict(p["counts"]))
    for seq, d in p["top"]:
        collector.topk.push(CostedStrategy.from_dict(d), seq=tuple(seq))
    if collector.pool is not None:
        for seq, d in p.get("pool", []):
            collector.pool.push(CostedStrategy.from_dict(d), seq=tuple(seq))
    for seq, d in p.get("cells", []):
        collector.cells.push(CostedStrategy.from_dict(d), seq=tuple(seq))
    return int(p["evaluated"])


def _reject_capped(spec: SearchSpec) -> None:
    if spec.limits.max_candidates is not None:
        # a candidate cap is defined on the serial stream order and cannot
        # be distributed; Astra.search routes capped specs to the serial
        # backend — a direct caller must not silently get different results
        raise ValueError(
            "sharded execution does not support Limits.max_candidates; "
            "use SerialBackend (Astra.search routes capped specs there)"
        )


# ---------------------------------------------------------------------------
# the backend interface
# ---------------------------------------------------------------------------

class ExecutionBackend:
    """One search execution engine behind ``Astra.search``.

    ``run(spec, objective)`` evaluates the spec's candidate streams —
    however it likes, over whatever shard assignment it likes — and
    returns ``(merged collector, merged funnel counts, total evaluated)``.
    The contract every implementation honors: the triple is *identical* to
    a serial evaluation of the same spec (wall-time fields aside), because
    shards partition the streams exactly and collector ties break on
    stream position, never arrival order.
    """

    kind: str = "abstract"

    def run(
        self, spec: SearchSpec, objective
    ) -> tuple[Collector, SearchCounts, int]:
        raise NotImplementedError

    def close(self) -> None:
        """Release held resources (warm pools, ...). Idempotent."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SerialBackend(ExecutionBackend):
    """The in-process streaming loop — and the fleet worker's engine.

    Owns the shared warm engines. The serial path evaluates on them under
    a *try-acquired* lock: the first concurrent search gets the warm
    engines, the rest evaluate on private ones — a multi-threaded caller
    (the search service) always overlaps, and the engines' memo tables
    never see concurrent mutation. The engines' caches never change
    values, so the report is identical either way.
    """

    kind = "serial"

    def __init__(
        self,
        eta_model,
        rules=DEFAULT_RULES,
        *,
        use_batched: bool = True,
        chunk_size: int = 512,
    ):
        self.eta = eta_model
        self.rules = rules
        self.use_batched = use_batched
        self.chunk_size = chunk_size
        self.simulator = CostSimulator(eta_model)
        self.batched = BatchedCostSimulator(eta_model)
        self._engine_lock = threading.Lock()
        # (arch, seq) -> memoized FilterBank, guarded by the engine lock
        # (used only while holding it): a worker serving many /v1/shard
        # requests keeps filter verdicts hot across searches
        self._banks: dict = {}

    def _shared_engine(self):
        return self.batched if self.use_batched else self.simulator

    def _get_bank(self, spec: SearchSpec) -> FilterBank:
        """Memoized FilterBank for this spec's filter identity. Serving
        specs key on the inference shape too (their memory verdicts differ
        from the training ones at the same arch/seq), and on global_batch,
        which sizes the default request mix."""
        w = spec.workload
        key = (
            spec.arch, w.seq, w.inference,
            w.global_batch if w.inference is not None else None,
        )
        bank = self._banks.get(key)
        if bank is None:
            bank = self._banks[key] = FilterBank(
                spec.arch, w.seq, self.rules,
                inference=w.inference, global_batch=w.global_batch,
            )
        return bank

    def run(
        self, spec: SearchSpec, objective
    ) -> tuple[Collector, SearchCounts, int]:
        locked = self._engine_lock.acquire(blocking=False)
        try:
            engine = (
                self._shared_engine() if locked
                else _make_engine(self.eta, self.use_batched)
            )
            plan = build_plan(spec, rules=self.rules)
            collector = objective.collector(spec.limits.top_k)
            chunk_size = spec.limits.chunk_size or self.chunk_size
            w = spec.workload

            evaluated = 0
            budget = spec.limits.max_candidates
            gen0 = plan.counts.gen_seconds
            t0 = time.perf_counter()
            for stream in plan.streams:
                it: Iterable[ParallelStrategy] = stream.strategies
                if budget is not None:
                    if budget <= evaluated:
                        break
                    it = itertools.islice(it, budget - evaluated)
                evaluated += stream_evaluate(
                    engine, spec.arch, timed(it, plan.counts), collector.push,
                    global_batch=w.global_batch, seq=w.seq,
                    train_tokens=w.train_tokens, chunk_size=chunk_size,
                    inference=w.inference,
                )
            plan.counts.sim_seconds += max(
                time.perf_counter() - t0 - (plan.counts.gen_seconds - gen0),
                0.0,
            )
        finally:
            if locked:
                self._engine_lock.release()
        return collector, plan.counts, evaluated

    def run_shard(
        self,
        spec: SearchSpec,
        shard: tuple[int, int],
        *,
        chunk_size: Optional[int] = None,
    ) -> dict:
        """The worker half of the fleet protocol: evaluate one ``(i, n)``
        shard of ``spec`` and return the mergeable wire payload.

        Uses the same warm-engine lease as :meth:`run`, plus a memoized
        per-(arch, seq) filter bank, so a worker process serving shard
        after shard evaluates on hot caches throughout.
        """
        i, n = int(shard[0]), int(shard[1])
        if n < 1 or not (0 <= i < n):
            raise ValueError(f"invalid shard {(i, n)}")
        _reject_capped(spec)
        locked = self._engine_lock.acquire(blocking=False)
        try:
            if locked:
                engine = self._shared_engine()
                bank = self._get_bank(spec)
            else:
                engine, bank = _make_engine(self.eta, self.use_batched), None
            collector, counts, evaluated = evaluate_shard(
                spec, engine=engine, rules=self.rules,
                chunk_size=chunk_size or spec.limits.chunk_size or self.chunk_size,
                shard=(i, n), filters=bank,
            )
        finally:
            if locked:
                self._engine_lock.release()
        return dump_shard_payload(collector, counts, evaluated, shard=(i, n))


# ---------------------------------------------------------------------------
# local warm pool
# ---------------------------------------------------------------------------

# Everything a fork-pool worker needs, registered *at backend construction*
# (before the pool's first fork) so the workers inherit it for their whole
# lifetime — the eta model is never pickled; GBT models and analytic models
# alike ride the fork. Keyed by a per-backend context id so concurrent
# backends (a multi-threaded SearchService) never clobber each other.
_POOL_CONTEXTS: dict[int, tuple] = {}
_CTX_IDS = itertools.count(1)

# Worker-process-side caches (inherited empty, populated per process):
# long-lived pool workers keep their engine and their memoized filter
# banks warm across searches — the whole point of not tearing the pool
# down between runs.
_WORKER_ENGINES: dict = {}
_WORKER_BANKS: dict = {}


def _pool_shard(ctx_id: int, spec_json: str, i: int, n: int,
                chunk_size: int) -> dict:
    """Warm-pool worker entry: context via fork inheritance, the spec as
    JSON, the result back as a wire dict. Engine and filter bank persist
    in module globals between calls — the worker only pays for them once."""
    eta_model, rules, use_batched = _POOL_CONTEXTS[ctx_id]
    engine = _WORKER_ENGINES.get(ctx_id)
    if engine is None:
        engine = _WORKER_ENGINES[ctx_id] = _make_engine(eta_model, use_batched)
    spec = SearchSpec.from_json(spec_json)
    w = spec.workload
    bank_key = (
        ctx_id, spec.arch, w.seq, w.inference,
        w.global_batch if w.inference is not None else None,
    )
    bank = _WORKER_BANKS.get(bank_key)
    if bank is None:
        bank = _WORKER_BANKS[bank_key] = FilterBank(
            spec.arch, w.seq, rules,
            inference=w.inference, global_batch=w.global_batch,
        )
    collector, counts, evaluated = evaluate_shard(
        spec, engine=engine, rules=rules, chunk_size=chunk_size,
        shard=(i, n), filters=bank,
    )
    return dump_shard_payload(collector, counts, evaluated, shard=(i, n))


def _pool_pid() -> int:
    return os.getpid()


class LocalPoolBackend(ExecutionBackend):
    """Sharded execution on a long-lived warm ``fork`` process pool.

    The pool is created lazily on the first sharded run and *reused across
    searches*: repeat searches skip process spin-up entirely, and each
    worker process keeps its engine + filter banks hot (see
    :func:`_pool_shard`). ``close()`` (or garbage collection of the
    backend) tears it down.

    ``executor`` forces ``"process"`` or ``"thread"``; the default picks
    the fork pool when the platform has one and threads otherwise. A pool
    broken mid-search (e.g. a worker OOM-killed) is discarded, the search
    retried on threads, and the next run builds a fresh pool.
    """

    kind = "local-pool"

    def __init__(
        self,
        eta_model,
        rules=DEFAULT_RULES,
        *,
        use_batched: bool = True,
        chunk_size: int = 512,
        workers: int = 0,
        executor: Optional[str] = None,
    ):
        if executor not in (None, "process", "thread"):
            raise ValueError(f"unknown executor {executor!r}")
        self.eta = eta_model
        self.rules = rules
        self.use_batched = use_batched
        self.chunk_size = chunk_size
        self.workers = workers
        self.max_workers = resolve_workers(workers)
        self.executor = executor
        self._ctx_id = next(_CTX_IDS)
        _POOL_CONTEXTS[self._ctx_id] = (eta_model, rules, use_batched)
        self._pool: Optional[ProcessPoolExecutor] = None
        self._pool_lock = threading.Lock()
        self.pool_spinups = 0  # observable warm-pool accounting
        self.searches = 0

    # -- pool lifecycle ----------------------------------------------------
    def _ensure_pool(self) -> ProcessPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                ctx = multiprocessing.get_context("fork")
                self._pool = ProcessPoolExecutor(
                    max_workers=self.max_workers, mp_context=ctx
                )
                self.pool_spinups += 1
            return self._pool

    def _discard_pool(self) -> None:
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)

    def worker_pids(self) -> tuple[int, ...]:
        """PIDs of the live pool processes (empty before the first sharded
        run or after ``close``) — warm-pool observability for tests and
        benchmarks."""
        with self._pool_lock:
            if self._pool is None:
                return ()
            return tuple(sorted(self._pool._processes.keys()))

    def close(self) -> None:
        self._discard_pool()
        _POOL_CONTEXTS.pop(self._ctx_id, None)

    # -- execution ---------------------------------------------------------
    def run(
        self,
        spec: SearchSpec,
        objective,
        *,
        workers: Optional[int] = None,
    ) -> tuple[Collector, SearchCounts, int]:
        _reject_capped(spec)
        self.searches += 1
        requested = workers
        if requested is None:
            # the spec's ask wins; a spec that didn't ask for fan-out
            # (workers == 1, e.g. routed here by a backend override)
            # falls back to this backend's configured width
            requested = spec.limits.workers
            if requested == 1:
                requested = self.workers
        n = resolve_workers(requested, limit=shard_limit(spec))
        chunk_size = spec.limits.chunk_size or self.chunk_size
        merged = objective.collector(spec.limits.top_k)
        counts = SearchCounts()
        evaluated = 0

        if n == 1:
            collector, c, evaluated = evaluate_shard(
                spec, eta_model=self.eta, rules=self.rules,
                use_batched=self.use_batched, chunk_size=chunk_size,
                shard=(0, 1),
            )
            merged.merge(collector)
            counts.merge(c)
            return merged, counts, evaluated

        mode = self.executor
        if mode is None:
            mode = (
                "process"
                if "fork" in multiprocessing.get_all_start_methods()
                else "thread"
            )

        if mode == "process":
            try:
                payloads = self._run_processes(spec, n, chunk_size)
            except (BrokenProcessPool, OSError) as e:
                warnings.warn(
                    f"parallel search: process pool failed"
                    f" ({type(e).__name__}: {e}); retrying on a thread pool",
                    RuntimeWarning,
                )
                self._discard_pool()
                mode = "thread"
            else:
                for p in payloads:
                    evaluated += merge_shard_payload(merged, counts, p)
                return merged, counts, evaluated

        for collector, c, e in self._run_threads(spec, n, chunk_size):
            merged.merge(collector)
            counts.merge(c)
            evaluated += e
        return merged, counts, evaluated

    def _run_processes(
        self, spec: SearchSpec, n: int, chunk_size: int
    ) -> list[dict]:
        pool = self._ensure_pool()
        spec_json = spec.to_json()
        futures = [
            pool.submit(_pool_shard, self._ctx_id, spec_json, i, n, chunk_size)
            for i in range(n)
        ]
        return [f.result() for f in futures]

    def _run_threads(
        self, spec: SearchSpec, n: int, chunk_size: int
    ) -> list[tuple[Collector, SearchCounts, int]]:
        with ThreadPoolExecutor(max_workers=n) as ex:
            futures = [
                ex.submit(
                    evaluate_shard, spec, eta_model=self.eta,
                    rules=self.rules, use_batched=self.use_batched,
                    chunk_size=chunk_size, shard=(i, n),
                )
                for i in range(n)
            ]
            return [f.result() for f in futures]


# ---------------------------------------------------------------------------
# HTTP fleet
# ---------------------------------------------------------------------------

class FleetError(RuntimeError):
    """A fleet search could not complete: shards remained unfinished after
    every retry/reassignment avenue was exhausted."""


class FleetBackend(ExecutionBackend):
    """Coordinator: shard a search over remote HTTP workers and merge.

    Each worker URL is a :class:`~repro_torch.serve.search_service.SearchService`
    running with a real engine (``POST {url}/v1/shard``). The coordinator

    * **overshards**: ``shards_per_worker`` x the worker count (clamped to
      the spec's :func:`~repro_torch.core.planner.shard_limit`), so the unit of
      assignment is small;
    * **steals work**: one client thread per worker drains a shared shard
      queue — a fast worker that finishes its share keeps pulling shards
      that would otherwise wait on a straggler;
    * **survives failure**: a shard lost to a connection error, timeout,
      non-200 response or malformed payload goes back on the queue (up to
      ``max_attempts`` total tries, any worker may pick it up), and a
      worker failing ``max_worker_failures`` times in a row is retired.
      Payloads are validated into a fresh collector *before* merging, so
      a garbage response can never half-corrupt the merged state.

    If shards remain unfinished — every attempt spent or every worker
    retired — the search raises :class:`FleetError` rather than return a
    silently partial report.
    """

    kind = "fleet"

    def __init__(
        self,
        workers: Iterable[str],
        *,
        token: Optional[str] = None,
        timeout: float = DEFAULT_SHARD_TIMEOUT,
        shards_per_worker: int = 4,
        max_attempts: int = 3,
        max_worker_failures: int = 2,
        http=http_json,
    ):
        self.urls = tuple(str(u).rstrip("/") for u in workers)
        if not self.urls:
            raise ValueError("FleetBackend needs at least one worker URL")
        self.token = token
        self.timeout = timeout
        self.shards_per_worker = max(shards_per_worker, 1)
        self.max_attempts = max(max_attempts, 1)
        self.max_worker_failures = max(max_worker_failures, 1)
        self._http = http
        self.last_run_stats: dict = {}

    def run(
        self, spec: SearchSpec, objective
    ) -> tuple[Collector, SearchCounts, int]:
        _reject_capped(spec)
        n = min(
            shard_limit(spec),
            max(len(self.urls) * self.shards_per_worker, 1),
        )
        top_k = spec.limits.top_k
        spec_dict = spec.canonicalize()
        chunk_size = spec.limits.chunk_size

        lock = threading.Lock()
        cond = threading.Condition(lock)
        pending = collections.deque((i, 0) for i in range(n))
        results: dict[int, tuple[Collector, SearchCounts, int]] = {}
        assignments: dict[str, int] = {u: 0 for u in self.urls}
        errors: list[str] = []
        state = {"in_flight": 0, "failed": None, "reassigned": 0}

        def client(url: str) -> None:
            consecutive = 0
            while True:
                with cond:
                    while True:
                        if state["failed"] is not None or len(results) == n:
                            return
                        if pending:
                            i, attempts = pending.popleft()
                            state["in_flight"] += 1
                            break
                        if state["in_flight"] == 0:
                            return
                        cond.wait()
                body = {
                    "spec": spec_dict,
                    "shard": [i, n],
                }
                if chunk_size is not None:
                    body["chunk_size"] = chunk_size
                err = None
                try:
                    status, payload = self._http(
                        url + "/v1/shard", json.dumps(body).encode(),
                        token=self.token, timeout=self.timeout, retries=0,
                    )
                    if status != 200:
                        raise TransportError(
                            f"HTTP {status}: {payload.get('error', payload)}"
                        )
                    triple = load_shard_payload(
                        payload, objective, top_k, shard=(i, n)
                    )
                except (OSError, ValueError, KeyError, TypeError) as e:
                    err = f"shard {i}/{n} on {url}: {type(e).__name__}: {e}"
                with cond:
                    state["in_flight"] -= 1
                    if err is not None:
                        errors.append(err)
                        consecutive += 1
                        if attempts + 1 < self.max_attempts:
                            pending.append((i, attempts + 1))
                            state["reassigned"] += 1
                        else:
                            state["failed"] = (
                                f"shard {i}/{n} failed after "
                                f"{attempts + 1} attempts"
                            )
                        cond.notify_all()
                        if consecutive >= self.max_worker_failures:
                            return  # retire this worker; others steal
                        continue
                    consecutive = 0
                    if i not in results:
                        results[i] = triple
                        assignments[url] += 1
                    cond.notify_all()

        threads = [
            threading.Thread(target=client, args=(u,), daemon=True)
            for u in self.urls
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        self.last_run_stats = {
            "shards": n,
            "completed": len(results),
            "reassigned": state["reassigned"],
            "assignments": dict(assignments),
            "errors": list(errors),
        }
        if len(results) < n:
            reason = state["failed"] or "every worker retired"
            raise FleetError(
                f"fleet search incomplete ({len(results)}/{n} shards): "
                f"{reason}; errors: {errors}"
            )

        merged = objective.collector(top_k)
        counts = SearchCounts()
        evaluated = 0
        for i in range(n):
            collector, c, e = results[i]
            merged.merge(collector)
            counts.merge(c)
            evaluated += e
        return merged, counts, evaluated


# ---------------------------------------------------------------------------
# convenience / compat
# ---------------------------------------------------------------------------

def run_sharded(
    spec: SearchSpec,
    *,
    eta_model,
    workers: int,
    rules=DEFAULT_RULES,
    use_batched: bool = True,
    chunk_size: int = 512,
    executor: Optional[str] = None,
) -> tuple[Collector, SearchCounts, int]:
    """One-shot sharded run: fan ``spec`` over ``workers`` and merge.

    A convenience wrapper over a throwaway :class:`LocalPoolBackend` —
    callers that search repeatedly should hold a backend (or an
    :class:`~repro_torch.core.api.Astra`) so the warm pool amortizes. Returns
    the exact serial ``(collector, counts, evaluated)`` triple whatever
    the worker count or executor.
    """
    backend = LocalPoolBackend(
        eta_model, rules, use_batched=use_batched, chunk_size=chunk_size,
        workers=workers, executor=executor,
    )
    try:
        objective = make_objective(
            spec.objective, train_tokens=spec.workload.train_tokens
        )
        return backend.run(spec, objective, workers=workers)
    finally:
        backend.close()
