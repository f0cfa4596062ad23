"""Elastic re-search: warm-start a search whose device pool shrank or grew.

When a fleet loses or gains capacity, the search that placed a job must be
re-run on the new pool — but most of that work is redundant: the candidate
spaces of the old and new pools overlap almost entirely, and the prior
report already ranked every overlapping candidate. :func:`elastic_search`
exploits the overlap:

* the prior report's winners (``top`` + the Pareto ``pool`` + the per-cell
  champions in ``cells``) that still fit the new pool are *re-simulated* —
  a handful of engine calls, and
* only the *newly feasible region* — device/count cells the old pool never
  contained — streams through the full generate/filter/simulate funnel.

Correctness rests on rankings being per-candidate: an objective's collector
key reads one candidate's (sim, money) alone, never the pool, so every old
candidate absent from the prior winners ranks below *each* of them in the
new search too. As long as one winner survives into the new pool, no
dropped candidate can become the new best — nor re-enter a Pareto frontier
it was already excluded from. When no winner survives, or a pool shape is
not cell-decomposable (mode-2 placement grids), the helper returns ``None``
and the caller falls back to a cold search.

The funnel counters of an elastic report tally only the survivors plus the
residual region, so ``report.evaluated`` (and every rung of
``report.counts``) is the auditable evidence that the warm start did
strictly less work than the cold search it replaced. An *unchanged* pool
never reaches this module at all: its cache key is unchanged, so the
service serves the stored report byte-identically with zero engine calls.
"""
from __future__ import annotations

import itertools
import time
from typing import Optional

from repro_torch.core.objectives import make_objective
from repro_torch.core.params import GpuConfig
from repro_torch.core.planner import pool_mode, timed
from repro_torch.core.search import FilterBank, SearchCounts, iter_valid_strategies
from repro_torch.core.spec import DeviceSweep, FixedPool, SearchSpec


def pool_cells(pool) -> Optional[frozenset]:
    """A pool's candidate space as ``(device, count)`` cells, or ``None``
    when the shape doesn't decompose into independent cells (mode-2
    placement grids couple device types through the layer assignment)."""
    if isinstance(pool, FixedPool):
        return frozenset({(pool.device, pool.num_devices)})
    if isinstance(pool, DeviceSweep):
        return frozenset(
            (d, n) for d in pool.devices for n in pool.counts()
        )
    return None


def elastic_search(astra, spec: SearchSpec, prior_spec: SearchSpec, prior):
    """Warm-start ``spec`` from ``prior`` (a :class:`SearchReport` of
    ``prior_spec``, the same search family on a different pool).

    Returns the new :class:`~repro_torch.core.api.SearchReport`, or ``None``
    when the warm start doesn't apply — either pool isn't
    cell-decomposable, or no prior winner fits the new pool (then nothing
    vouches for the overlapped region and a cold search is the only safe
    answer).
    """
    from repro_torch.core.api import SearchReport  # cycle: api imports backend

    new_cells = pool_cells(spec.pool)
    old_cells = pool_cells(prior_spec.pool)
    if new_cells is None or old_cells is None:
        return None

    # prior winners still inside the new pool, deduped across top + pool +
    # the per-cell champions (report.cells). The champions matter on a
    # shrink: top-k often collapses into the single best cell (serving
    # money is flat-to-decreasing in device count), which the shrink may
    # remove wholesale — the surviving cells' champions still vouch for
    # the whole retained region, cell by cell.
    seen: set = set()
    survivors = []
    for c in itertools.chain(prior.top, prior.pool, prior.cells):
        s = c.strategy
        if (s.device, s.num_devices) in new_cells and s not in seen:
            seen.add(s)
            survivors.append(s)
    if not survivors:
        return None

    t0 = time.perf_counter()
    w = spec.workload
    objective = make_objective(
        spec.objective, train_tokens=w.train_tokens, inference=w.inference
    )
    collector = objective.collector(spec.limits.top_k)
    counts = SearchCounts()
    chunk_size = spec.limits.chunk_size or astra.chunk_size

    from repro_torch.core.batch import stream_evaluate
    from repro_torch.core.backend import _make_engine

    # same warm-engine lease discipline as SerialBackend.run: the first
    # concurrent caller gets the shared engines, the rest go private
    locked = astra._engine_lock.acquire(blocking=False)
    try:
        engine = (
            (astra.batched if astra.use_batched else astra.simulator)
            if locked else _make_engine(astra.eta, astra.use_batched)
        )

        # 1) re-simulate the survivors (already filter-validated by the
        #    prior search — the filters read arch/seq/strategy, never the
        #    pool, so the verdicts carry over; count them on every rung)
        t_sim = time.perf_counter()
        evaluated = stream_evaluate(
            engine, spec.arch, survivors, collector.push,
            global_batch=w.global_batch, seq=w.seq,
            train_tokens=w.train_tokens, chunk_size=chunk_size,
            inference=w.inference,
        )
        counts.sim_seconds += time.perf_counter() - t_sim
        counts.generated += len(survivors)
        counts.divisible += len(survivors)
        counts.after_rules += len(survivors)
        counts.after_memory += len(survivors)

        # 2) stream only the newly-feasible region through the full funnel
        residual = sorted(new_cells - old_cells)
        if residual:
            bank = (
                astra._serial._get_bank(spec) if locked
                else FilterBank(
                    spec.arch, w.seq, astra.rules,
                    inference=w.inference, global_batch=w.global_batch,
                )
            )
            stream = iter_valid_strategies(
                spec.arch, [GpuConfig(d, n) for d, n in residual],
                w.global_batch, w.seq, space=spec.space,
                counts=counts, filters=bank,
            )
            gen0 = counts.gen_seconds
            t_sim = time.perf_counter()
            evaluated += stream_evaluate(
                engine, spec.arch, timed(stream, counts), collector.push,
                global_batch=w.global_batch, seq=w.seq,
                train_tokens=w.train_tokens, chunk_size=chunk_size,
                inference=w.inference,
            )
            counts.sim_seconds += max(
                time.perf_counter() - t_sim - (counts.gen_seconds - gen0),
                0.0,
            )
    finally:
        if locked:
            astra._engine_lock.release()

    top, pool = collector.results()
    best = objective.select(top, pool)
    total = time.perf_counter() - t0
    return SearchReport(
        mode=pool_mode(spec.pool),
        best=best.strategy if best else None,
        best_sim=best.sim if best else None,
        top=top,
        counts=counts,
        search_seconds=counts.gen_seconds,
        simulate_seconds=max(total - counts.gen_seconds, 0.0),
        pool=pool,
        evaluated=evaluated,
        eta_model_version=astra.eta_version,
        cells=collector.cells.sorted(),
    )
