"""The workload x pool grid: lower fleet cells onto ordinary searches.

Each ``(workload, pool)`` cell of a :class:`~repro_torch.fleet.spec.FleetSpec`
becomes one :class:`~repro_torch.core.spec.SearchSpec` — a mode-3
:class:`~repro_torch.core.spec.DeviceSweep` over the pool's device type up to its
capacity, with a budget-less Pareto objective so the cell report's ``pool``
field carries the whole non-dominated (throughput, money) frontier for
every admissible device count. The assignment solver
(:mod:`repro_torch.fleet.assign`) then shops across those frontiers.

Cells are searched *through* a :class:`~repro_torch.serve.search_service.
SearchService`, so they inherit everything the single-job path has: the
spec-keyed store (a warm cell costs one store read), single-flight dedup,
the bounded search executor, and the parallel/fleet execution backends.
Two pools with the same device type and capacity lower to the same cell
spec and share one cache entry — pool prices are applied later, at
assignment time (they rescale Eq. 32 linearly, so the search result is
price-invariant).
"""
from __future__ import annotations

import dataclasses
import threading

from repro_torch.core.api import SearchReport
from repro_torch.core.search import SearchCounts
from repro_torch.core.spec import DeviceSweep, SearchSpec, Workload
from repro_torch.fleet.spec import FleetSpec, FleetWorkload, GpuPool


@dataclasses.dataclass(frozen=True)
class GridCell:
    """One searched cell: the workload's Pareto frontier on one pool."""

    workload: str
    pool: str
    key: str  # the cell SearchSpec's cache key
    cached: bool  # served from the store / an in-flight search
    report: SearchReport


def cell_spec(w: FleetWorkload, pool: GpuPool, *, limits=None) -> SearchSpec:
    """Lower one grid cell to a search spec.

    The sweep's power-of-two counts start at 2 (the library default),
    clamped down to the pool capacity so a capacity-1 pool lowers to a
    valid (single-count) sweep instead of tripping ``DeviceSweep``'s
    min<=max validation; ``assign.build_options`` still filters by
    capacity, so the frontier stays admissible.
    """
    from repro_torch.core.spec import Limits, ObjectiveSpec

    return SearchSpec(
        arch=w.arch,
        pool=DeviceSweep(
            (pool.device,), max_devices=pool.capacity,
            min_devices=min(2, pool.capacity),
        ),
        workload=Workload(
            global_batch=w.global_batch, seq=w.seq, train_tokens=w.train_tokens
        ),
        objective=ObjectiveSpec.pareto(None),
        space=w.space,
        limits=limits if limits is not None else Limits(),
    )


def grid_cells(
    fspec: FleetSpec,
) -> list[tuple[FleetWorkload, GpuPool, SearchSpec]]:
    """Every (workload, pool, lowered spec) triple in canonical order
    (workloads sorted by name, pools sorted by name within each)."""
    canon = fspec.canonical()
    return [
        (w, p, cell_spec(w, p, limits=fspec.limits))
        for w in canon.workloads
        for p in canon.pools
    ]


def search_grid(
    service, fspec: FleetSpec, *, elastic: bool = False
) -> tuple[list[GridCell], int, SearchCounts]:
    """Search every grid cell through ``service`` (a
    :class:`~repro_torch.serve.search_service.SearchService`).

    Returns ``(cells, warm_hits, merged_counts)``: the cells in canonical
    order, the number of cells that never ran a search (store hits plus
    duplicate cells sharing a cache key — e.g. two same-device same-capacity
    pools), and the funnel counters merged across *distinct* cells (a
    shared cell counts once — the work done, not the work referenced).

    Distinct cells fan out on threads; actual search concurrency stays
    bounded by the service's executor. Cell searches never charge the cold
    quota — the plan that spawned them is the metered unit. A cell search
    that fails fails the whole grid (a plan over a partial grid would
    silently mis-assign).

    ``elastic`` is the re-plan path: a cell whose pool resized since the
    last plan warm-starts from that family's prior cell report (see
    :meth:`SearchService.search_json`); unchanged cells stay warm hits.
    """
    triples = grid_cells(fspec)
    # dedupe by cache key: duplicate cells ride the first one's result
    order: list[str] = []
    spec_by_key: dict[str, SearchSpec] = {}
    for _, _, spec in triples:
        key = spec.cache_key()
        if key not in spec_by_key:
            spec_by_key[key] = spec
            order.append(key)
    results: dict[str, tuple[str, bool]] = {}
    errors: list[BaseException] = []
    lock = threading.Lock()

    def run(key: str, spec: SearchSpec) -> None:
        try:
            _, text, cached = service.search_json(
                spec.to_json(), elastic=elastic
            )
            with lock:
                results[key] = (text, cached)
        except BaseException as e:
            with lock:
                errors.append(e)

    if len(order) == 1:
        run(order[0], spec_by_key[order[0]])
    else:
        threads = [
            threading.Thread(target=run, args=(k, spec_by_key[k]), daemon=True)
            for k in order
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[0]

    counts = SearchCounts()
    reports: dict[str, SearchReport] = {}
    for key in order:
        text, _ = results[key]
        reports[key] = SearchReport.from_json(text)
        counts.merge(reports[key].counts)

    cells: list[GridCell] = []
    seen: set[str] = set()
    warm = 0
    for w, p, spec in triples:
        key = spec.cache_key()
        _, cached = results[key]
        if key in seen:
            cached = True  # a duplicate cell is free by construction
        seen.add(key)
        if cached:
            warm += 1
        cells.append(GridCell(
            workload=w.name, pool=p.name, key=key, cached=cached,
            report=reports[key],
        ))
    return cells, warm, counts
