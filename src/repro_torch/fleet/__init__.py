"""Fleet capacity planner: multi-job strategy search + assignment.

A planner layer above :meth:`repro_torch.core.api.Astra.search`: a
:class:`FleetSpec` names heterogeneous GPU pools and a queue of workloads,
:func:`repro_torch.fleet.grid.search_grid` batch-searches the workload x pool
grid through the service's spec-keyed cache, and
:func:`repro_torch.fleet.assign.solve` turns the grid into a deterministic
:class:`FleetPlan` (job -> pool placements, per-pool utilization, leftover
capacity) for the fleet objective — aggregate throughput,
throughput-per-dollar, or carbon-budgeted throughput.

Served end to end by ``POST /v1/plan`` on the search service
(:mod:`repro_torch.serve.search_service`); in-process::

    from repro_torch.fleet import FleetSpec, FleetWorkload, GpuPool, plan
    fleet = FleetSpec(
        pools=(GpuPool("a800-pool", "A800", 16),
               GpuPool("h100-pool", "H100", 8, price_per_hour=3.50)),
        workloads=(FleetWorkload("chat-7b", llama7b, 512, 4096), ...),
    )
    fleet_plan = plan(Astra(eta_model), fleet)

The port's copy of the JAX package's ``fleet`` (NumPy and stdlib only):
the port imports nothing of the JAX package.
"""
from repro_torch.fleet.assign import (
    EXHAUSTIVE_LIMIT,
    FleetPlan,
    JobAssignment,
    Option,
    PoolUsage,
    build_options,
    solve,
)
from repro_torch.fleet.grid import GridCell, cell_spec, grid_cells, search_grid
from repro_torch.fleet.spec import (
    FLEET_OBJECTIVE_KINDS,
    FleetObjective,
    FleetSpec,
    FleetWorkload,
    GpuPool,
)

__all__ = [
    "FleetSpec", "FleetWorkload", "GpuPool", "FleetObjective",
    "FLEET_OBJECTIVE_KINDS",
    "GridCell", "cell_spec", "grid_cells", "search_grid",
    "FleetPlan", "JobAssignment", "PoolUsage", "Option",
    "build_options", "solve", "EXHAUSTIVE_LIMIT",
    "plan",
]


def plan(engine, fspec: FleetSpec) -> FleetPlan:
    """One-shot convenience: plan a fleet on a bare engine or a service.

    ``engine`` is an :class:`~repro_torch.core.api.Astra` (a throwaway in-memory
    :class:`~repro_torch.serve.search_service.SearchService` wraps it so grid
    cells still dedupe and cache within the call) or an existing service
    (used as-is — cells and the plan land in its store).
    """
    from repro_torch.serve.search_service import SearchService

    if isinstance(engine, SearchService):
        return engine.plan(fspec)
    return SearchService(engine).plan(fspec)
