"""The paper's contribution: automatic parallel-strategy search (Astra).

Layout mirrors the paper's pipeline (Fig. 2):
  params.py   — parameter set P + strategy s_i (Eq. 4, 8)
  arch.py     — parsed model architecture M (Eq. 5-6)
  search.py   — search-space generator + filter funnel (Eq. 8-9)
  rules.py    — rule-based filter DSL (Eq. 10-19)
  memory.py   — memory-based filter (Eq. 20-21)
  opspec.py   — analytic operator descriptors (theta terms)
  costmodel.py— per-stage operator census (Eq. 27-28)
  simulate.py — performance simulator with Eq. 22
  hetero.py   — heterogeneous placement search (Eq. 23)
  pareto.py   — money-limit search (Eq. 29-33) + incremental ranking
  spec.py     — declarative SearchSpec (pool union, objective, workload)
                + canonical identity (canonicalize / cache_key)
  planner.py  — spec -> tagged candidate streams over a shared FilterBank
  objectives.py — pluggable ranking / budget selection
  wire.py     — bit-exact JSON float encoding + versioned envelopes
  backend.py  — ExecutionBackend: serial loop / warm local process pool /
                HTTP fleet coordinator, all shard-exact
  http_client.py — hardened stdlib HTTP JSON client (timeouts + retries)
  api.py      — Astra.search(spec): the unified pipeline; SearchReport is
                the wire-exact result (to_json/from_json)

The port's copy of the JAX package's ``core`` (NumPy and stdlib only):
the port imports nothing of the JAX package.
"""
from repro_torch.core.api import Astra, SearchReport
from repro_torch.core.backend import (
    ExecutionBackend,
    FleetBackend,
    FleetError,
    LocalPoolBackend,
    SerialBackend,
)
from repro_torch.core.batch import BatchedCostSimulator
from repro_torch.core.arch import (
    ASSIGNED_SHAPES,
    DECODE_32K,
    InputShape,
    LONG_500K,
    ModelArch,
    PREFILL_32K,
    TRAIN_4K,
)
from repro_torch.core.hetero import HeteroPool
from repro_torch.core.params import GpuConfig, HeteroPlacement, ParallelStrategy
from repro_torch.core.simulate import CostSimulator, SimResult
from repro_torch.core.spec import (
    DeviceSweep,
    FixedPool,
    HeteroCaps,
    InferenceShape,
    Limits,
    ObjectiveSpec,
    SearchSpec,
    Workload,
)

__all__ = [
    "Astra",
    "SearchReport",
    "ExecutionBackend",
    "SerialBackend",
    "LocalPoolBackend",
    "FleetBackend",
    "FleetError",
    "SearchSpec",
    "Workload",
    "InferenceShape",
    "FixedPool",
    "HeteroCaps",
    "DeviceSweep",
    "ObjectiveSpec",
    "Limits",
    "ModelArch",
    "InputShape",
    "ASSIGNED_SHAPES",
    "TRAIN_4K",
    "PREFILL_32K",
    "DECODE_32K",
    "LONG_500K",
    "HeteroPool",
    "GpuConfig",
    "HeteroPlacement",
    "ParallelStrategy",
    "CostSimulator",
    "BatchedCostSimulator",
    "SimResult",
]
