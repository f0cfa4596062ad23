"""Distribution layer: sharding rules and pipeline parallelism, on torch's
DeviceMesh and DTensor (the counterpart of ``repro/parallel``)."""
from repro_torch.parallel.sharding import (
    ShardingPlan,
    batch_spec,
    cache_specs,
    make_plan,
    param_specs,
)

__all__ = ["ShardingPlan", "make_plan", "param_specs", "batch_spec", "cache_specs"]
