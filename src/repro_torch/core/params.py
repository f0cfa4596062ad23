"""The Megatron-shaped parameter set P (paper §3.2, Appendix Table 3).

``ParallelStrategy`` is one point s_i = {c_gpu, P', M} of the search space
(Eq. 8). Every Table-3 parameter is present. Parameters whose execution
requires Megatron-only machinery (CPU optimizer offload) are still searched,
costed and memory-modeled — they simply carry ``executable=False`` metadata
for the TPU backend (DESIGN.md §6.1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core.arch import ModelArch

RECOMPUTE_GRANULARITY = ("none", "selective", "full")
RECOMPUTE_METHOD = ("uniform", "block")

# Table-3 parameters with no TPU/XLA execution path (cost-model only).
NON_EXECUTABLE_PARAMS = ("offload_optimizer", "no_overlap_offload_optimizer")


@dataclasses.dataclass(frozen=True)
class GpuConfig:
    """c_gpu: one device-type/count cell of the GPU pool (Eq. 1-3).

    For heterogeneous mode, a strategy carries one GpuConfig per type plus a
    stage partition (see HeteroPlacement).
    """

    device: str
    num_devices: int


@dataclasses.dataclass(frozen=True)
class HeteroPlacement:
    """Solution of Eq. 23: m_i stages with n_i layers each on GPU type i.

    Types appear in pipeline order (contiguous segments — the paper's
    O(M^P) -> O(P^{M-1}) reduction assumes identical types are adjacent).
    """

    devices: tuple[str, ...]  # type of segment i
    stages_per_type: tuple[int, ...]  # m_i
    layers_per_stage: tuple[int, ...]  # n_i (same for every stage of type i)

    @property
    def pp(self) -> int:
        return sum(self.stages_per_type)

    @property
    def total_layers(self) -> int:
        return sum(m * n for m, n in zip(self.stages_per_type, self.layers_per_stage))

    def stage_sequence(self) -> list[tuple[str, int]]:
        """[(device, n_layers)] for each of the P stages, in order."""
        out = []
        for dev, m, n in zip(self.devices, self.stages_per_type, self.layers_per_stage):
            out.extend([(dev, n)] * m)
        return out

    # -- wire format -------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "devices": list(self.devices),
            "stages_per_type": list(self.stages_per_type),
            "layers_per_stage": list(self.layers_per_stage),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "HeteroPlacement":
        return cls(
            devices=tuple(str(x) for x in d["devices"]),
            stages_per_type=tuple(int(x) for x in d["stages_per_type"]),
            layers_per_stage=tuple(int(x) for x in d["layers_per_stage"]),
        )


@dataclasses.dataclass(frozen=True)
class ParallelStrategy:
    """One searchable strategy s_i (paper Eq. 8)."""

    # -- cluster (c_gpu)
    device: str
    num_devices: int
    # -- parallel sizes
    pipeline_parallel: int = 1
    tensor_parallel: int = 1
    expert_parallel: int = 1
    # data_parallel is derived: num_devices / (pp * tp)
    micro_batch_size: int = 1
    virtual_pipeline_stages: int = 1  # num layer chunks per physical stage
    # -- sharding / memory strategy
    sequence_parallel: bool = False
    use_distributed_optimizer: bool = False
    recompute_granularity: str = "none"
    recompute_method: str = "uniform"
    recompute_num_layers: int = 0
    offload_optimizer: bool = False
    # -- fusion / overlap
    use_flash_attn: bool = True
    overlap_grad_reduce: bool = False
    overlap_param_gather: bool = False
    overlap_p2p: bool = True
    tp_comm_overlap: bool = False
    # -- heterogeneous extension (None for homogeneous strategies)
    hetero: Optional[HeteroPlacement] = None

    # ------------------------------------------------------------------
    @property
    def data_parallel(self) -> int:
        return self.num_devices // (self.pipeline_parallel * self.tensor_parallel)

    def num_microbatches(self, global_batch: int) -> int:
        return max(1, global_batch // (self.data_parallel * self.micro_batch_size))

    def is_divisible(self, arch: ModelArch, global_batch: int) -> bool:
        """Basic feasibility (the paper's GPU-division rule plus arch fit)."""
        pp, tp, ep = self.pipeline_parallel, self.tensor_parallel, self.expert_parallel
        if self.num_devices % (pp * tp) != 0:
            return False
        dp = self.data_parallel
        if dp < 1:
            return False
        if global_batch % (dp * self.micro_batch_size) != 0:
            return False
        if arch.num_layers % pp != 0:
            return False
        layers_per_stage = arch.num_layers // pp
        if self.virtual_pipeline_stages > 1:
            if layers_per_stage % self.virtual_pipeline_stages != 0:
                return False
        # TP must divide the narrowest sharded dims
        if not arch.is_attention_free:
            if arch.heads % tp != 0:
                return False
            if arch.kv_heads % tp != 0 and tp % arch.kv_heads != 0:
                return False  # allow kv replication only when tp is a multiple
        if arch.ffn and arch.ffn % tp != 0:
            return False
        if arch.family in ("ssm", "hybrid"):
            d_inner = arch.ssm_expand * arch.hidden
            nheads = arch.ssm_heads or max(d_inner // 64, 1)
            if nheads % tp != 0:
                return False
        if arch.family == "moe":
            if ep > 1:
                if arch.num_experts % ep != 0 or dp % ep != 0:
                    return False
        elif ep != 1:
            return False
        return True

    # -- wire format -------------------------------------------------------
    def to_dict(self) -> dict:
        """Pure field dict (wire form; every field is JSON-exact)."""
        d = dataclasses.asdict(self)
        d["hetero"] = self.hetero.to_dict() if self.hetero is not None else None
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ParallelStrategy":
        d = dict(d)
        h = d.pop("hetero", None)
        return cls(
            hetero=HeteroPlacement.from_dict(h) if h is not None else None,
            **d,
        )

    def to_flat_dict(self) -> dict:
        """$param view used by the rule DSL and serialization."""
        d = dataclasses.asdict(self)
        d.pop("hetero")
        d["data_parallel"] = self.data_parallel
        d["num_gpus"] = self.num_devices
        # Megatron-style aliases (so users can write rules in Megatron names)
        d["pipeline_model_parallel_size"] = self.pipeline_parallel
        d["tensor_model_parallel_size"] = self.tensor_parallel
        d["data_model_parallel_size"] = self.data_parallel
        d["expert_model_parallel_size"] = self.expert_parallel
        return d


def default_parameter_space(
    arch: ModelArch,
    num_devices: int,
    devices_per_node: int,
    global_batch: int,
    *,
    max_tp: Optional[int] = None,
    micro_batches: Sequence[int] = (1, 2, 4, 8, 16),
    include_offload: bool = True,
) -> dict[str, list]:
    """f(P): candidate values per parameter (Eq. 9 product space).

    TP is capped at the fast domain (the paper's §4 hardware note: TP spans
    NVLink only) and at the head count; PP at the layer count.
    """
    def pows2(limit: int) -> list[int]:
        out, v = [], 1
        while v <= limit:
            out.append(v)
            v *= 2
        return out

    tp_cap = min(
        max_tp or devices_per_node,
        num_devices,
        arch.heads if not arch.is_attention_free else (arch.ssm_heads or 64),
    )
    pp_cap = min(arch.num_layers, num_devices)
    # Key order is iteration order (itertools.product varies the LAST key
    # fastest), chosen for cache locality: the fields a per-layer op census
    # reads (tp/ep/mbs/sp/flash) are outermost, the remaining stage-census
    # fields (pp, recompute, ZeRO) next, and census-invariant knobs (the
    # overlap/offload toggles, the virtual-pipeline factor) innermost.
    # Strategies sharing a layer or stage census are then *consecutive* in
    # the stream — which keeps the engine's census caches hot within any
    # contiguous run, and lets the block-cyclic candidate sharding hand
    # each parallel worker a nearly disjoint set of distinct cache keys
    # instead of replicating the census work once per worker.
    space: dict[str, list] = {
        "tensor_parallel": pows2(tp_cap),
    }
    if arch.family == "moe":
        space["expert_parallel"] = [
            e for e in pows2(min(arch.num_experts, num_devices))
        ]
    space.update({
        "micro_batch_size": list(micro_batches),
        "sequence_parallel": [False, True],
        "use_flash_attn": [True] if not arch.is_attention_free else [False],
        "use_distributed_optimizer": [False, True],
        "pipeline_parallel": [p for p in pows2(pp_cap) if arch.num_layers % p == 0],
        "recompute_granularity": list(RECOMPUTE_GRANULARITY),
        "overlap_grad_reduce": [True],
        "overlap_param_gather": [True],
        "overlap_p2p": [True],
        "offload_optimizer": [False, True] if include_offload else [False],
        "virtual_pipeline_stages": [1, 2, 4],
    })
    return space
