"""Analytic operator census for one pipeline stage (paper §3.5, Eq. 25-27).

For a (strategy, arch, device, microbatch) cell this module enumerates every
compute operator (theta_comp = FLOPs) and every communication operator
(theta_comm = payload bytes) executed per microbatch, plus the once-per-step
ops (gradient reduction, optimizer). No latency database is involved — the
census is derived from the algebra of the model, which is what lets Astra
adapt to unseen architectures (the paper's "distinguishing feature").
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.arch import ModelArch
from repro_torch.core.opspec import CommOp, ComputeOp, matmul_op
from repro_torch.core.params import ParallelStrategy
from repro_torch.core.memory import (
    GRAD_BYTES_PER_PARAM,
    OPTIMIZER_BYTES_PER_PARAM,
    stage_parameter_count,
)
from repro_torch.hw.catalog import get_device

BF16 = 2


@dataclasses.dataclass
class StageCensus:
    """Everything one pipeline stage does.

    fwd ops are per-microbatch; bwd is modeled as 2x fwd matmul FLOPs plus
    the recompute surcharge. step ops happen once per optimizer step.
    """

    device: str
    fwd_comp: list[ComputeOp] = dataclasses.field(default_factory=list)
    fwd_comm: list[CommOp] = dataclasses.field(default_factory=list)
    recompute_comp: list[ComputeOp] = dataclasses.field(default_factory=list)
    step_comp: list[ComputeOp] = dataclasses.field(default_factory=list)
    step_comm: list[CommOp] = dataclasses.field(default_factory=list)
    p2p_bytes: float = 0.0  # activation payload to the next stage, per microbatch
    bwd_flops_multiplier: float = 2.0


@dataclasses.dataclass
class StageCensusVec:
    """Count-vector form of :class:`StageCensus`: each section maps a unique
    op descriptor to its multiplicity instead of replicating it ``layers``
    times in a list. This is what lets the batched simulator evaluate a stage
    as a dot-product of counts against a shared op-time table."""

    device: str
    fwd_comp: dict[ComputeOp, float] = dataclasses.field(default_factory=dict)
    fwd_comm: dict[CommOp, float] = dataclasses.field(default_factory=dict)
    recompute_comp: dict[ComputeOp, float] = dataclasses.field(default_factory=dict)
    step_comp: dict[ComputeOp, float] = dataclasses.field(default_factory=dict)
    step_comm: dict[CommOp, float] = dataclasses.field(default_factory=dict)
    p2p_bytes: float = 0.0
    bwd_flops_multiplier: float = 2.0


def _attention_ops(
    arch: ModelArch, s: ParallelStrategy, dev: str, b: int, seq: int, causal: bool = True
) -> list[ComputeOp]:
    t = s.tensor_parallel
    h = arch.hidden
    q_dim = arch.attn_q_dim // t
    kv_dim = 2 * arch.attn_kv_dim // min(t, arch.kv_heads)
    ops = [
        matmul_op(dev, b * seq, q_dim + kv_dim, h),  # fused QKV projection
        matmul_op(dev, b * seq, h, q_dim),  # output projection
    ]
    core_flops = 4.0 * b * seq * seq * q_dim * (0.5 if causal else 1.0)
    if s.use_flash_attn:
        ops.append(
            ComputeOp(
                kind="flash_attn", device=dev, m=b * seq, n=seq, k=q_dim,
                flops=core_flops,
                bytes_accessed=BF16 * (3.0 * b * seq * q_dim + b * seq * q_dim),
            )
        )
    else:
        ops.append(
            ComputeOp(
                kind="attn", device=dev, m=b * seq, n=seq, k=q_dim,
                flops=core_flops,
                # materializes the (b, a, s, s) score matrix twice (fwd)
                bytes_accessed=BF16 * (2.0 * b * (arch.heads // t) * seq * seq),
            )
        )
    return ops


def _mlp_ops(arch: ModelArch, s: ParallelStrategy, dev: str, b: int, seq: int) -> list[ComputeOp]:
    t = s.tensor_parallel
    h = arch.hidden
    if arch.family == "moe":
        eff = (arch.moe_ffn or arch.ffn)
        # dropless top-k routing: each device processes its share of the
        # top_k-expanded token stream
        tokens = b * seq * arch.top_k
        ops = [
            matmul_op(dev, b * seq, arch.num_experts, h),  # router
            matmul_op(dev, tokens, 2 * eff // t, h),  # up + gate (all local experts)
            matmul_op(dev, tokens, h, eff // t),  # down
        ]
        if arch.shared_expert:
            ops += [
                matmul_op(dev, b * seq, 2 * eff // t, h),
                matmul_op(dev, b * seq, h, eff // t),
            ]
        return ops
    if arch.ffn == 0:
        return []
    return [
        matmul_op(dev, b * seq, 2 * arch.ffn // t, h),  # up + gate
        matmul_op(dev, b * seq, h, arch.ffn // t),  # down
    ]


def _ssm_ops(arch: ModelArch, s: ParallelStrategy, dev: str, b: int, seq: int) -> list[ComputeOp]:
    t = s.tensor_parallel
    h = arch.hidden
    d_inner = arch.ssm_expand * h
    nheads = arch.ssm_heads or max(d_inner // 64, 1)
    headdim = d_inner // nheads
    dstate = arch.ssm_state
    chunk = min(arch.ssm_chunk, seq)
    nchunks = max(seq // chunk, 1)
    ops = [
        matmul_op(dev, b * seq, (2 * d_inner + 2 * dstate + nheads) // t, h),  # in_proj
        matmul_op(dev, b * seq, h, d_inner // t),  # out_proj
    ]
    # SSD chunked scan (Dao & Gu 2024): intra-chunk quadratic + inter-chunk state
    local_heads = nheads // t
    intra = 2.0 * b * nchunks * chunk * chunk * local_heads * headdim
    state = 4.0 * b * seq * local_heads * headdim * dstate
    ops.append(
        ComputeOp(
            kind="matmul", device=dev, m=b * seq, n=headdim * local_heads, k=2 * dstate,
            flops=intra + state,
            bytes_accessed=BF16 * (3.0 * b * seq * d_inner / t),
        )
    )
    return ops


def _norm_ops(arch: ModelArch, s: ParallelStrategy, dev: str, b: int, seq: int) -> list[ComputeOp]:
    elems = b * seq * arch.hidden
    if s.sequence_parallel:
        elems //= s.tensor_parallel
    n = [
        ComputeOp(kind="norm", device=dev, m=elems, n=1, k=1,
                  flops=4.0 * elems, bytes_accessed=BF16 * 3.0 * elems)
        for _ in range(2)
    ]
    if arch.qk_norm:
        q_elems = b * seq * arch.attn_q_dim // s.tensor_parallel
        n.append(ComputeOp(kind="norm", device=dev, m=q_elems, n=1, k=1,
                           flops=4.0 * q_elems, bytes_accessed=BF16 * 3.0 * q_elems))
    return n


def layer_fwd_ops(
    arch: ModelArch, s: ParallelStrategy, dev: str, b: int, seq: int
) -> tuple[list[ComputeOp], list[CommOp]]:
    """One decoder layer, forward, per microbatch."""
    comp: list[ComputeOp] = []
    comm: list[CommOp] = []
    t = s.tensor_parallel
    spec = get_device(dev)
    tp_intra = t <= spec.devices_per_node
    act_payload = float(BF16 * b * seq * arch.hidden)

    has_attn = not arch.is_attention_free
    if has_attn:
        comp += _attention_ops(arch, s, dev, b, seq)
    if arch.family in ("ssm", "hybrid"):
        comp += _ssm_ops(arch, s, dev, b, seq)
    comp += _mlp_ops(arch, s, dev, b, seq)
    comp += _norm_ops(arch, s, dev, b, seq)

    if t > 1:
        # Megatron TP: one reduction after attention/ssm block, one after MLP.
        # With SP each all-reduce is an equivalent-payload RS+AG pair.
        n_blocks = 2 if (has_attn or arch.family == "ssm") and arch.ffn else 1
        for _ in range(n_blocks):
            if s.sequence_parallel:
                comm.append(CommOp("reduce_scatter", dev, t, act_payload, tp_intra))
                comm.append(CommOp("all_gather", dev, t, act_payload, tp_intra))
            else:
                comm.append(CommOp("all_reduce", dev, t, act_payload, tp_intra))
    if arch.family == "moe" and s.expert_parallel > 1:
        ep = s.expert_parallel
        ep_intra = ep * t <= spec.devices_per_node
        a2a_payload = float(BF16 * b * seq * arch.hidden * arch.top_k)
        comm.append(CommOp("all_to_all", dev, ep, a2a_payload, ep_intra))  # dispatch
        comm.append(CommOp("all_to_all", dev, ep, a2a_payload, ep_intra))  # combine
    return comp, comm


# ---------------------------------------------------------------------------
# per-layer census cache
# ---------------------------------------------------------------------------
# layer_fwd_ops only reads these strategy fields (besides arch/device/
# microbatch/seq), so one census serves every strategy sharing the key — in a
# mode-1 search thousands of (dp, pp, recompute, overlap...) variants collapse
# onto a few dozen distinct layer censuses.
_LAYER_KEY_FIELDS = (
    "tensor_parallel",
    "expert_parallel",
    "micro_batch_size",
    "use_flash_attn",
    "sequence_parallel",
)
_LAYER_CACHE: dict = {}
_LAYER_CACHE_MAX = 4096


def layer_census_key(arch: ModelArch, s: ParallelStrategy, dev: str, seq: int) -> tuple:
    return (arch, dev, seq) + tuple(getattr(s, f) for f in _LAYER_KEY_FIELDS)


def layer_fwd_ops_cached(
    arch: ModelArch, s: ParallelStrategy, dev: str, seq: int
) -> tuple[tuple[ComputeOp, ...], tuple[CommOp, ...]]:
    """Memoized ``layer_fwd_ops`` (b is taken from ``s.micro_batch_size``)."""
    key = layer_census_key(arch, s, dev, seq)
    hit = _LAYER_CACHE.get(key)
    if hit is None:
        if len(_LAYER_CACHE) >= _LAYER_CACHE_MAX:
            _LAYER_CACHE.clear()
        comp, comm = layer_fwd_ops(arch, s, dev, s.micro_batch_size, seq)
        hit = (tuple(comp), tuple(comm))
        _LAYER_CACHE[key] = hit
    return hit


def _edge_stage_ops(
    arch: ModelArch, s: ParallelStrategy, dev: str, stage: int, pp: int,
    b: int, seq: int,
) -> tuple[list[ComputeOp], list[CommOp]]:
    """Embedding / LM-head extras on the first and last pipeline stages."""
    comp: list[ComputeOp] = []
    comm: list[CommOp] = []
    if stage == 0:
        elems = b * seq * arch.hidden
        comp.append(
            ComputeOp(kind="embedding", device=dev, m=elems, n=1, k=1,
                      flops=float(elems), bytes_accessed=BF16 * 2.0 * elems)
        )
    if stage == pp - 1:
        comp.append(
            matmul_op(dev, b * seq, arch.vocab // s.tensor_parallel, arch.hidden)
        )
        if s.tensor_parallel > 1:
            spec = get_device(dev)
            comm.append(
                CommOp("all_reduce", dev, s.tensor_parallel,
                       float(4 * b * seq),  # softmax partials (fp32 scalars/token)
                       s.tensor_parallel <= spec.devices_per_node)
            )
    return comp, comm


def _step_ops(
    arch: ModelArch, s: ParallelStrategy, dev: str, stage: int, layers: int, pp: int,
) -> tuple[list[ComputeOp], list[CommOp]]:
    """Once-per-step gradient reduction + optimizer update for one stage."""
    comp: list[ComputeOp] = []
    comm: list[CommOp] = []
    params = stage_parameter_count(arch, s, stage, layers)
    dp = s.data_parallel
    spec = get_device(dev)
    if dp > 1:
        dp_intra = dp * s.tensor_parallel * pp <= spec.devices_per_node
        if s.use_distributed_optimizer:
            comm.append(
                CommOp("reduce_scatter", dev, dp, params * GRAD_BYTES_PER_PARAM, dp_intra)
            )
            comm.append(
                CommOp("all_gather", dev, dp, params * BF16, dp_intra)
            )
        else:
            comm.append(
                CommOp("all_reduce", dev, dp, params * GRAD_BYTES_PER_PARAM, dp_intra)
            )
    opt_params = params / dp if s.use_distributed_optimizer else params
    comp.append(
        ComputeOp(kind="elementwise", device=dev, m=int(opt_params), n=1, k=1,
                  flops=10.0 * opt_params,
                  bytes_accessed=(OPTIMIZER_BYTES_PER_PARAM + GRAD_BYTES_PER_PARAM + BF16)
                  * opt_params)
    )
    return comp, comm


def _stage_p2p_bytes(
    arch: ModelArch, s: ParallelStrategy, stage: int, pp: int, b: int, seq: int
) -> float:
    if pp > 1 and stage < pp - 1:
        payload = float(BF16 * b * seq * arch.hidden)
        if s.sequence_parallel:
            payload /= s.tensor_parallel
        return payload
    return 0.0


def build_stage_census(
    arch: ModelArch,
    s: ParallelStrategy,
    stage: int,
    *,
    seq: int,
    device: Optional[str] = None,
    layers_in_stage: Optional[int] = None,
) -> StageCensus:
    dev = device or s.device
    pp = s.pipeline_parallel
    layers = layers_in_stage if layers_in_stage is not None else arch.num_layers // pp
    b = s.micro_batch_size
    census = StageCensus(device=dev)

    lcomp, lcomm = layer_fwd_ops_cached(arch, s, dev, seq)
    lcomp, lcomm = list(lcomp), list(lcomm)
    census.fwd_comp = lcomp * layers
    census.fwd_comm = lcomm * layers

    # embedding / LM head on the edge stages
    edge_comp, edge_comm = _edge_stage_ops(arch, s, dev, stage, pp, b, seq)
    census.fwd_comp += edge_comp
    census.fwd_comm += edge_comm

    # recompute surcharge (re-runs part of fwd during bwd)
    if s.recompute_granularity == "full":
        n_rc = s.recompute_num_layers or layers
        census.recompute_comp = lcomp * min(n_rc, layers)
    elif s.recompute_granularity == "selective" and not arch.is_attention_free:
        core = [op for op in lcomp if op.kind in ("flash_attn", "attn")]
        census.recompute_comp = core * layers

    # once-per-step: gradient reduction + optimizer
    census.step_comp, census.step_comm = _step_ops(arch, s, dev, stage, layers, pp)

    census.p2p_bytes = _stage_p2p_bytes(arch, s, stage, pp, b, seq)
    return census


def _counted(ops, mult: float = 1.0) -> dict:
    out: dict = {}
    for op in ops:
        out[op] = out.get(op, 0.0) + mult
    return out


_LAYER_COUNTER_CACHE: dict = {}


def layer_counters_cached(
    arch: ModelArch, s: ParallelStrategy, dev: str, seq: int
) -> tuple[dict, dict, dict]:
    """(comp, comm, attn-core) per-layer op->count dicts, memoized."""
    key = layer_census_key(arch, s, dev, seq)
    hit = _LAYER_COUNTER_CACHE.get(key)
    if hit is None:
        if len(_LAYER_COUNTER_CACHE) >= _LAYER_CACHE_MAX:
            _LAYER_COUNTER_CACHE.clear()
        lcomp, lcomm = layer_fwd_ops_cached(arch, s, dev, seq)
        hit = (
            _counted(lcomp),
            _counted(lcomm),
            _counted([op for op in lcomp if op.kind in ("flash_attn", "attn")]),
        )
        _LAYER_COUNTER_CACHE[key] = hit
    return hit


_STEP_OPS_CACHE: dict = {}


def step_ops_counted_cached(
    arch: ModelArch, s: ParallelStrategy, dev: str, stage: int, layers: int, pp: int,
) -> tuple[dict, dict]:
    """Memoized op->count form of :func:`_step_ops` (stage enters only via
    first/last position, see ``stage_parameter_count``)."""
    key = (
        arch, dev, layers, pp, s.tensor_parallel, s.expert_parallel,
        s.data_parallel, s.use_distributed_optimizer,
        stage == 0, stage == pp - 1,
    )
    hit = _STEP_OPS_CACHE.get(key)
    if hit is None:
        if len(_STEP_OPS_CACHE) >= _LAYER_CACHE_MAX:
            _STEP_OPS_CACHE.clear()
        comp, comm = _step_ops(arch, s, dev, stage, layers, pp)
        hit = (_counted(comp), _counted(comm))
        _STEP_OPS_CACHE[key] = hit
    return hit


# ---------------------------------------------------------------------------
# serving census: dense prefill forward + KV-cache-bound per-token decode
# ---------------------------------------------------------------------------
# Serving reuses the training layer census for prefill (one dense forward at
# the prompt length) and models decode as a single-token forward whose
# attention core is bound by reading the KV cache at the mean context length.
# The request batch comes from the workload's mix, not s.micro_batch_size,
# so the serving caches key on the explicit batch.

_SERVING_KEY_FIELDS = (
    "tensor_parallel",
    "expert_parallel",
    "use_flash_attn",
    "sequence_parallel",
)
_SERVING_LAYER_CACHE: dict = {}


def decode_layer_fwd_ops(
    arch: ModelArch, s: ParallelStrategy, dev: str, b: int, context: int
) -> tuple[list[ComputeOp], list[CommOp]]:
    """One decoder layer for one autoregressive token at KV ``context``."""
    comp: list[ComputeOp] = []
    comm: list[CommOp] = []
    t = s.tensor_parallel
    h = arch.hidden
    spec = get_device(dev)
    tp_intra = t <= spec.devices_per_node
    act_payload = float(BF16 * b * h)

    has_attn = not arch.is_attention_free
    if has_attn:
        q_dim = arch.attn_q_dim // t
        kv_dim = 2 * arch.attn_kv_dim // min(t, arch.kv_heads)
        comp.append(matmul_op(dev, b, q_dim + kv_dim, h))  # fused QKV, 1 token
        comp.append(matmul_op(dev, b, h, q_dim))  # output projection
        # one query row against `context` cached keys/values: FLOPs are the
        # q.K + attn.V products, bytes are dominated by the KV-cache read
        comp.append(
            ComputeOp(
                kind="attn", device=dev, m=b, n=context, k=q_dim,
                flops=4.0 * b * context * q_dim,
                bytes_accessed=BF16 * (b * context * kv_dim + 2.0 * b * q_dim),
            )
        )
    if arch.family in ("ssm", "hybrid"):
        comp += _ssm_ops(arch, s, dev, b, 1)
    comp += _mlp_ops(arch, s, dev, b, 1)
    comp += _norm_ops(arch, s, dev, b, 1)

    if t > 1:
        n_blocks = 2 if (has_attn or arch.family == "ssm") and arch.ffn else 1
        for _ in range(n_blocks):
            if s.sequence_parallel:
                comm.append(CommOp("reduce_scatter", dev, t, act_payload, tp_intra))
                comm.append(CommOp("all_gather", dev, t, act_payload, tp_intra))
            else:
                comm.append(CommOp("all_reduce", dev, t, act_payload, tp_intra))
    if arch.family == "moe" and s.expert_parallel > 1:
        ep = s.expert_parallel
        ep_intra = ep * t <= spec.devices_per_node
        a2a_payload = float(BF16 * b * h * arch.top_k)
        comm.append(CommOp("all_to_all", dev, ep, a2a_payload, ep_intra))
        comm.append(CommOp("all_to_all", dev, ep, a2a_payload, ep_intra))
    return comp, comm


def serving_decode_context(prefill_len: int, decode_len: int) -> int:
    """Mean KV context during decode (the cache grows one token per step)."""
    return int(prefill_len + (decode_len + 1) // 2)


def serving_layer_counters_cached(
    arch: ModelArch, s: ParallelStrategy, dev: str, b: int,
    *, prefill: int, context: int,
) -> tuple[tuple[dict, dict], tuple[dict, dict]]:
    """((prefill comp, comm), (decode comp, comm)) per-layer op->count
    dicts, memoized per (arch, device, batch, lengths, TP-shape)."""
    key = (arch, dev, b, prefill, context) + tuple(
        getattr(s, f) for f in _SERVING_KEY_FIELDS
    )
    hit = _SERVING_LAYER_CACHE.get(key)
    if hit is None:
        if len(_SERVING_LAYER_CACHE) >= _LAYER_CACHE_MAX:
            _SERVING_LAYER_CACHE.clear()
        pcomp, pcomm = layer_fwd_ops(arch, s, dev, b, prefill)
        dcomp, dcomm = decode_layer_fwd_ops(arch, s, dev, b, context)
        hit = (
            (_counted(pcomp), _counted(pcomm)),
            (_counted(dcomp), _counted(dcomm)),
        )
        _SERVING_LAYER_CACHE[key] = hit
    return hit


def build_serving_stage_census_vec(
    arch: ModelArch,
    s: ParallelStrategy,
    stage: int,
    *,
    prefill: int,
    context: int,
    batch: int,
    device: Optional[str] = None,
    layers_in_stage: Optional[int] = None,
) -> tuple[StageCensusVec, StageCensusVec]:
    """(prefill census, decode census) for one stage at one mix batch.

    Both censuses are forward-only: no recompute surcharge and no
    once-per-step optimizer/gradient ops (serving has neither). The decode
    census is one token's work; per-request decode cost is ``decode_len``
    of these steps.
    """
    dev = device or s.device
    pp = s.pipeline_parallel
    layers = (
        layers_in_stage if layers_in_stage is not None
        else arch.num_layers // pp
    )
    b = batch
    (pcomp_cnt, pcomm_cnt), (dcomp_cnt, dcomm_cnt) = (
        serving_layer_counters_cached(
            arch, s, dev, b, prefill=prefill, context=context
        )
    )
    layers_f = float(layers)
    pre = StageCensusVec(device=dev)
    pre.fwd_comp = {op: c * layers_f for op, c in pcomp_cnt.items()}
    pre.fwd_comm = {op: c * layers_f for op, c in pcomm_cnt.items()}
    dec = StageCensusVec(device=dev)
    dec.fwd_comp = {op: c * layers_f for op, c in dcomp_cnt.items()}
    dec.fwd_comm = {op: c * layers_f for op, c in dcomm_cnt.items()}

    for census, seq_len in ((pre, prefill), (dec, 1)):
        edge_comp, edge_comm = _edge_stage_ops(
            arch, s, dev, stage, pp, b, seq_len
        )
        for op in edge_comp:
            census.fwd_comp[op] = census.fwd_comp.get(op, 0.0) + 1.0
        for op in edge_comm:
            census.fwd_comm[op] = census.fwd_comm.get(op, 0.0) + 1.0

    pre.p2p_bytes = _stage_p2p_bytes(arch, s, stage, pp, b, prefill)
    dec.p2p_bytes = _stage_p2p_bytes(arch, s, stage, pp, b, 1)
    return pre, dec


def build_serving_stage_census(
    arch: ModelArch,
    s: ParallelStrategy,
    stage: int,
    *,
    prefill: int,
    context: int,
    batch: int,
    device: Optional[str] = None,
    layers_in_stage: Optional[int] = None,
) -> tuple[StageCensus, StageCensus]:
    """List-form twin of :func:`build_serving_stage_census_vec` (the scalar
    reference simulator's input)."""
    dev = device or s.device
    pp = s.pipeline_parallel
    layers = (
        layers_in_stage if layers_in_stage is not None
        else arch.num_layers // pp
    )
    b = batch
    pcomp, pcomm = layer_fwd_ops(arch, s, dev, b, prefill)
    dcomp, dcomm = decode_layer_fwd_ops(arch, s, dev, b, context)
    pre = StageCensus(device=dev)
    pre.fwd_comp = list(pcomp) * layers
    pre.fwd_comm = list(pcomm) * layers
    dec = StageCensus(device=dev)
    dec.fwd_comp = list(dcomp) * layers
    dec.fwd_comm = list(dcomm) * layers
    for census, seq_len in ((pre, prefill), (dec, 1)):
        edge_comp, edge_comm = _edge_stage_ops(
            arch, s, dev, stage, pp, b, seq_len
        )
        census.fwd_comp += edge_comp
        census.fwd_comm += edge_comm
    pre.p2p_bytes = _stage_p2p_bytes(arch, s, stage, pp, b, prefill)
    dec.p2p_bytes = _stage_p2p_bytes(arch, s, stage, pp, b, 1)
    return pre, dec


def build_stage_census_vec(
    arch: ModelArch,
    s: ParallelStrategy,
    stage: int,
    *,
    seq: int,
    device: Optional[str] = None,
    layers_in_stage: Optional[int] = None,
) -> StageCensusVec:
    """Count-vector twin of :func:`build_stage_census`.

    The per-layer op census is computed once per distinct layer key (see
    ``layer_census_key``) and scaled by the stage's layer count, so building
    a census for strategy #4000 of a search costs a handful of dict updates
    instead of ``O(ops_per_layer * layers)`` list work.
    """
    dev = device or s.device
    pp = s.pipeline_parallel
    layers = layers_in_stage if layers_in_stage is not None else arch.num_layers // pp
    b = s.micro_batch_size

    lcomp_cnt, lcomm_cnt, lcore_cnt = layer_counters_cached(arch, s, dev, seq)
    layers_f = float(layers)
    census = StageCensusVec(device=dev)
    census.fwd_comp = {op: c * layers_f for op, c in lcomp_cnt.items()}
    census.fwd_comm = {op: c * layers_f for op, c in lcomm_cnt.items()}

    edge_comp, edge_comm = _edge_stage_ops(arch, s, dev, stage, pp, b, seq)
    for op in edge_comp:
        census.fwd_comp[op] = census.fwd_comp.get(op, 0.0) + 1.0
    for op in edge_comm:
        census.fwd_comm[op] = census.fwd_comm.get(op, 0.0) + 1.0

    if s.recompute_granularity == "full":
        n_rc = s.recompute_num_layers or layers
        mult = float(min(n_rc, layers))
        census.recompute_comp = {op: c * mult for op, c in lcomp_cnt.items()}
    elif s.recompute_granularity == "selective" and not arch.is_attention_free:
        census.recompute_comp = {op: c * layers_f for op, c in lcore_cnt.items()}

    census.step_comp, census.step_comm = step_ops_counted_cached(
        arch, s, dev, stage, layers, pp
    )

    census.p2p_bytes = _stage_p2p_bytes(arch, s, stage, pp, b, seq)
    return census
