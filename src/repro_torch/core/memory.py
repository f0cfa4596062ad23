"""Memory-based filter (paper §3.3, Eq. 20-21).

Per-stage memory M_i(s_j) is estimated from the empirical single-layer
formula family the paper describes: a function of microbatch size, sequence
length, hidden/FFN size, TP/PP, attention heads, and the flash-attention /
selective-recompute / sequence-parallel toggles. The activation part follows
Korthikanti et al. 2022 ("Reducing Activation Recomputation in Large
Transformer Models"), which is what Megatron itself implements:

  per-layer activation bytes (bf16), microbatch b, seq s, hidden h, heads a:
    no SP:            s*b*h * (10 + 24/t + 5*a*s/(h*t))
    sequence parallel: s*b*h * (34/t + 5*a*s/(h*t))
    flash-attn / selective recompute drops the 5*a*s/(h*t) score term
    full recompute keeps only the 2*s*b*h layer input
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.arch import ModelArch
from repro_torch.core.params import ParallelStrategy
from repro_torch.hw.catalog import get_device

BF16 = 2
FP32 = 4
# Adam: fp32 master copy + exp_avg + exp_avg_sq
OPTIMIZER_BYTES_PER_PARAM = 3 * FP32
GRAD_BYTES_PER_PARAM = FP32  # Megatron keeps fp32 main grads
_RESERVED_BYTES = 1.2e9  # runtime/context/workspace reservation
_FRAGMENTATION = 1.10


@dataclasses.dataclass(frozen=True)
class StageMemory:
    weights: float
    grads: float
    optimizer: float
    activations: float
    kv_or_state: float = 0.0

    @property
    def total(self) -> float:
        return (
            self.weights + self.grads + self.optimizer + self.activations
        ) * _FRAGMENTATION + self.kv_or_state + _RESERVED_BYTES


def activation_bytes_per_layer(
    arch: ModelArch, strategy: ParallelStrategy, micro_batch: int, seq: int
) -> float:
    """Single-layer activation footprint for one in-flight microbatch."""
    s, b, h, a = seq, micro_batch, arch.hidden, arch.heads
    t = strategy.tensor_parallel
    sbh = float(s) * b * h
    if strategy.recompute_granularity == "full":
        return 2.0 * sbh  # only the layer input is saved

    score_term = 0.0
    if not arch.is_attention_free:
        if not (strategy.use_flash_attn or strategy.recompute_granularity == "selective"):
            score_term = 5.0 * a * s / (h * t)
    if strategy.sequence_parallel:
        base = 34.0 / t
    else:
        base = 10.0 + 24.0 / t
    ffn_scale = 1.0
    if arch.family == "moe":
        # top_k expert activations instead of one dense MLP (dropless routing)
        ffn_scale = 1.0 + 0.6 * (arch.top_k - 1)
    if arch.family in ("ssm", "hybrid"):
        # conv + gate + state activations: ~expand x the hidden stream
        base += 8.0 * arch.ssm_expand / t
    return sbh * (base * ffn_scale + score_term)


def stage_parameter_count(
    arch: ModelArch, strategy: ParallelStrategy, stage: int, layers_in_stage: int
) -> float:
    """Parameters held by one (pp-stage, tp-rank, ep-rank) device."""
    t, ep = strategy.tensor_parallel, strategy.expert_parallel
    per_layer = arch.layer_params()
    n = 0.0
    for name, count in per_layer.items():
        if name == "moe_experts":
            n += count / (ep * t)
        elif name == "norms":
            n += count  # norms are replicated across tp
        else:
            n += count / t
    n *= layers_in_stage
    pp = strategy.pipeline_parallel
    if stage == 0:
        n += arch.vocab * arch.hidden / t
    if stage == pp - 1:
        n += (0 if arch.tie_embeddings and pp == 1 else arch.vocab * arch.hidden / t)
        n += arch.hidden  # final norm
    return n


def stage_memory(
    arch: ModelArch,
    strategy: ParallelStrategy,
    stage: int,
    *,
    seq: int,
    layers_in_stage: int | None = None,
) -> StageMemory:
    pp = strategy.pipeline_parallel
    layers = layers_in_stage if layers_in_stage is not None else arch.num_layers // pp
    params = stage_parameter_count(arch, strategy, stage, layers)

    weights = params * BF16
    grads = params * GRAD_BYTES_PER_PARAM
    opt = params * OPTIMIZER_BYTES_PER_PARAM
    if strategy.use_distributed_optimizer:
        opt /= strategy.data_parallel
    if strategy.offload_optimizer:
        opt = 0.0

    act_per_mb = activation_bytes_per_layer(
        arch, strategy, strategy.micro_batch_size, seq
    ) * layers
    # 1F1B: stage i holds up to (pp - i) in-flight microbatches
    in_flight = pp - stage
    activations = act_per_mb * in_flight
    return StageMemory(weights=weights, grads=grads, optimizer=opt, activations=activations)


def peak_stage_memory(
    arch: ModelArch, strategy: ParallelStrategy, *, seq: int
) -> tuple[float, int]:
    """(max over stages of M_i, argmax stage)."""
    worst, worst_stage = 0.0, 0
    for i in range(strategy.pipeline_parallel):
        m = stage_memory(arch, strategy, i, seq=seq).total
        if m > worst:
            worst, worst_stage = m, i
    return worst, worst_stage


def kv_state_bytes_per_layer(
    arch: ModelArch, strategy: ParallelStrategy, batch: int, context: int
) -> float:
    """Per-layer per-device KV-cache (attention) / state (SSM) bytes for
    ``batch`` concurrent requests at ``context`` tokens."""
    t = strategy.tensor_parallel
    total = 0.0
    if not arch.is_attention_free:
        kv_dim = 2.0 * arch.attn_kv_dim / min(t, arch.kv_heads)
        total += BF16 * batch * context * kv_dim
    if arch.family in ("ssm", "hybrid"):
        d_inner = arch.ssm_expand * arch.hidden
        total += BF16 * batch * (d_inner / t) * arch.ssm_state
    return total


def serving_stage_memory(
    arch: ModelArch,
    strategy: ParallelStrategy,
    stage: int,
    *,
    prefill: int,
    decode_len: int,
    batch: int,
    layers_in_stage: int | None = None,
) -> StageMemory:
    """Serving footprint of one stage: weights + KV cache at the *peak*
    context (``prefill + decode_len``) + one transient prefill working set.
    No gradients, optimizer states, or saved activations — inference keeps
    nothing for a backward pass."""
    pp = strategy.pipeline_parallel
    layers = (
        layers_in_stage if layers_in_stage is not None
        else arch.num_layers // pp
    )
    params = stage_parameter_count(arch, strategy, stage, layers)
    kv = kv_state_bytes_per_layer(
        arch, strategy, batch, prefill + decode_len
    ) * layers
    # transient working set of the dense prompt forward (one layer's input
    # stream; nothing is retained across layers without a backward pass)
    act = 2.0 * float(prefill) * batch * arch.hidden
    return StageMemory(
        weights=params * BF16, grads=0.0, optimizer=0.0,
        activations=act, kv_or_state=kv,
    )


class MemoryFilter:
    """Eq. 20-21: drop s_j if any stage exceeds the device's HBM.

    With ``inference`` set (plus ``batch``, the largest request batch of
    the workload mix) the per-stage estimate switches to the serving
    footprint — weights + peak-context KV cache instead of the training
    activations/optimizer terms."""

    def __init__(self, seq: int, *, inference=None, batch: int | None = None):
        self.seq = seq
        self.inference = inference
        self.batch = batch

    def _stage_total(
        self, arch: ModelArch, strategy: ParallelStrategy, stage: int,
        layers_in_stage: int | None = None,
    ) -> float:
        if self.inference is not None:
            return serving_stage_memory(
                arch, strategy, stage,
                prefill=self.inference.prefill_len,
                decode_len=self.inference.decode_len,
                batch=self.batch if self.batch is not None else 1,
                layers_in_stage=layers_in_stage,
            ).total
        return stage_memory(
            arch, strategy, stage, seq=self.seq,
            layers_in_stage=layers_in_stage,
        ).total

    def block_valid(
        self,
        arch: ModelArch,
        *,
        device: str,
        tp: np.ndarray,
        pp: np.ndarray,
        mbs: np.ndarray,
        ep: np.ndarray,
        dp: np.ndarray,
        sp: np.ndarray,
        flash: np.ndarray,
        zero: np.ndarray,
        offload: np.ndarray,
        rg_full: np.ndarray,
        rg_sel: np.ndarray,
    ) -> "np.ndarray | None":
        """Vectorized :meth:`is_valid` over a block of homogeneous training
        candidates (one device, ``hetero is None``, ``num_layers % pp == 0``
        already established by the divisibility rung).

        Every arithmetic step replays :func:`stage_memory` /
        :func:`activation_bytes_per_layer` with the same float64 operation
        order, so verdicts are bit-identical to the scalar filter. The
        per-stage maximum collapses to ``max(stage 0, stage pp-1)``:
        middle stages hold strictly fewer parameters than stage 0 (no
        embedding) and fewer in-flight microbatches, so they never set the
        peak. Returns ``None`` for serving workloads (the scalar filter
        owns that path).
        """
        if self.inference is not None:
            return None
        cap = get_device(device).mem_bytes
        seq = self.seq

        # per-(tp, ep) layer-parameter shard via the *scalar* accumulation
        # loop (same float add order as stage_parameter_count)
        per_layer = arch.layer_params()

        def shard_of(t: int, e: int) -> float:
            n = 0.0
            for name, count in per_layer.items():
                if name == "moe_experts":
                    n += count / (e * t)
                elif name == "norms":
                    n += count
                else:
                    n += count / t
            return n

        pair = tp * (int(ep.max()) + 1) + ep
        uniq, first, inv = np.unique(
            pair, return_index=True, return_inverse=True
        )
        inv = np.asarray(inv).reshape(-1)
        table = np.empty(len(uniq), dtype=np.float64)
        for u, i in enumerate(first):
            table[u] = shard_of(int(tp[i]), int(ep[i]))
        shard = table.take(inv)

        layers = arch.num_layers // pp
        base_params = shard * layers
        vh_t = (arch.vocab * arch.hidden) / tp

        # activation_bytes_per_layer, same op order per lane
        sbh = float(seq) * mbs * arch.hidden
        if arch.is_attention_free:
            score = 0.0
        else:
            score = np.where(
                flash | rg_sel, 0.0, 5.0 * arch.heads * seq / (arch.hidden * tp)
            )
        base = np.where(sp, 34.0 / tp, 10.0 + 24.0 / tp)
        ffn_scale = 1.0
        if arch.family == "moe":
            ffn_scale = 1.0 + 0.6 * (arch.top_k - 1)
        if arch.family in ("ssm", "hybrid"):
            base = base + 8.0 * arch.ssm_expand / tp
        act_layer = np.where(rg_full, 2.0 * sbh, sbh * (base * ffn_scale + score))
        act_per_mb = act_layer * layers

        def stage_total(params: np.ndarray, in_flight) -> np.ndarray:
            weights = params * BF16
            grads = params * GRAD_BYTES_PER_PARAM
            opt = params * OPTIMIZER_BYTES_PER_PARAM
            opt = np.where(zero, opt / np.maximum(dp, 1), opt)
            opt = np.where(offload, 0.0, opt)
            activations = act_per_mb * in_flight
            return (
                (weights + grads + opt + activations) * _FRAGMENTATION
                + 0.0 + _RESERVED_BYTES
            )

        # stage 0 of a pp>1 pipeline: embedding only
        t_first = stage_total(base_params + vh_t, pp)
        # stage pp-1 of a pp>1 pipeline: output embedding + final norm
        # (tie_embeddings only elides it when pp == 1)
        t_last = stage_total((base_params + vh_t) + arch.hidden, 1)
        # pp == 1: the single stage carries both ends
        tie = arch.tie_embeddings
        p_single = (
            (base_params + vh_t) + (0.0 if tie else vh_t)
        ) + arch.hidden
        t_single = stage_total(p_single, 1)

        worst = np.where(pp == 1, t_single, np.maximum(t_first, t_last))
        return worst <= cap

    def is_valid(self, arch: ModelArch, strategy: ParallelStrategy) -> bool:
        cap = get_device(strategy.device).mem_bytes
        if strategy.hetero is not None:
            for stage, (dev, n_layers) in enumerate(strategy.hetero.stage_sequence()):
                m = self._stage_total(
                    arch,
                    dataclasses.replace(strategy, device=dev,
                                        pipeline_parallel=strategy.hetero.pp),
                    stage,
                    layers_in_stage=n_layers,
                )
                if m > get_device(dev).mem_bytes:
                    return False
            return True
        worst = 0.0
        for i in range(strategy.pipeline_parallel):
            worst = max(worst, self._stage_total(arch, strategy, i))
        return worst <= cap
