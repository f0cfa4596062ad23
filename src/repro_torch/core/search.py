"""Search-space generator + filters (paper §3.3).

``generate_strategies`` materializes S = {s_i} = C_gpu x f(P) x M (Eq. 8-9),
then applies the rule-based filter (Eq. 10) and the memory-based filter
(Eq. 20-21) in that order, tracking counts for the paper's Table-1 metrics.

:class:`FilterBank` wraps both filters with result memoization keyed on the
exact strategy fields each filter reads, so one bank shared across the cells
of a search (e.g. mode-3's device-count sweep, or mode-2's placement grid)
evaluates each distinct filter input once instead of once per candidate.
"""
from __future__ import annotations

import dataclasses
import itertools
import operator
import os
import time
from typing import Iterable, Optional, Sequence

from repro_torch.core import wire
from repro_torch.core.arch import ModelArch
from repro_torch.core.memory import MemoryFilter
from repro_torch.core.params import GpuConfig, ParallelStrategy, default_parameter_space
from repro_torch.core.rules import DEFAULT_RULES, RuleFilter
from repro_torch.hw.catalog import get_device

#: SearchCounts wall-time fields beyond ``gen_seconds``: the per-rung split
#: (enumerate+divisibility / rule filter / memory filter / simulation).
#: Serialized sparsely — pre-split payloads are byte-identical when zero.
_TIMING_FIELDS = (
    "enumerate_seconds", "rules_seconds", "memory_seconds", "sim_seconds",
)


@dataclasses.dataclass
class SearchCounts:
    generated: int = 0  # |S| before any filter
    divisible: int = 0  # after arithmetic feasibility (GPU-division etc.)
    after_rules: int = 0
    after_memory: int = 0
    gen_seconds: float = 0.0
    # per-rung wall-time split: gen_seconds covers the whole generator
    # (enumerate + rules + memory ~ its rung sum); sim_seconds is the
    # evaluator's share of the search wall-time
    enumerate_seconds: float = 0.0
    rules_seconds: float = 0.0
    memory_seconds: float = 0.0
    sim_seconds: float = 0.0

    # -- wire format -------------------------------------------------------
    def to_dict(self) -> dict:
        d = {
            "generated": self.generated,
            "divisible": self.divisible,
            "after_rules": self.after_rules,
            "after_memory": self.after_memory,
            "gen_seconds": wire.dump_float(self.gen_seconds),
        }
        for name in _TIMING_FIELDS:
            v = getattr(self, name)
            if v != 0.0:
                d[name] = wire.dump_float(v)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SearchCounts":
        return cls(
            generated=int(d["generated"]),
            divisible=int(d["divisible"]),
            after_rules=int(d["after_rules"]),
            after_memory=int(d["after_memory"]),
            gen_seconds=wire.load_float(d["gen_seconds"]),
            **{
                name: wire.load_float(d[name])
                for name in _TIMING_FIELDS if name in d
            },
        )

    def merge(self, other: "SearchCounts") -> None:
        """Fold a disjoint shard's funnel counts in. Because round-robin
        shards partition the raw candidate space exactly and each worker
        counts only its own shard, the merged funnel equals the serial one;
        ``gen_seconds`` (and the per-rung split) sums to total generation
        CPU time across workers (not wall time)."""
        self.generated += other.generated
        self.divisible += other.divisible
        self.after_rules += other.after_rules
        self.after_memory += other.after_memory
        self.gen_seconds += other.gen_seconds
        for name in _TIMING_FIELDS:
            setattr(self, name, getattr(self, name) + getattr(other, name))

    def normalized(self) -> "SearchCounts":
        """Copy with every wall-time field zeroed — the comparator for
        "same funnel" across runs/backends (counts are exact, times vary)."""
        return dataclasses.replace(
            self, gen_seconds=0.0,
            **{name: 0.0 for name in _TIMING_FIELDS},
        )


def strategy_env(arch: ModelArch, s: ParallelStrategy) -> dict:
    """$param environment the rule DSL evaluates against."""
    env = s.to_flat_dict()
    env.update(
        num_layers=arch.num_layers,
        hidden_size=arch.hidden,
        attention_heads=arch.heads,
        intermediate_size=arch.ffn,
        vocab_size=arch.vocab,
        num_experts=arch.num_experts,
        moe_router_topk=arch.top_k,
    )
    return env


_strategy_env = strategy_env  # backwards-compat alias


# ---------------------------------------------------------------------------
# memoized filter bank
# ---------------------------------------------------------------------------

# env names the rule DSL can reference, resolved directly from the strategy
# (avoids building the full $param env on memo hits)
_STRATEGY_ENV_GETTERS: dict = {
    **{
        f.name: operator.attrgetter(f.name)
        for f in dataclasses.fields(ParallelStrategy)
        if f.name != "hetero"
    },
    "data_parallel": operator.attrgetter("data_parallel"),
    "num_gpus": operator.attrgetter("num_devices"),
    "pipeline_model_parallel_size": operator.attrgetter("pipeline_parallel"),
    "tensor_model_parallel_size": operator.attrgetter("tensor_parallel"),
    "data_model_parallel_size": operator.attrgetter("data_parallel"),
    "expert_model_parallel_size": operator.attrgetter("expert_parallel"),
}
# env names that are constant for a fixed arch (excluded from memo keys)
_ARCH_ENV_KEYS = frozenset(
    {"num_layers", "hidden_size", "attention_heads", "intermediate_size",
     "vocab_size", "num_experts", "moe_router_topk"}
)


def _referenced_vars(ast) -> set[str]:
    """All $vars a rule AST reads (normalized to env-key spelling)."""
    out: set[str] = set()

    def walk(node):
        if not isinstance(node, tuple) or not node:
            return
        if node[0] == "var":
            out.add(str(node[1]).replace("-", "_"))
            return
        for child in node[1:]:
            walk(child)

    walk(ast)
    return out


def _memory_key(s: ParallelStrategy) -> tuple:
    """Projection of a strategy onto the fields the memory model reads.

    Everything else (recompute_num_layers, virtual pipeline, the overlap
    toggles, num_devices beyond dp) provably cannot change the Eq. 20-21
    verdict, so strategies differing only there share one evaluation. The
    ZeRO data-parallel divisor only matters with the distributed optimizer,
    which is what lets non-ZeRO checks dedupe across a device-count sweep.
    """
    return (
        s.device, s.hetero, s.tensor_parallel, s.pipeline_parallel,
        s.micro_batch_size, s.sequence_parallel, s.use_flash_attn,
        s.use_distributed_optimizer, s.offload_optimizer,
        s.recompute_granularity, s.expert_parallel,
        s.data_parallel if s.use_distributed_optimizer else 0,
    )


class FilterBank:
    """Rule + memory filters with shared, memoized evaluations.

    One bank is created per search and threaded through every candidate
    stream the planner lowers a spec into, so repeated filter inputs across
    sweep counts / placement cells are evaluated exactly once. Verdicts are
    identical to the unmemoized filters by construction (the memo key is the
    full projection of the fields each filter reads).
    """

    def __init__(self, arch: ModelArch, seq: int,
                 rules: Sequence[str] = DEFAULT_RULES,
                 *, inference=None, global_batch: int | None = None):
        self.arch = arch
        self.rule_filter = RuleFilter(rules)
        # serving workloads swap the memory estimate to the KV-cache-bound
        # footprint sized at the largest request batch of the mix
        batch = None
        if inference is not None:
            batch = max(
                b for b, _ in inference.mix(global_batch or 1)
            )
        self.mem_filter = MemoryFilter(
            seq=seq, inference=inference, batch=batch
        )
        self._rule_memo: dict = {}
        self._mem_memo: dict = {}
        # resolve each referenced $var to a strategy getter; a rule set that
        # reads a name we cannot resolve falls back to unmemoized evaluation
        referenced = set()
        for r in self.rule_filter.rules:
            referenced |= _referenced_vars(r.ast)
        referenced -= _ARCH_ENV_KEYS  # constant for this bank's arch
        try:
            self._rule_getters: Optional[list] = [
                _STRATEGY_ENV_GETTERS[name] for name in sorted(referenced)
            ]
        except KeyError:
            self._rule_getters = None

    def rules_ok(self, s: ParallelStrategy) -> bool:
        if self._rule_getters is None:
            return self.rule_filter.is_valid(strategy_env(self.arch, s))
        key = tuple(g(s) for g in self._rule_getters)
        try:
            return self._rule_memo[key]
        except KeyError:
            ok = self.rule_filter.is_valid(strategy_env(self.arch, s))
            self._rule_memo[key] = ok
            return ok

    def memory_ok(self, s: ParallelStrategy) -> bool:
        key = _memory_key(s)
        try:
            return self._mem_memo[key]
        except KeyError:
            ok = self.mem_filter.is_valid(self.arch, s)
            self._mem_memo[key] = ok
            return ok


#: block-cyclic shard granularity: raw indices are dealt to workers in
#: contiguous blocks of this many candidates, round-robin. Blocks keep the
#: product space's key locality (neighboring candidates share stage-census
#: and eta-query cache keys), so per-worker caches stay nearly as effective
#: as the serial cache; cycling the blocks keeps the shards balanced. Any
#: value partitions the stream exactly and preserves global indices — it
#: tunes speed, never results.
SHARD_BLOCK = 256


def shard_owns(idx: int, shard_i: int, shard_n: int) -> bool:
    """Deterministic block-cyclic ownership of raw index ``idx``."""
    return (idx // SHARD_BLOCK) % shard_n == shard_i


def _iter_raw_indexed(
    arch: ModelArch,
    gpu: GpuConfig,
    global_batch: int,
    space: Optional[dict[str, list]] = None,
    shard: tuple[int, int] = (0, 1),
) -> Iterable[tuple[int, ParallelStrategy]]:
    """``(raw_index, strategy)`` over the unfiltered product space f(P).

    ``shard=(i, n)`` is a deterministic block-cyclic round-robin view: only
    indices with ``(idx // SHARD_BLOCK) % n == i`` are *constructed* and
    yielded (skipped indices cost one cheap tuple step, never a dataclass
    build), so N workers each own a disjoint interleaved slice whose union
    is exactly the serial stream.
    """
    shard_i, shard_n = shard
    if not (0 <= shard_i < shard_n):
        raise ValueError(f"shard index {shard_i} not in [0, {shard_n})")
    spec = get_device(gpu.device)
    space = space or default_parameter_space(
        arch, gpu.num_devices, spec.devices_per_node, global_batch
    )
    keys = list(space)
    rg_pos = keys.index("recompute_granularity") \
        if "recompute_granularity" in keys else None
    pp_pos = keys.index("pipeline_parallel") \
        if "pipeline_parallel" in keys else None
    idx = -1
    for combo in itertools.product(*(space[k] for k in keys)):
        # recompute_num_layers rides on the granularity choice
        if rg_pos is not None and combo[rg_pos] == "full":
            layers_per_stage = arch.num_layers // combo[pp_pos]
            rnl_choices = sorted({1, max(layers_per_stage // 2, 1), layers_per_stage})
        else:
            rnl_choices = [0]
        for rnl in rnl_choices:
            idx += 1
            if not shard_owns(idx, shard_i, shard_n):
                continue
            yield idx, ParallelStrategy(
                device=gpu.device,
                num_devices=gpu.num_devices,
                recompute_num_layers=rnl,
                recompute_method="uniform",
                **dict(zip(keys, combo)),
            )


def count_raw_indices(
    arch: ModelArch,
    gpu: GpuConfig,
    global_batch: int,
    space: Optional[dict[str, list]] = None,
) -> int:
    """Exact number of raw indices :func:`_iter_raw_indexed` enumerates,
    computed arithmetically (no strategies are constructed). The product
    space is separable, so the count is the base product with the
    ``recompute_granularity == "full"`` slice expanded by its per-``pp``
    ``recompute_num_layers`` fan-out — the same set expression the
    generator evaluates per combo. Backends use this to clamp worker
    fan-out (``ceil(count / SHARD_BLOCK)`` blocks exist to deal out), so a
    tiny search never forks idle workers.
    """
    spec = get_device(gpu.device)
    space = space or default_parameter_space(
        arch, gpu.num_devices, spec.devices_per_node, global_batch
    )
    sizes = {k: len(v) for k, v in space.items()}
    total = 1
    for n in sizes.values():
        total *= n
    if total == 0:
        return 0
    rg = space.get("recompute_granularity")
    if rg is None:
        return total  # rnl_choices is always [0]: one index per combo
    n_full = sum(1 for g in rg if g == "full")
    per_rg = total // sizes["recompute_granularity"]  # combos per rg value
    count = per_rg * (sizes["recompute_granularity"] - n_full)
    if not n_full:
        return count
    pps = space.get("pipeline_parallel")
    if pps is None:
        # the generator indexes rnl choices off combo's pp; without a pp
        # axis it cannot enumerate "full" combos at all (it would raise) —
        # bound by the maximum fan-out so a clamp stays safe
        return count + per_rg * n_full * 3
    per_rg_pp = per_rg // sizes["pipeline_parallel"]
    for pp in pps:
        layers_per_stage = arch.num_layers // pp
        rnl = len({1, max(layers_per_stage // 2, 1), layers_per_stage})
        count += n_full * per_rg_pp * rnl
    return count


def iter_raw_strategies(
    arch: ModelArch,
    gpu: GpuConfig,
    global_batch: int,
    space: Optional[dict[str, list]] = None,
) -> Iterable[ParallelStrategy]:
    """The unfiltered product space f(P) for one GPU configuration."""
    for _, s in _iter_raw_indexed(arch, gpu, global_batch, space):
        yield s


def _scalar_funnel_indexed(
    arch: ModelArch,
    gpu: GpuConfig,
    global_batch: int,
    bank: FilterBank,
    counts: SearchCounts,
    space: Optional[dict[str, list]] = None,
    shard: tuple[int, int] = (0, 1),
) -> Iterable[tuple[int, ParallelStrategy]]:
    """Reference per-candidate funnel for one GPU config (the oracle the
    columnar path in :mod:`repro_torch.core.funnel` must match byte-for-byte).
    Accrues the per-rung wall-time split into ``counts``, flushing even
    when the consumer abandons the generator early."""
    en = ru = me = 0.0
    t_mark = time.perf_counter()
    try:
        for idx, s in _iter_raw_indexed(
            arch, gpu, global_batch, space=space, shard=shard
        ):
            counts.generated += 1
            div = s.is_divisible(arch, global_batch)
            t1 = time.perf_counter()
            en += t1 - t_mark
            t_mark = t1
            if not div:
                continue
            counts.divisible += 1
            ok = bank.rules_ok(s)
            t1 = time.perf_counter()
            ru += t1 - t_mark
            t_mark = t1
            if not ok:
                continue
            counts.after_rules += 1
            ok = bank.memory_ok(s)
            t1 = time.perf_counter()
            me += t1 - t_mark
            t_mark = t1
            if not ok:
                continue
            counts.after_memory += 1
            yield idx, s
            t_mark = time.perf_counter()
    finally:
        counts.enumerate_seconds += en
        counts.rules_seconds += ru
        counts.memory_seconds += me


def _use_vectorized(vectorize: Optional[bool]) -> bool:
    if vectorize is None:
        return os.environ.get("ASTRA_SCALAR_FUNNEL", "") != "1"
    return bool(vectorize)


def iter_valid_strategies(
    arch: ModelArch,
    gpus: Sequence[GpuConfig],
    global_batch: int,
    seq: int,
    *,
    rules: Sequence[str] = DEFAULT_RULES,
    space: Optional[dict[str, list]] = None,
    counts: Optional[SearchCounts] = None,
    filters: Optional[FilterBank] = None,
    shard: tuple[int, int] = (0, 1),
    indexed: bool = False,
    inference=None,
    vectorize: Optional[bool] = None,
) -> Iterable[ParallelStrategy]:
    """Streaming S_valid (Eq. 21): yields survivors of the full filter
    funnel while mutating ``counts`` in place. The batched engine consumes
    this lazily so mode-3's device-count sweep never holds the whole valid
    set in memory; ``generate_strategies`` is the materializing wrapper.

    Pass a shared :class:`FilterBank` as ``filters`` to reuse memoized
    rule/memory verdicts across several streams of one search (``rules`` is
    ignored then — the bank carries its own rule set).

    ``shard=(i, n)`` restricts the stream to the i-th round-robin slice of
    each GPU config's raw space (see :func:`_iter_raw_indexed`); ``counts``
    then tallies only this shard's funnel, so per-worker counts merged with
    :meth:`SearchCounts.merge` reproduce the serial funnel exactly.
    ``indexed=True`` yields ``((gpu_idx, raw_idx), strategy)`` pairs — the
    stream position tuple the mergeable collectors tie-break on.

    ``vectorize`` selects the funnel implementation: ``True`` runs the
    columnar block funnel (:mod:`repro_torch.core.funnel`) wherever it is exact
    and falls back per GPU config otherwise; ``False`` forces the scalar
    reference path; ``None`` (default) vectorizes unless the
    ``ASTRA_SCALAR_FUNNEL=1`` environment knob is set. Both paths produce
    identical candidates, indices, and counts — the knob trades speed only.
    A consumer that stops mid-stream (``max_candidates``) must use the
    scalar path: the columnar funnel tallies counts a whole block at a
    time."""
    from repro_torch.core import funnel

    bank = filters if filters is not None else FilterBank(
        arch, seq, rules, inference=inference, global_batch=global_batch
    )
    if counts is None:
        counts = SearchCounts()
    use_vec = _use_vectorized(vectorize)
    for g, gpu in enumerate(gpus):
        it = None
        if use_vec:
            sp = funnel.resolve_space(arch, gpu, global_batch, space)
            if funnel.can_vectorize(sp):
                it = funnel.iter_funnel_indexed(
                    arch, gpu, global_batch, bank, counts,
                    space=sp, shard=shard,
                )
        if it is None:
            it = _scalar_funnel_indexed(
                arch, gpu, global_batch, bank, counts,
                space=space, shard=shard,
            )
        for idx, s in it:
            yield ((g, idx), s) if indexed else s


def generate_strategies(
    arch: ModelArch,
    gpus: Sequence[GpuConfig],
    global_batch: int,
    seq: int,
    *,
    rules: Sequence[str] = DEFAULT_RULES,
    space: Optional[dict[str, list]] = None,
) -> tuple[list[ParallelStrategy], SearchCounts]:
    """S_valid (Eq. 21) plus the funnel counts."""
    t0 = time.perf_counter()
    counts = SearchCounts()
    valid = list(
        iter_valid_strategies(
            arch, gpus, global_batch, seq, rules=rules, space=space, counts=counts
        )
    )
    counts.gen_seconds = time.perf_counter() - t0
    return valid, counts
