"""Columnar cold-search funnel: block enumeration + vectorized filters.

The scalar funnel (:func:`repro_torch.core.search.iter_valid_strategies`) builds
one :class:`~repro_torch.core.params.ParallelStrategy` dataclass per raw candidate
and walks it through ``is_divisible`` -> rules -> memory one at a time. For
a cold search the front half of that funnel — enumeration plus the two
cheap filters — dominates wall time, and every step of it is data-parallel
arithmetic over a separable product space.

This module evaluates the same funnel **columnar**, in fixed-size blocks:

* the raw space is never materialized — a candidate is a *raw index* into
  the mixed-radix product space (with the ``recompute_granularity ==
  "full"`` slice fanned out by its per-``pp`` ``recompute_num_layers``
  choices, exactly like the scalar generator), decoded per block into
  struct-of-arrays value-index columns;
* ``is_divisible`` is one boolean mask over the block;
* rules evaluate as compiled block masks
  (:meth:`~repro_torch.core.rules.RuleFilter.block_violations`), falling back to
  the per-candidate interpreter only for rules that cannot be faithfully
  vectorized;
* the memory filter runs once per *distinct memory projection* in the
  block (``np.unique`` over the projected code columns) through the shared
  memoized :class:`~repro_torch.core.search.FilterBank`, then broadcasts;
* ``ParallelStrategy`` objects are built **only for survivors**, from the
  original Python values of the space lists (no numpy scalars leak into
  dataclasses or wire dicts).

Raw indices are identical to the scalar generator's, so block-cyclic
``shard(i, n)`` views, funnel counts, and ``seq`` tie-break tuples are
byte-identical to the scalar path — the vectorized funnel is a pure speed
substitution, never a result change. :func:`can_vectorize` gates the cases
where only the scalar path has the right (possibly crashing) semantics.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional

import numpy as np

from repro_torch.core.arch import ModelArch
from repro_torch.core.params import (
    GpuConfig,
    ParallelStrategy,
    default_parameter_space,
)
from repro_torch.core.rules import CategoricalColumn
from repro_torch.hw.catalog import get_device

#: how many SHARD_BLOCK-sized blocks one decoded batch spans (~8k candidates:
#: large enough to amortize per-batch numpy overhead, small enough that the
#: dozen int64 columns stay cache-resident)
BATCH_BLOCKS = 32

_FIELD_DEFAULTS = {
    f.name: f.default
    for f in dataclasses.fields(ParallelStrategy)
    if f.name != "hetero"
}

#: space keys the vectorized path can enumerate: exactly the constructor
#: kwargs the scalar generator forwards from the space (anything else makes
#: the scalar path raise — the fallback must own those semantics)
_SPACE_FIELDS = frozenset(_FIELD_DEFAULTS) - {
    "device", "num_devices", "recompute_num_layers", "recompute_method"
}

#: strategy fields ``is_divisible`` reads as integers
_DIV_KEYS = (
    "pipeline_parallel", "tensor_parallel", "expert_parallel",
    "micro_batch_size", "virtual_pipeline_stages",
)

#: space keys in the memory filter's projection (:func:`search._memory_key`);
#: ``data_parallel if use_distributed_optimizer`` is a function of the
#: pp/tp/zero codes (num_devices is fixed per plan), so code-identical rows
#: share one memory verdict
_MEMORY_KEYS = (
    "tensor_parallel", "pipeline_parallel", "micro_batch_size",
    "sequence_parallel", "use_flash_attn", "use_distributed_optimizer",
    "offload_optimizer", "recompute_granularity", "expert_parallel",
)

_ARCH_ENV = (
    ("num_layers", "num_layers"), ("hidden_size", "hidden"),
    ("attention_heads", "heads"), ("intermediate_size", "ffn"),
    ("vocab_size", "vocab"), ("num_experts", "num_experts"),
    ("moe_router_topk", "top_k"),
)


def resolve_space(
    arch: ModelArch,
    gpu: GpuConfig,
    global_batch: int,
    space: Optional[dict] = None,
) -> dict:
    """The effective parameter space for one GPU config (the same default
    the scalar generator builds when none is given)."""
    if space is not None:
        return space
    spec = get_device(gpu.device)
    return default_parameter_space(
        arch, gpu.num_devices, spec.devices_per_node, global_batch
    )


def can_vectorize(space: dict) -> bool:
    """True when the columnar funnel reproduces the scalar generator for
    this space — including its crashes. Anything outside this envelope
    (unknown strategy fields, ``"full"`` recompute without a ``pp`` axis,
    non-positive or non-integer parallel sizes) keeps the scalar path,
    which owns those semantics (usually a raise)."""
    for k in space:
        if k not in _SPACE_FIELDS:
            return False
    rg = space.get("recompute_granularity")
    if rg is not None and any(v == "full" for v in rg) \
            and "pipeline_parallel" not in space:
        return False
    for k in _DIV_KEYS:
        for v in space.get(k, ()):
            if not isinstance(v, int) or v < 1:
                return False
    return True


class _GpuPlan:
    """Per-GpuConfig decode tables for the mixed-radix raw-index space."""

    def __init__(self, arch: ModelArch, gpu: GpuConfig, global_batch: int,
                 space: dict):
        self.arch = arch
        self.gpu = gpu
        self.global_batch = global_batch
        self.space = space
        self.keys = keys = list(space)
        self.sizes = sizes = [len(space[k]) for k in keys]
        strides = [1] * len(keys)
        acc = 1
        # itertools.product varies the LAST key fastest
        for j in range(len(keys) - 1, -1, -1):
            strides[j] = acc
            acc *= sizes[j]
        self.strides = strides
        self.n_combos = acc

        # per-key value tables: numeric columns gather through them, any
        # other value type goes through a CategoricalColumn code table
        self.cols: dict = {}
        for k in keys:
            vals = space[k]
            try:
                a = np.asarray(vals)
            except (ValueError, TypeError):
                a = None
            if a is not None and a.ndim == 1 and a.dtype.kind in "biuf":
                self.cols[k] = ("num", a)
            else:
                self.cols[k] = ("cat", tuple(vals))

        self.div_vals = {
            k: np.asarray(space[k], dtype=np.int64)
            for k in _DIV_KEYS if k in space
        }
        self.mem_keys = [k for k in _MEMORY_KEYS if k in space]
        # per-key truthiness tables (the scalar filters branch on
        # ``if strategy.<flag>:`` — truthiness, not identity, is what
        # must survive vectorization for arbitrary space value types)
        self.truthy = {
            k: np.fromiter((bool(v) for v in space[k]), bool, len(space[k]))
            for k in (
                "sequence_parallel", "use_flash_attn",
                "use_distributed_optimizer", "offload_optimizer",
            ) if k in space
        }
        rg = space.get("recompute_granularity")
        self.rg_full_lut = (
            np.fromiter((v == "full" for v in rg), bool, len(rg))
            if rg is not None else None
        )
        self.rg_sel_lut = (
            np.fromiter((v == "selective" for v in rg), bool, len(rg))
            if rg is not None else None
        )

        # recompute_num_layers fan-out: fan == 1 except where the combo's
        # recompute_granularity is "full", where it is the size of the
        # scalar generator's per-pp rnl choice set
        self.uniform = True
        self.total = self.n_combos
        rg_vals = space.get("recompute_granularity")
        if self.n_combos and rg_vals is not None \
                and any(v == "full" for v in rg_vals):
            self.uniform = False
            self.is_full = np.array([v == "full" for v in rg_vals], bool)
            pp_vals = space["pipeline_parallel"]
            rnl_lists = []
            for pp in pp_vals:
                lps = arch.num_layers // pp
                rnl_lists.append(sorted({1, max(lps // 2, 1), lps}))
            width = max(len(r) for r in rnl_lists)
            self.rnl_table = np.zeros((len(pp_vals), width), dtype=np.int64)
            rnl_count = np.ones(len(pp_vals), dtype=np.int64)
            for i, r in enumerate(rnl_lists):
                self.rnl_table[i, : len(r)] = r
                rnl_count[i] = len(r)
            combos = np.arange(self.n_combos, dtype=np.int64)
            rg_j = keys.index("recompute_granularity")
            pp_j = keys.index("pipeline_parallel")
            rg_vi = (combos // strides[rg_j]) % sizes[rg_j]
            pp_vi = (combos // strides[pp_j]) % sizes[pp_j]
            self.fan = np.where(
                self.is_full.take(rg_vi), rnl_count.take(pp_vi), 1
            ).astype(np.int64)
            self.cumfan = np.cumsum(self.fan)
            self.total = int(self.cumfan[-1])

        # block-constant env entries: strategy-field defaults, the GPU cell,
        # and the arch constants the rule DSL can reference
        base = dict(_FIELD_DEFAULTS)
        base["device"] = gpu.device
        base["num_devices"] = gpu.num_devices
        base["recompute_method"] = "uniform"
        # prototype field dict for the fast materializer (every
        # ParallelStrategy field present; per-candidate keys overwritten)
        self.proto = dict(base)
        self.proto["hetero"] = None
        base["num_gpus"] = gpu.num_devices
        for env_name, attr in _ARCH_ENV:
            base[env_name] = getattr(arch, attr)
        self.base_env = base

    # -- per-batch stages ---------------------------------------------------
    def decode(self, idx: np.ndarray) -> tuple[dict, np.ndarray]:
        """Raw indices -> per-key value-index columns + rnl column."""
        if self.uniform:
            combo = idx
            rnl = np.zeros(len(idx), dtype=np.int64)
        else:
            combo = np.searchsorted(self.cumfan, idx, side="right")
            rnl_pos = idx - (self.cumfan.take(combo) - self.fan.take(combo))
        vi = {
            k: (combo // stride) % size
            for k, stride, size in zip(self.keys, self.strides, self.sizes)
        }
        if not self.uniform:
            full = self.is_full.take(vi["recompute_granularity"])
            rnl = np.where(
                full, self.rnl_table[vi["pipeline_parallel"], rnl_pos], 0
            )
        return vi, rnl

    def _div_col(self, vi: dict, key: str, m: int) -> np.ndarray:
        vals = self.div_vals.get(key)
        if vals is None:
            return np.full(m, _FIELD_DEFAULTS[key], dtype=np.int64)
        return vals.take(vi[key])

    def divisible_mask(self, vi: dict, m: int) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized ``ParallelStrategy.is_divisible``; returns (mask, dp)."""
        arch, nd = self.arch, self.gpu.num_devices
        pp = self._div_col(vi, "pipeline_parallel", m)
        tp = self._div_col(vi, "tensor_parallel", m)
        ep = self._div_col(vi, "expert_parallel", m)
        mbs = self._div_col(vi, "micro_batch_size", m)
        vp = self._div_col(vi, "virtual_pipeline_stages", m)
        pptp = pp * tp
        ok = (nd % pptp) == 0
        dp = nd // pptp
        ok &= dp >= 1
        # dp >= 1 rows have a positive divisor; the guard only silences
        # the dead dp == 0 lanes (already masked out)
        ok &= (self.global_batch % np.maximum(dp * mbs, 1)) == 0
        ok &= (arch.num_layers % pp) == 0
        lps = arch.num_layers // pp
        ok &= (vp <= 1) | ((lps % vp) == 0)
        if not arch.is_attention_free:
            ok &= (arch.heads % tp) == 0
            kv = arch.kv_heads
            if kv:
                ok &= ((kv % tp) == 0) | ((tp % kv) == 0)
        if arch.ffn:
            ok &= (arch.ffn % tp) == 0
        if arch.family in ("ssm", "hybrid"):
            d_inner = arch.ssm_expand * arch.hidden
            nheads = arch.ssm_heads or max(d_inner // 64, 1)
            ok &= (nheads % tp) == 0
        if arch.family == "moe":
            safe_ep = np.maximum(ep, 1)
            ok &= (ep <= 1) | (
                ((arch.num_experts % safe_ep) == 0) & ((dp % safe_ep) == 0)
            )
        else:
            ok &= ep == 1
        return ok, dp

    def rule_env(self, vi: dict, rnl: np.ndarray, dp: np.ndarray) -> dict:
        """$param block environment: columns for space-varying names,
        Python scalars for block constants — the vectorized twin of
        :func:`repro_torch.core.search.strategy_env`."""
        env = dict(self.base_env)
        for k in self.keys:
            kind, vals = self.cols[k]
            env[k] = (
                vals.take(vi[k]) if kind == "num"
                else CategoricalColumn(vals, vi[k])
            )
        env["recompute_num_layers"] = rnl
        env["data_parallel"] = dp
        env["data_model_parallel_size"] = dp
        env["pipeline_model_parallel_size"] = env["pipeline_parallel"]
        env["tensor_model_parallel_size"] = env["tensor_parallel"]
        env["expert_model_parallel_size"] = env["expert_parallel"]
        return env

    def strategy_at(self, vi: dict, rnl: np.ndarray, p: int) -> ParallelStrategy:
        """Materialize candidate ``p`` of the batch from the *original*
        Python values of the space lists (wire-exact: no numpy types)."""
        kw = {k: self.space[k][int(vi[k][p])] for k in self.keys}
        return ParallelStrategy(
            device=self.gpu.device,
            num_devices=self.gpu.num_devices,
            recompute_num_layers=int(rnl[p]),
            recompute_method="uniform",
            **kw,
        )

    def strategies_at(
        self, vi: dict, rnl: np.ndarray, positions: np.ndarray
    ) -> list[ParallelStrategy]:
        """Batch materializer for survivors: builds the complete field dict
        and installs it directly (``ParallelStrategy`` is a plain frozen
        dataclass — no ``__post_init__``, no ``__slots__`` — so bypassing
        the per-field ``object.__setattr__`` walk of the frozen ``__init__``
        yields identical instances several times faster). Values come from
        the original space lists, so nothing numpy-typed leaks out."""
        proto, keys, space = self.proto, self.keys, self.space
        new = ParallelStrategy.__new__
        cls = ParallelStrategy
        out = []
        for p in positions:
            p = int(p)
            d = dict(proto)
            for k in keys:
                d[k] = space[k][int(vi[k][p])]
            d["recompute_num_layers"] = int(rnl[p])
            s = new(cls)
            s.__dict__.update(d)
            out.append(s)
        return out

    def _bool_col(self, vi: dict, key: str, m: int) -> np.ndarray:
        lut = self.truthy.get(key)
        if lut is None:
            return np.full(m, bool(_FIELD_DEFAULTS[key]))
        return lut.take(vi[key])

    def memory_keep(
        self, vi: dict, rnl: np.ndarray, dp: np.ndarray, bank, m: int
    ) -> np.ndarray:
        """Memory-filter mask over the batch.

        Training candidates go through the fully vectorized
        :meth:`MemoryFilter.block_valid` (bit-identical float replay of the
        scalar estimator). Serving workloads — where only the scalar filter
        has the estimate — dedupe to one memoized
        :meth:`FilterBank.memory_ok` call per distinct memory projection
        and broadcast the verdicts back."""
        if self.rg_full_lut is not None:
            rg_vi = vi["recompute_granularity"]
            rg_full = self.rg_full_lut.take(rg_vi)
            rg_sel = self.rg_sel_lut.take(rg_vi)
        else:
            dflt = _FIELD_DEFAULTS["recompute_granularity"]
            rg_full = np.full(m, dflt == "full")
            rg_sel = np.full(m, dflt == "selective")
        keep = bank.mem_filter.block_valid(
            self.arch,
            device=self.gpu.device,
            tp=self._div_col(vi, "tensor_parallel", m),
            pp=self._div_col(vi, "pipeline_parallel", m),
            mbs=self._div_col(vi, "micro_batch_size", m),
            ep=self._div_col(vi, "expert_parallel", m),
            dp=dp,
            sp=self._bool_col(vi, "sequence_parallel", m),
            flash=self._bool_col(vi, "use_flash_attn", m),
            zero=self._bool_col(vi, "use_distributed_optimizer", m),
            offload=self._bool_col(vi, "offload_optimizer", m),
            rg_full=rg_full,
            rg_sel=rg_sel,
        )
        if keep is not None:
            return keep
        return self._memory_keep_memoized(vi, rnl, bank, m)

    def _memory_keep_memoized(
        self, vi: dict, rnl: np.ndarray, bank, m: int
    ) -> np.ndarray:
        cols = [vi[k] for k in self.mem_keys]
        if cols:
            mat = np.stack(cols, axis=1)
            _, first, inv = np.unique(
                mat, axis=0, return_index=True, return_inverse=True
            )
            inv = np.asarray(inv).reshape(-1)  # numpy 2.0 shape quirk
        else:
            first = np.zeros(1, dtype=np.int64)
            inv = np.zeros(m, dtype=np.int64)
        verdicts = np.empty(len(first), dtype=bool)
        for u, fi in enumerate(first):
            verdicts[u] = bank.memory_ok(self.strategy_at(vi, rnl, int(fi)))
        return verdicts.take(inv)


def _take_all(vi: dict, sel: np.ndarray) -> dict:
    return {k: v.take(sel) for k, v in vi.items()}


def iter_funnel_indexed(
    arch: ModelArch,
    gpu: GpuConfig,
    global_batch: int,
    bank,
    counts,
    space: Optional[dict] = None,
    shard: tuple[int, int] = (0, 1),
) -> Iterable[tuple[int, ParallelStrategy]]:
    """Columnar ``(raw_index, strategy)`` funnel for one GPU config.

    Byte-identical to the scalar funnel over the same inputs: same raw
    indices, same survivors in the same order, same ``counts`` tallies.
    Per-rung wall time accrues into ``counts.enumerate_seconds`` /
    ``rules_seconds`` / ``memory_seconds`` (flushed even when the consumer
    abandons the generator early).
    """
    from repro_torch.core.search import SHARD_BLOCK, strategy_env

    shard_i, shard_n = shard
    if not (0 <= shard_i < shard_n):
        raise ValueError(f"shard index {shard_i} not in [0, {shard_n})")
    plan = _GpuPlan(
        arch, gpu, global_batch,
        resolve_space(arch, gpu, global_batch, space),
    )
    total = plan.total
    n_blocks = -(-total // SHARD_BLOCK)
    owned = range(shard_i, n_blocks, shard_n)
    offsets = np.arange(SHARD_BLOCK, dtype=np.int64)
    rule_filter = bank.rule_filter
    en = ru = me = 0.0
    try:
        for c0 in range(0, len(owned), BATCH_BLOCKS):
            ks = np.asarray(owned[c0:c0 + BATCH_BLOCKS], dtype=np.int64)
            t0 = time.perf_counter()
            idx = (ks[:, None] * SHARD_BLOCK + offsets[None, :]).ravel()
            if idx[-1] >= total:
                idx = idx[idx < total]
            counts.generated += len(idx)
            vi, rnl = plan.decode(idx)
            ok, dp = plan.divisible_mask(vi, len(idx))
            n_div = int(np.count_nonzero(ok))
            counts.divisible += n_div
            if n_div:
                sel = np.flatnonzero(ok)
                idx, rnl, dp = idx.take(sel), rnl.take(sel), dp.take(sel)
                vi = _take_all(vi, sel)
            t1 = time.perf_counter()
            en += t1 - t0
            if not n_div:
                continue

            env = plan.rule_env(vi, rnl, dp)

            def env_at(i, vi=vi, rnl=rnl):
                return strategy_env(arch, plan.strategy_at(vi, rnl, i))

            bad = rule_filter.block_violations(env, len(idx), env_at)
            n_ok = len(idx) - int(np.count_nonzero(bad))
            counts.after_rules += n_ok
            if n_ok:
                sel = np.flatnonzero(~bad)
                idx, rnl, dp = idx.take(sel), rnl.take(sel), dp.take(sel)
                vi = _take_all(vi, sel)
            t2 = time.perf_counter()
            ru += t2 - t1
            if not n_ok:
                continue

            keep = plan.memory_keep(vi, rnl, dp, bank, len(idx))
            survivors = np.flatnonzero(keep)
            counts.after_memory += len(survivors)
            t3 = time.perf_counter()
            me += t3 - t2

            t4 = time.perf_counter()
            out = list(zip(
                (int(idx[p]) for p in survivors),
                plan.strategies_at(vi, rnl, survivors),
            ))
            en += time.perf_counter() - t4
            yield from out
    finally:
        counts.enumerate_seconds += en
        counts.rules_seconds += ru
        counts.memory_seconds += me
