"""Batched strategy-evaluation engine (the hot path of all three modes).

The scalar :class:`~repro_torch.core.simulate.CostSimulator` walks one strategy at
a time: it replicates each layer's op list ``layers`` times, Counters it,
and queries the eta model per miss. Across a 10^4-strategy search nearly all
of that work is redundant — op *shapes* repeat massively (the paper's own
observation, §3.5). This module exploits that structure end to end:

* stages are :class:`~repro_torch.core.costmodel.StageCensusVec` count-vectors over
  a memoized per-layer census (one dict scale instead of ``O(ops * layers)``
  list work);
* every unique ``ComputeOp`` / ``CommOp`` across a whole candidate chunk is
  resolved against the eta model in ONE vectorized ``compute_times`` /
  ``comm_times`` call and cached in a persistent op-time table;
* per-strategy evaluation is then NumPy dot-products of count-vectors
  against the time table; the overlap/offload discounts
  (:meth:`BatchedCostSimulator._finalize_pending`) and the Eq. 22 schedule
  composition (:meth:`BatchedCostSimulator._compose_batch`) each run as one
  array pass over the whole chunk — the scalar
  :func:`~repro_torch.core.simulate.compose_sim_result` stays the reference;
* :meth:`BatchedCostSimulator.evaluate_stream` adds chunked streaming with
  an incremental top-k heap and an incremental Pareto staircase, so mode-3's
  device-count sweep never materializes the full ``CostedStrategy`` list.

Parity with the scalar simulator is exact up to float summation order
(tested to 1e-9 relative in tests/test_batch_sim.py).
"""
from __future__ import annotations

import itertools
import operator
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np

from repro_torch.core.arch import ModelArch
from repro_torch.core.costmodel import StageCensusVec, build_stage_census_vec
from repro_torch.core.opspec import CommOp
from repro_torch.core.params import ParallelStrategy
from repro_torch.core.pareto import (
    CostedStrategy,
    ParetoStaircase,
    TopK,
    money_cost,
)
from repro_torch.core.simulate import (
    _OVERLAP_EFFICIENCY,
    _P2P_OVERLAP_EFFICIENCY,
    _PCIE_BW,
    SimResult,
    compose_serving_result,
    strategy_money_per_hour,
)

# backwards-compat aliases (the collectors moved to repro_torch.core.pareto)
_TopK = TopK
_ParetoStaircase = ParetoStaircase


class _OpTimeTable:
    """Persistent op -> (index, predicted time) table.

    ``resolve`` batches all unseen descriptors into one eta-model call, so a
    search issues a handful of vectorized queries instead of one per op.
    """

    def __init__(self, predict_batch, predict_one):
        self._predict_batch = predict_batch
        self._predict_one = predict_one
        self.index: dict = {}
        self.times = np.zeros(0, dtype=np.float64)

    def resolve(self, ops: Sequence) -> None:
        missing = [op for op in ops if op not in self.index]
        if not missing:
            return
        # dedupe preserving order (ops may repeat across censuses)
        missing = list(dict.fromkeys(missing))
        if self._predict_batch is not None:
            predicted = np.asarray(self._predict_batch(missing), dtype=np.float64)
        else:
            predicted = np.array(
                [self._predict_one(op) for op in missing], dtype=np.float64
            )
        base = len(self.index)
        for i, op in enumerate(missing):
            self.index[op] = base + i
        self.times = np.concatenate([self.times, predicted])

    def clear(self) -> None:
        self.index = {}
        self.times = np.zeros(0, dtype=np.float64)


def _chunks(it: Iterable, size: int) -> Iterator[list]:
    it = iter(it)
    while True:
        chunk = list(itertools.islice(it, size))
        if not chunk:
            return
        yield chunk


# strategy fields that change a stage census (beyond device/layers/position)
_CENSUS_FIELDS = (
    "micro_batch_size",
    "tensor_parallel",
    "expert_parallel",
    "use_flash_attn",
    "sequence_parallel",
    "pipeline_parallel",
    "recompute_granularity",
    "recompute_num_layers",
    "use_distributed_optimizer",
)
# additional fields that change the stage-time arithmetic
_TIMING_FIELDS = (
    "tp_comm_overlap",
    "overlap_p2p",
    "overlap_grad_reduce",
    "overlap_param_gather",
    "offload_optimizer",
)
_STAGE_CACHE_MAX = 65536
_OP_TABLE_MAX = 65536

# serving censuses are forward-only and batch-explicit: micro_batch_size,
# recompute and optimizer fields cannot change them
_SERVING_CENSUS_FIELDS = (
    "tensor_parallel",
    "expert_parallel",
    "use_flash_attn",
    "sequence_parallel",
    "pipeline_parallel",
)


_CENSUS_GETTER = operator.attrgetter(*_CENSUS_FIELDS)
_TIMING_GETTER = operator.attrgetter(*_TIMING_FIELDS)
_SERVING_CENSUS_GETTER = operator.attrgetter(*_SERVING_CENSUS_FIELDS)


class BatchedCostSimulator:
    """Vectorized drop-in for :class:`CostSimulator.simulate` over strategy
    lists. The scalar simulator remains the reference implementation."""

    def __init__(self, eta_model):
        self.eta = eta_model
        # eta models with prebuildable inference state (the flat-forest GBT
        # node arrays) flatten now, at engine construction: warm engines —
        # the serial backend's shared pair, each pool worker's per-process
        # one — then serve every search on ready-made forests
        prepare = getattr(eta_model, "prepare", None)
        if callable(prepare):
            prepare()
        self._comp = _OpTimeTable(
            getattr(eta_model, "compute_times", None), eta_model.compute_time
            if hasattr(eta_model, "compute_time") else None,
        )
        self._comm = _OpTimeTable(
            getattr(eta_model, "comm_times", None), eta_model.comm_time
            if hasattr(eta_model, "comm_time") else None,
        )
        # two cache tiers, both persistent across batches so a mode-3 sweep
        # pays for each distinct stage exactly once:
        #   census key (op content)  -> raw section sums (the dot-products)
        #   timing key (+ overlaps)  -> final (tf, tb, h, t_dp, t_opt)
        self._raw_cache: dict = {}
        self._stage_time_cache: dict = {}
        # interned (arch, seq, strategy-fields) tuples -> small ints, so the
        # per-stage cache keys stay cheap to hash
        self._census_base_ids: dict = {}
        self._time_base_ids: dict = {}

    def _maybe_trim(self) -> None:
        """Bound cache growth BETWEEN batches.

        Must run before planning (never mid-batch: plans hold keys into the
        caches) and must drop the id interners together with the caches —
        resetting the interners alone would recycle ids into stale keys.
        The op-time tables are bounded too (cached raw sums are plain floats,
        not references into the tables, so clearing them between batches is
        safe) — a long-lived search service replaying many specs would
        otherwise grow them monotonically.
        """
        if (
            len(self._stage_time_cache) > _STAGE_CACHE_MAX
            or len(self._raw_cache) > _STAGE_CACHE_MAX
        ):
            self._raw_cache.clear()
            self._stage_time_cache.clear()
            self._census_base_ids.clear()
            self._time_base_ids.clear()
        # cached raw/stage sums are plain floats (no references into the op
        # tables), so the tables can be dropped independently
        for table in (self._comp, self._comm):
            if len(table.index) > _OP_TABLE_MAX:
                table.clear()

    # -- stage identity ----------------------------------------------------
    def _stage_plan(
        self, arch: ModelArch, s: ParallelStrategy, seq: int
    ) -> list[tuple[tuple, tuple, int, Optional[str], int]]:
        """[(time_key, census_key, stage_index, device, layers)] per stage.

        Census/timing depend on the stage position only through
        (is_first, is_last) — interior stages of one strategy collapse onto
        a single key, and equal keys across strategies share cached results.
        Strategies that differ only in overlap/offload toggles share the
        census tier (same ops, different discounts).
        """
        # s.device matters even though hetero stages carry their own dev:
        # homogeneous stage tuples use dev=None, so without it two device
        # types would collide in the caches (mode-3 sweeps mix types)
        cbase = (arch, seq, s.device, s.data_parallel) + _CENSUS_GETTER(s)
        cid = self._census_base_ids.setdefault(cbase, len(self._census_base_ids))
        tid = self._time_base_ids.setdefault(
            (cid,) + _TIMING_GETTER(s), len(self._time_base_ids)
        )
        if s.hetero is not None:
            stages = s.hetero.stage_sequence()
        else:
            layers = arch.num_layers // s.pipeline_parallel
            stages = [(None, layers)] * s.pipeline_parallel
        pp = len(stages)
        return [
            (
                (tid, dev, n, i == 0, i == pp - 1),
                (cid, dev, n, i == 0, i == pp - 1),
                i, dev, n,
            )
            for i, (dev, n) in enumerate(stages)
        ]

    @staticmethod
    def _p2p_op(census: StageCensusVec) -> Optional[CommOp]:
        if census.p2p_bytes <= 0:
            return None
        return CommOp("p2p", census.device, 2, census.p2p_bytes, intra_node=False)

    # -- raw section sums (the Eq. 27-28 dot-products) ----------------------
    def _sum_pending(self, pending: dict) -> None:
        """Fill ``_raw_cache`` for every pending (census_key -> census).

        The count-vectors of all pending stages are concatenated into flat
        (op-index, count, row) arrays and reduced with ONE vectorized
        ``times[idx] * cnt`` + ``bincount`` pass per op table — the NumPy
        dot-product evaluation of Eq. 27-28 over the whole chunk at once.
        """
        items = list(pending.items())
        n = len(items)
        cindex, mindex = self._comp.index, self._comm.index
        comp_idx: list[int] = []
        comp_cnt: list[float] = []
        comp_row: list[int] = []
        comm_idx: list[int] = []
        comm_cnt: list[float] = []
        comm_row: list[int] = []
        for r, (_, c) in enumerate(items):
            for j, section in enumerate((c.fwd_comp, c.recompute_comp, c.step_comp)):
                row = 3 * r + j
                for op, cnt in section.items():
                    comp_idx.append(cindex[op])
                    comp_cnt.append(cnt)
                    comp_row.append(row)
            for j, section in enumerate((c.fwd_comm, c.step_comm)):
                row = 2 * r + j
                for op, cnt in section.items():
                    comm_idx.append(mindex[op])
                    comm_cnt.append(cnt)
                    comm_row.append(row)

        if comp_idx:
            prod = self._comp.times[np.asarray(comp_idx)] * np.asarray(comp_cnt)
            comp_sums = np.bincount(np.asarray(comp_row), weights=prod, minlength=3 * n)
        else:
            comp_sums = np.zeros(3 * n)
        if comm_idx:
            prod = self._comm.times[np.asarray(comm_idx)] * np.asarray(comm_cnt)
            comm_sums = np.bincount(np.asarray(comm_row), weights=prod, minlength=2 * n)
        else:
            comm_sums = np.zeros(2 * n)

        comm_t = self._comm.times
        for r, (ckey, c) in enumerate(items):
            p2p = self._p2p_op(c)
            h_raw = float(comm_t[mindex[p2p]]) if p2p is not None else 0.0
            rs_sum = sum(
                float(comm_t[mindex[op]]) * cnt
                for op, cnt in c.step_comm.items()
                if op.kind == "reduce_scatter"
            )
            opt_bytes = sum(op.bytes_accessed * cnt for op, cnt in c.step_comp.items())
            self._raw_cache[ckey] = (
                float(comp_sums[3 * r]),      # t_fwd_comp
                float(comp_sums[3 * r + 1]),  # recompute surcharge
                float(comp_sums[3 * r + 2]),  # t_opt (pre-offload)
                float(comm_sums[2 * r]),      # t_fwd_comm (pre-overlap)
                float(comm_sums[2 * r + 1]),  # t_dp (pre-overlap)
                h_raw,
                rs_sum,
                opt_bytes,
                c.bwd_flops_multiplier,
            )

    # -- per-stage timing (mirrors CostSimulator.stage_times) ---------------
    def _finalize_pending(self, pending_time: dict) -> None:
        """Vectorized :meth:`_finalize_stage` over every pending timing key.

        One array pass applies the overlap/offload discounts to all pending
        stages at once. Elementwise float64 arithmetic with ``np.where``
        selection reproduces the scalar branches bit-for-bit (the same
        multiplications and min/max in the same order), which
        tests/test_batch_sim.py's parity suite and the dedicated
        finalize-parity test both pin down.
        """
        items = list(pending_time.items())
        m = len(items)
        raw = np.array(
            [self._raw_cache[ckey] for _, (ckey, _) in items], dtype=np.float64
        )
        (t_fwd_comp, t_rc, t_opt, t_fwd_comm, t_dp, h, rs_sum, opt_bytes,
         bwd_mult) = raw.T

        def flags(attr):
            return np.fromiter(
                (getattr(s, attr) for _, (_, s) in items), np.bool_, m
            )

        tp_ov = flags("tp_comm_overlap")
        p2p_ov = flags("overlap_p2p")
        grad_ov = flags("overlap_grad_reduce")
        use_dist = flags("use_distributed_optimizer")
        param_ov = flags("overlap_param_gather")
        offload = flags("offload_optimizer")

        t_fwd_comm = np.where(
            tp_ov, t_fwd_comm * (1.0 - _OVERLAP_EFFICIENCY * 0.5), t_fwd_comm
        )
        t_fwd = t_fwd_comp + t_fwd_comm
        t_bwd_comp = bwd_mult * t_fwd_comp + t_rc
        t_bwd = t_bwd_comp + t_fwd_comm

        h = np.where(p2p_ov, h * (1.0 - _P2P_OVERLAP_EFFICIENCY), h)

        # ZeRO: only the grad reduce-scatter overlaps with backward unless
        # overlap_param_gather is on (same rule as the scalar branch)
        overlappable = np.where(use_dist & ~param_ov, rs_sum, t_dp)
        hidden = np.minimum(_OVERLAP_EFFICIENCY * overlappable, t_bwd_comp)
        t_dp = np.where(
            grad_ov & (t_dp > 0), np.maximum(t_dp - hidden, 0.0), t_dp
        )

        t_off = opt_bytes / _PCIE_BW
        t_opt = np.where(
            offload, t_opt + t_off * np.where(grad_ov, 0.3, 1.0), t_opt
        )

        cache = self._stage_time_cache
        for r, (tkey, _) in enumerate(items):
            cache[tkey] = (
                float(t_fwd[r]), float(t_bwd[r]), float(h[r]),
                float(t_dp[r]), float(t_opt[r]),
            )

    def _finalize_stage(
        self, raw: tuple, s: ParallelStrategy
    ) -> tuple[float, float, float, float, float]:
        (t_fwd_comp, t_rc, t_opt, t_fwd_comm, t_dp, h, rs_sum, opt_bytes,
         bwd_mult) = raw
        if s.tp_comm_overlap:
            t_fwd_comm *= 1.0 - _OVERLAP_EFFICIENCY * 0.5
        t_fwd = t_fwd_comp + t_fwd_comm

        t_bwd_comp = bwd_mult * t_fwd_comp
        t_bwd_comp += t_rc
        t_bwd = t_bwd_comp + t_fwd_comm

        if s.overlap_p2p:
            h *= 1.0 - _P2P_OVERLAP_EFFICIENCY

        if s.overlap_grad_reduce and t_dp > 0:
            if s.use_distributed_optimizer and not s.overlap_param_gather:
                # ZeRO: only the grad reduce-scatter overlaps with backward;
                # the param all-gather needs overlap_param_gather
                overlappable = rs_sum
            else:
                overlappable = t_dp
            hidden = min(_OVERLAP_EFFICIENCY * overlappable, t_bwd_comp)
            t_dp = max(t_dp - hidden, 0.0)

        if s.offload_optimizer:
            t_off = opt_bytes / _PCIE_BW
            t_opt += t_off * (0.3 if s.overlap_grad_reduce else 1.0)
        return t_fwd, t_bwd, h, t_dp, t_opt

    # -- batch evaluation ---------------------------------------------------
    def simulate_batch(
        self,
        arch: ModelArch,
        strategies: Sequence[ParallelStrategy],
        *,
        global_batch: int,
        seq: int,
    ) -> list[SimResult]:
        """Evaluate a whole candidate list with one eta query per op shape.

        Dedup tiers: per-layer censuses are memoized (costmodel), distinct
        stages are built and dot-product-summed once per census key, timed
        once per (census, overlap-toggles) key — all cached across calls —
        and every unseen op descriptor of the chunk resolves through a
        single vectorized eta-model query.
        """
        self._maybe_trim()
        plans = [self._stage_plan(arch, s, seq) for s in strategies]

        # build censuses only for stage keys with no cached raw sums
        pending: dict = {}  # census_key -> census
        pending_time: dict = {}  # time_key -> (census_key, strategy)
        for s, plan in zip(strategies, plans):
            for tkey, ckey, stage, dev, layers in plan:
                if tkey in self._stage_time_cache or tkey in pending_time:
                    continue
                pending_time[tkey] = (ckey, s)
                if ckey in self._raw_cache or ckey in pending:
                    continue
                pending[ckey] = build_stage_census_vec(
                    arch, s, stage, seq=seq, device=dev, layers_in_stage=layers
                )

        if pending:
            comp_ops: dict = {}
            comm_ops: dict = {}
            for c in pending.values():
                comp_ops.update(dict.fromkeys(c.fwd_comp))
                comp_ops.update(dict.fromkeys(c.recompute_comp))
                comp_ops.update(dict.fromkeys(c.step_comp))
                comm_ops.update(dict.fromkeys(c.fwd_comm))
                comm_ops.update(dict.fromkeys(c.step_comm))
                p2p = self._p2p_op(c)
                if p2p is not None:
                    comm_ops[p2p] = None
            self._comp.resolve(list(comp_ops))
            self._comm.resolve(list(comm_ops))
            self._sum_pending(pending)

        if pending_time:
            self._finalize_pending(pending_time)

        return self._compose_batch(strategies, plans, global_batch, seq)

    # -- chunk-wide Eq. 22 composition --------------------------------------
    def _compose_batch(
        self,
        strategies: Sequence[ParallelStrategy],
        plans: list,
        global_batch: int,
        seq: int,
    ) -> list[SimResult]:
        """Vectorized :func:`~repro_torch.core.simulate.compose_sim_result` over a
        whole chunk: the per-stage (tf, tb, h, dp, opt) tuples of every
        strategy are flattened into one array and the Eq. 22 schedule
        algebra runs as segment reductions (``reduceat``) instead of
        per-strategy Python. Per-strategy values depend only on that
        strategy's own segment, so results are independent of how a stream
        was chunked — a property the parallel engine relies on.
        """
        if not strategies:
            return []
        cache = self._stage_time_cache
        nstrat = len(strategies)
        seg = np.fromiter((len(p) for p in plans), np.int64, nstrat)
        starts = np.zeros(nstrat, np.int64)
        np.cumsum(seg[:-1], out=starts[1:])
        flat = np.array(
            [cache[tkey] for plan in plans for tkey, _, _, _, _ in plan],
            dtype=np.float64,
        )  # (total stages, 5)
        tf, tb, h, dp, opt = flat.T
        t = tf + tb

        vp = np.fromiter(
            (float(max(s.virtual_pipeline_stages, 1)) for s in strategies),
            np.float64, nstrat,
        )
        K = np.fromiter(
            (float(s.num_microbatches(global_batch)) for s in strategies),
            np.float64, nstrat,
        )
        cost = t + np.repeat(vp, seg) * h
        steady = np.maximum.reduceat(cost, starts)
        total = np.add.reduceat(cost, starts)
        pipeline = K * steady + (total - steady) / vp
        bubble = np.maximum(pipeline - K * steady, 0.0)
        dp_exposed = np.maximum.reduceat(dp, starts)
        opt_time = np.maximum.reduceat(opt, starts)
        step = pipeline + dp_exposed + opt_time

        tokens = float(global_batch) * seq
        out = []
        for r, s in enumerate(strategies):
            a, b = int(starts[r]), int(starts[r] + seg[r])
            mph = strategy_money_per_hour(s)
            st = float(step[r])
            out.append(SimResult(
                step_time=st,
                throughput_samples=global_batch / st,
                throughput_tokens=tokens / st,
                pipeline_time=float(pipeline[r]),
                bubble_time=float(bubble[r]),
                dp_exposed_time=float(dp_exposed[r]),
                optimizer_time=float(opt_time[r]),
                stage_times=t[a:b].tolist(),
                stage_p2p=h[a:b].tolist(),
                money_per_hour=mph,
                money_per_step=mph / 3600.0 * st,
            ))
        return out

    def simulate(
        self, arch: ModelArch, s: ParallelStrategy, *, global_batch: int, seq: int
    ) -> SimResult:
        """Single-strategy convenience wrapper (same signature as scalar)."""
        return self.simulate_batch(arch, [s], global_batch=global_batch, seq=seq)[0]

    # -- serving -------------------------------------------------------------
    def simulate_serving_batch(
        self,
        arch: ModelArch,
        strategies: Sequence[ParallelStrategy],
        *,
        inference,
        global_batch: int,
    ) -> list[SimResult]:
        """Vectorized serving evaluation (scalar reference:
        :meth:`CostSimulator.simulate_serving`).

        Serving stages are forward-only, so the cache rows are simpler than
        training's 9-tuples: per census key a ``((prefill comp, comm, p2p),
        (decode comp, comm, p2p))`` raw pair, finalized per timing key into
        ``((t_pre, h_pre), (t_dec, h_dec))``. All unseen ops of a chunk
        still resolve through one vectorized eta query per table, and the
        serving keys are namespaced so they never collide with training
        entries in the shared caches.
        """
        self._maybe_trim()
        from repro_torch.core.costmodel import (
            build_serving_stage_census_vec,
            serving_decode_context,
        )

        prefill = inference.prefill_len
        context = serving_decode_context(prefill, inference.decode_len)
        mix = inference.mix(global_batch)

        plans = []  # per strategy: [(b, w, [tkey per stage])]
        pending: dict = {}  # ckey -> (prefill census, decode census)
        pending_time: dict = {}  # tkey -> (ckey, strategy)
        for s in strategies:
            cbase = (
                arch, "serve", prefill, context, s.device,
            ) + _SERVING_CENSUS_GETTER(s)
            cid = self._census_base_ids.setdefault(
                cbase, len(self._census_base_ids)
            )
            tid = self._time_base_ids.setdefault(
                (cid, "serve", s.tp_comm_overlap), len(self._time_base_ids)
            )
            if s.hetero is not None:
                stages = s.hetero.stage_sequence()
            else:
                layers = arch.num_layers // s.pipeline_parallel
                stages = [(None, layers)] * s.pipeline_parallel
            pp = len(stages)
            plan = []
            for b, w in mix:
                tkeys = []
                for i, (dev, n) in enumerate(stages):
                    pos = (dev, n, i == 0, i == pp - 1, b)
                    tkey = ("serve", tid) + pos
                    tkeys.append(tkey)
                    if tkey in self._stage_time_cache or tkey in pending_time:
                        continue
                    ckey = ("serve", cid) + pos
                    pending_time[tkey] = (ckey, s)
                    if ckey in self._raw_cache or ckey in pending:
                        continue
                    pending[ckey] = build_serving_stage_census_vec(
                        arch, s, i, prefill=prefill, context=context,
                        batch=b, device=dev, layers_in_stage=n,
                    )
                plan.append((b, w, tkeys))
            plans.append(plan)

        if pending:
            comp_ops: dict = {}
            comm_ops: dict = {}
            for pre, dec in pending.values():
                for c in (pre, dec):
                    comp_ops.update(dict.fromkeys(c.fwd_comp))
                    comm_ops.update(dict.fromkeys(c.fwd_comm))
                    p2p = self._p2p_op(c)
                    if p2p is not None:
                        comm_ops[p2p] = None
            self._comp.resolve(list(comp_ops))
            self._comm.resolve(list(comm_ops))
            comp_t, comm_t = self._comp.times, self._comm.times
            cindex, mindex = self._comp.index, self._comm.index
            for ckey, (pre, dec) in pending.items():
                rows = []
                for c in (pre, dec):
                    tc = sum(
                        comp_t[cindex[op]] * cnt
                        for op, cnt in c.fwd_comp.items()
                    )
                    cc = sum(
                        comm_t[mindex[op]] * cnt
                        for op, cnt in c.fwd_comm.items()
                    )
                    p2p = self._p2p_op(c)
                    hr = float(comm_t[mindex[p2p]]) if p2p is not None else 0.0
                    rows.append((float(tc), float(cc), hr))
                self._raw_cache[ckey] = tuple(rows)

        for tkey, (ckey, s) in pending_time.items():
            disc = (
                1.0 - _OVERLAP_EFFICIENCY * 0.5 if s.tp_comm_overlap else 1.0
            )
            (ptc, pcc, ph), (dtc, dcc, dh) = self._raw_cache[ckey]
            self._stage_time_cache[tkey] = (
                (ptc + pcc * disc, ph), (dtc + dcc * disc, dh),
            )

        cache = self._stage_time_cache
        out = []
        for s, plan in zip(strategies, plans):
            entries = []
            for b, w, tkeys in plan:
                pre_stages, dec_stages = [], []
                for tkey in tkeys:
                    (tp, hp), (td, hd) = cache[tkey]
                    pre_stages.append((tp, hp))
                    dec_stages.append((td, hd))
                entries.append((b, w, pre_stages, dec_stages))
            out.append(compose_serving_result(
                s, entries, decode_len=inference.decode_len
            ))
        return out

    # -- streaming evaluation ----------------------------------------------
    def evaluate_stream(
        self,
        arch: ModelArch,
        strategies: Iterable[ParallelStrategy],
        *,
        global_batch: int,
        seq: int,
        train_tokens: float,
        top_k: int,
        chunk_size: int = 512,
        keep_pool: bool = False,
    ) -> tuple[list[CostedStrategy], list[CostedStrategy], int]:
        """Chunked evaluation: returns (top-k ranked, Pareto pool, #evaluated).

        Only ``top_k`` + pool-member ``CostedStrategy`` objects are retained,
        regardless of how many candidates stream through.
        """
        topk = TopK(top_k)
        pool = ParetoStaircase() if keep_pool else None

        def push(costed: CostedStrategy) -> None:
            topk.push(costed)
            if pool is not None:
                pool.push(costed)

        n = stream_evaluate(
            self, arch, strategies, push, global_batch=global_batch, seq=seq,
            train_tokens=train_tokens, chunk_size=chunk_size,
        )
        return topk.sorted(), pool.sorted() if pool is not None else [], n


def stream_evaluate(
    engine,
    arch: ModelArch,
    strategies: Iterable[ParallelStrategy],
    push: Callable[[CostedStrategy], None],
    *,
    global_batch: int,
    seq: int,
    train_tokens: float,
    chunk_size: int = 512,
    inference=None,
) -> int:
    """Engine-agnostic chunked streaming evaluation.

    ``engine`` is anything with a ``simulate_batch`` method (the batched
    engine or the scalar :class:`~repro_torch.core.simulate.CostSimulator`
    reference). Each candidate is costed and handed to ``push`` — typically
    an :class:`~repro_torch.core.objectives.Objective` collector — so at most
    ``chunk_size`` candidates plus the collector's survivors are ever held.
    With ``inference`` set (a :class:`~repro_torch.core.spec.InferenceShape`) each
    chunk routes through the engine's serving path instead of the training
    step simulator. Returns the number of candidates evaluated.
    """
    n = 0
    for chunk in _chunks(strategies, chunk_size):
        if inference is not None:
            sims = engine.simulate_serving_batch(
                arch, chunk, inference=inference, global_batch=global_batch
            )
        else:
            sims = engine.simulate_batch(
                arch, chunk, global_batch=global_batch, seq=seq
            )
        for s, sim in zip(chunk, sims):
            push(
                CostedStrategy(
                    strategy=s,
                    sim=sim,
                    throughput=sim.throughput_tokens,
                    money=money_cost(sim, train_tokens),
                )
            )
        n += len(chunk)
    return n


def stream_evaluate_indexed(
    engine,
    arch: ModelArch,
    pairs: Iterable[tuple[tuple, ParallelStrategy]],
    push: Callable[[CostedStrategy, tuple], None],
    *,
    global_batch: int,
    seq: int,
    train_tokens: float,
    chunk_size: int = 512,
    inference=None,
) -> int:
    """Seq-carrying variant of :func:`stream_evaluate` for sharded streams.

    Consumes ``(seq, strategy)`` pairs (a stream's
    :meth:`~repro_torch.core.planner.CandidateStream.shard` view) and calls
    ``push(costed, seq)`` so a mergeable collector can tie-break on the
    candidate's exact serial-stream position. Chunking is identical to the
    plain evaluator — and because the engine's per-strategy results do not
    depend on chunk composition, the costed values are too.
    """
    n = 0
    for chunk in _chunks(pairs, chunk_size):
        strategies = [s for _, s in chunk]
        if inference is not None:
            sims = engine.simulate_serving_batch(
                arch, strategies, inference=inference,
                global_batch=global_batch,
            )
        else:
            sims = engine.simulate_batch(
                arch, strategies, global_batch=global_batch, seq=seq
            )
        for (q, s), sim in zip(chunk, sims):
            push(
                CostedStrategy(
                    strategy=s,
                    sim=sim,
                    throughput=sim.throughput_tokens,
                    money=money_cost(sim, train_tokens),
                ),
                q,
            )
        n += len(chunk)
    return n
