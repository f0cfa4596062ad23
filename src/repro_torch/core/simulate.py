"""Performance simulator (paper §3.5, Eq. 22 + 27-28).

Computes per-stage forward/backward/communication times from the operator
census, then composes the pipeline schedule with the heterogeneous-aware
total-duration formula (Eq. 22):

    T_pipe = sum_i (t_i + h_i) + (K - 1) * max_i (t_i + h_i)

which in the homogeneous limit reduces to the classic bubble formula and in
the heterogeneous case correctly charges the slowest stage for the steady
state. Gradient-reduction and optimizer terms are added per-step with the
overlap discounts of the corresponding Table-3 toggles.

Op-level eta predictions are memoized on the (frozen, hashable) op
descriptors — across a 20k-strategy search almost all op shapes repeat, which
is how Astra hits the paper's ~1-minute end-to-end simulation budget.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Optional, Sequence

from repro_torch.core import wire
from repro_torch.core.arch import ModelArch
from repro_torch.core.costmodel import StageCensus, build_stage_census
from repro_torch.core.opspec import CommOp, ComputeOp
from repro_torch.core.params import ParallelStrategy
from repro_torch.hw.catalog import get_device

# fraction of a collective hidden under compute when its overlap toggle is on
_OVERLAP_EFFICIENCY = 0.75
_P2P_OVERLAP_EFFICIENCY = 0.8
_PCIE_BW = 25e9  # optimizer-offload staging bandwidth (DDR/PCIe tier)


@dataclasses.dataclass
class SimResult:
    step_time: float
    throughput_samples: float  # samples / second
    throughput_tokens: float  # tokens / second
    pipeline_time: float
    bubble_time: float
    dp_exposed_time: float
    optimizer_time: float
    stage_times: list[float]  # t_i = tf_i + tb_i per microbatch
    stage_p2p: list[float]  # h_i
    money_per_hour: float
    money_per_step: float

    @property
    def money_per_mtoken(self) -> float:
        if self.throughput_tokens <= 0:
            return float("inf")
        return self.money_per_hour / 3600.0 / self.throughput_tokens * 1e6

    # -- wire format -------------------------------------------------------
    def to_dict(self) -> dict:
        """Bit-exact wire form: every field is a hex float (or list of)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = wire.dump_floats(v) if isinstance(v, list) \
                else wire.dump_float(v)
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "SimResult":
        kw = {}
        for f in dataclasses.fields(cls):
            v = d[f.name]
            kw[f.name] = wire.load_floats(v) if isinstance(v, list) \
                else wire.load_float(v)
        return cls(**kw)


class CostSimulator:
    """Evaluates strategies with a pluggable eta model (GBT or analytic)."""

    def __init__(self, eta_model):
        self.eta = eta_model
        self._comp_memo: dict[ComputeOp, float] = {}
        self._comm_memo: dict[CommOp, float] = {}

    # -- memoized op-time lookup ------------------------------------------
    def _comp_times(self, ops: Sequence[ComputeOp]) -> float:
        counts = Counter(ops)
        missing = [op for op in counts if op not in self._comp_memo]
        if missing:
            times = self.eta.compute_times(missing) if hasattr(
                self.eta, "compute_times"
            ) else [self.eta.compute_time(op) for op in missing]
            for op, t in zip(missing, times):
                self._comp_memo[op] = float(t)
        return sum(self._comp_memo[op] * c for op, c in counts.items())

    def _comm_times(self, ops: Sequence[CommOp]) -> float:
        counts = Counter(ops)
        missing = [op for op in counts if op not in self._comm_memo]
        if missing:
            times = self.eta.comm_times(missing) if hasattr(
                self.eta, "comm_times"
            ) else [self.eta.comm_time(op) for op in missing]
            for op, t in zip(missing, times):
                self._comm_memo[op] = float(t)
        return sum(self._comm_memo[op] * c for op, c in counts.items())

    def _p2p_time(self, device: str, payload: float) -> float:
        if payload <= 0:
            return 0.0
        op = CommOp("p2p", device, 2, payload, intra_node=False)
        return self._comm_times([op])

    # -- per-stage timing ---------------------------------------------------
    def stage_times(self, census: StageCensus, s: ParallelStrategy) -> tuple[float, float, float, float, float]:
        """(t_fwd, t_bwd, h_p2p, t_dp, t_opt) for one stage, per microbatch
        for the first three and per-step for the last two."""
        t_fwd_comp = self._comp_times(census.fwd_comp)
        t_fwd_comm = self._comm_times(census.fwd_comm)
        if s.tp_comm_overlap:
            t_fwd_comm *= 1.0 - _OVERLAP_EFFICIENCY * 0.5  # partial TP-gemm overlap
        t_fwd = t_fwd_comp + t_fwd_comm

        t_bwd_comp = census.bwd_flops_multiplier * t_fwd_comp
        t_bwd_comp += self._comp_times(census.recompute_comp)
        t_bwd = t_bwd_comp + t_fwd_comm  # TP collectives mirror in backward

        h = self._p2p_time(census.device, census.p2p_bytes)
        if s.overlap_p2p:
            h *= 1.0 - _P2P_OVERLAP_EFFICIENCY

        t_dp = self._comm_times(census.step_comm)
        if s.overlap_grad_reduce and t_dp > 0:
            if s.use_distributed_optimizer and not s.overlap_param_gather:
                # ZeRO splits the step comm into grad reduce-scatter + param
                # all-gather; overlap_grad_reduce only hides the RS half —
                # the AG stays exposed until overlap_param_gather is on.
                overlappable = self._comm_times(
                    [op for op in census.step_comm if op.kind == "reduce_scatter"]
                )
            else:
                overlappable = t_dp
            hidden = _OVERLAP_EFFICIENCY * overlappable
            # overlap is bounded by available backward compute of one full pass
            hidden = min(hidden, t_bwd_comp)
            t_dp = max(t_dp - hidden, 0.0)
        t_opt = self._comp_times(census.step_comp)
        if s.offload_optimizer:
            # stage optimizer states over the host link
            opt_bytes = sum(op.bytes_accessed for op in census.step_comp)
            t_off = opt_bytes / _PCIE_BW
            t_opt += t_off * (0.3 if s.overlap_grad_reduce else 1.0)
        return t_fwd, t_bwd, h, t_dp, t_opt

    # -- whole strategy -----------------------------------------------------
    def simulate(
        self,
        arch: ModelArch,
        s: ParallelStrategy,
        *,
        global_batch: int,
        seq: int,
    ) -> SimResult:
        if s.hetero is not None:
            stages = s.hetero.stage_sequence()
            censuses = [
                build_stage_census(arch, s, i, seq=seq, device=dev, layers_in_stage=n)
                for i, (dev, n) in enumerate(stages)
            ]
        else:
            censuses = [
                build_stage_census(arch, s, i, seq=seq)
                for i in range(s.pipeline_parallel)
            ]

        per_stage = [self.stage_times(c, s) for c in censuses]
        return compose_sim_result(s, per_stage, global_batch=global_batch, seq=seq)

    def simulate_batch(
        self,
        arch: ModelArch,
        strategies: Sequence[ParallelStrategy],
        *,
        global_batch: int,
        seq: int,
    ) -> list[SimResult]:
        """Reference batch evaluation: one :meth:`simulate` per strategy.

        Same signature as the batched engine so the streaming evaluator
        (:func:`repro_torch.core.batch.stream_evaluate`) can run either one."""
        return [
            self.simulate(arch, s, global_batch=global_batch, seq=seq)
            for s in strategies
        ]

    # -- serving ------------------------------------------------------------
    def _serving_stage_time(
        self, census: StageCensus, s: ParallelStrategy
    ) -> tuple[float, float]:
        """(stage forward time, p2p hop) for a serving census.

        Forward-only: TP collectives keep the training overlap discount,
        but p2p hops stay fully exposed — a lone autoregressive token has
        no other microbatch to hide its hop behind."""
        t = self._comp_times(census.fwd_comp)
        c = self._comm_times(census.fwd_comm)
        if s.tp_comm_overlap:
            c *= 1.0 - _OVERLAP_EFFICIENCY * 0.5
        h = self._p2p_time(census.device, census.p2p_bytes)
        return t + c, h

    def simulate_serving(
        self,
        arch: ModelArch,
        s: ParallelStrategy,
        *,
        inference,
        global_batch: int,
    ) -> SimResult:
        """Batched-serving reference: prefill as one dense forward at the
        prompt length, decode as per-token steps at the mean KV context,
        mix-weighted over the request-arrival batch mix."""
        from repro_torch.core.costmodel import (
            build_serving_stage_census,
            serving_decode_context,
        )

        context = serving_decode_context(
            inference.prefill_len, inference.decode_len
        )
        if s.hetero is not None:
            stage_args = [
                (i, dev, n)
                for i, (dev, n) in enumerate(s.hetero.stage_sequence())
            ]
        else:
            stage_args = [
                (i, None, None) for i in range(s.pipeline_parallel)
            ]
        entries = []
        for b, w in inference.mix(global_batch):
            pre_stages, dec_stages = [], []
            for i, dev, n in stage_args:
                pre, dec = build_serving_stage_census(
                    arch, s, i, prefill=inference.prefill_len,
                    context=context, batch=b, device=dev, layers_in_stage=n,
                )
                pre_stages.append(self._serving_stage_time(pre, s))
                dec_stages.append(self._serving_stage_time(dec, s))
            entries.append((b, w, pre_stages, dec_stages))
        return compose_serving_result(
            s, entries, decode_len=inference.decode_len
        )

    def simulate_serving_batch(
        self,
        arch: ModelArch,
        strategies: Sequence[ParallelStrategy],
        *,
        inference,
        global_batch: int,
    ) -> list[SimResult]:
        return [
            self.simulate_serving(
                arch, s, inference=inference, global_batch=global_batch
            )
            for s in strategies
        ]

    @staticmethod
    def _money_per_hour(s: ParallelStrategy) -> float:
        return strategy_money_per_hour(s)


def strategy_money_per_hour(s: ParallelStrategy) -> float:
    """Eq. 32 rate: sum over device types of N_g * F_g."""
    if s.hetero is not None:
        per_stage_devices = s.data_parallel * s.tensor_parallel
        return sum(
            get_device(dev).price_per_hour * per_stage_devices
            for dev, _ in s.hetero.stage_sequence()
        )
    return get_device(s.device).price_per_hour * s.num_devices


def compose_sim_result(
    s: ParallelStrategy,
    per_stage: Sequence[tuple[float, float, float, float, float]],
    *,
    global_batch: int,
    seq: int,
) -> SimResult:
    """Eq. 22 schedule composition from per-stage (tf, tb, h, t_dp, t_opt).

    Shared by the scalar :class:`CostSimulator` and the batched engine
    (:mod:`repro_torch.core.batch`) so the two paths agree bit-for-bit on the
    pipeline algebra.
    """
    K = s.num_microbatches(global_batch)
    t_i = [tf + tb for tf, tb, _, _, _ in per_stage]
    h_i = [h for _, _, h, _, _ in per_stage]
    dp_i = [dp for _, _, _, dp, _ in per_stage]
    opt_i = [o for _, _, _, _, o in per_stage]

    # Eq. 22 (fwd+bwd combined per microbatch). Interleaved virtual
    # pipeline (Megatron's num-layers-per-virtual-pipeline-stage) shrinks
    # the BUBBLE (ramp) by vp at the cost of vp-times the p2p traffic:
    #   T = K * max_i(c_i) + (sum_i c_i - max_i c_i) / vp,
    #   c_i = t_i + vp * h_i
    # vp=1 recovers Eq. 22 exactly: sum_i c_i + (K-1) * max_i c_i.
    # pp=1 (no pipeline) is vp-invariant: T = K * t, as it must be.
    vp = max(s.virtual_pipeline_stages, 1)
    stage_cost = [t + vp * h for t, h in zip(t_i, h_i)]
    steady = max(stage_cost)
    pipeline_time = K * steady + (sum(stage_cost) - steady) / vp
    bubble_time = max(pipeline_time - K * steady, 0.0)

    dp_exposed = max(dp_i)
    opt_time = max(opt_i)
    step_time = pipeline_time + dp_exposed + opt_time

    money_per_hour = strategy_money_per_hour(s)
    tokens = float(global_batch) * seq
    return SimResult(
        step_time=step_time,
        throughput_samples=global_batch / step_time,
        throughput_tokens=tokens / step_time,
        pipeline_time=pipeline_time,
        bubble_time=max(bubble_time, 0.0),
        dp_exposed_time=dp_exposed,
        optimizer_time=opt_time,
        stage_times=t_i,
        stage_p2p=h_i,
        money_per_hour=money_per_hour,
        money_per_step=money_per_hour / 3600.0 * step_time,
    )


def compose_serving_result(
    s: ParallelStrategy,
    entries: Sequence[tuple],
    *,
    decode_len: int,
) -> SimResult:
    """Serving composition shared by the scalar and batched engines.

    ``entries`` holds one ``(batch, weight, prefill, decode)`` tuple per
    request-mix entry, where ``prefill`` / ``decode`` are per-stage
    ``(t_i, h_i)`` sequences. The SimResult maps serving onto the training
    fields so collectors, objectives and the wire format apply unchanged:

    * ``step_time``       — mix-weighted per-token decode latency (the
                            quantity a per-token SLO bounds);
    * ``pipeline_time``   — mix-weighted time-to-first-token (the prompt
                            traverses every stage once);
    * ``throughput_tokens`` — generated tokens/s across the ``dp``
                            replica groups (each serves its own requests);
    * ``throughput_samples`` — completed requests/s.

    A decode token crosses every pipeline stage serially (it cannot
    pipeline with itself), so per-token latency is the *sum* of stage
    times — deep PP hurts serving latency, TP helps, exactly the tradeoff
    the search should surface. ``money_per_hour`` stays the Eq. 32 rate,
    so assignment-time price rescales remain linear for serving cells too.
    """
    dp = float(s.data_parallel)
    step_time = ttft = tok_s = req_s = 0.0
    n_stages = len(entries[0][2])
    stage_t = [0.0] * n_stages
    stage_h = [0.0] * n_stages
    for b, w, pre, dec in entries:
        ttft_b = sum(t + h for t, h in pre)
        tok_b = sum(t + h for t, h in dec)
        request = ttft_b + decode_len * tok_b
        step_time += w * tok_b
        ttft += w * ttft_b
        tok_s += w * (b * decode_len / request)
        req_s += w * (b / request)
        for i, (t, h) in enumerate(dec):
            stage_t[i] += w * t
            stage_h[i] += w * h
    money_per_hour = strategy_money_per_hour(s)
    return SimResult(
        step_time=step_time,
        throughput_samples=dp * req_s,
        throughput_tokens=dp * tok_s,
        pipeline_time=ttft,
        bubble_time=0.0,
        dp_exposed_time=0.0,
        optimizer_time=0.0,
        stage_times=stage_t,
        stage_p2p=stage_h,
        money_per_hour=money_per_hour,
        money_per_step=money_per_hour / 3600.0 * step_time,
    )
