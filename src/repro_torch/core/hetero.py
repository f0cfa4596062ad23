"""Heterogeneous-GPU strategy search (paper §3.4).

Solves Eq. 23: choose, for each GPU type i (of M types with at most l_i
devices), the number of pipeline stages m_i and layers-per-stage n_i with

    sum_i m_i = P,   m_i <= l_i / (D*T),   sum_i m_i * n_i = N

and evaluate each candidate with the Eq. 22 latency model (implemented in
:mod:`repro_torch.core.simulate`, which charges the slowest stage for the steady
state). Two search engines are provided:

* ``enumerate_placements`` — the paper's brute force. Compositions of P into
  M parts are O(P^{M-1}); layer assignments are O(N^{M-1}). Because Eq. 22
  is order-invariant in the stage sequence (the paper's own observation used
  to collapse O(M^P) -> contiguous segments), we enumerate unordered
  compositions directly and skip the (M-1)! segment orderings the paper's
  count includes.
* ``balanced_placement`` — a beyond-paper O(M log N) water-filling solver:
  for a fixed composition the minimax stage time is achieved by n_i inversely
  proportional to the per-layer speed of type i; we round to integers and
  locally repair the budget constraint. The benchmark shows it finds the
  same optima ~100x faster (EXPERIMENTS.md §Perf-search).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Optional, Sequence

from repro_torch.core.arch import ModelArch
from repro_torch.core.params import HeteroPlacement, ParallelStrategy
from repro_torch.hw.catalog import get_device


@dataclasses.dataclass(frozen=True)
class HeteroPool:
    """Mode-2 GPU pool: total budget + per-type caps (paper Eq. 2)."""

    total_devices: int
    type_caps: tuple[tuple[str, int], ...]  # ((device, max_count), ...)

    @property
    def devices(self) -> tuple[str, ...]:
        return tuple(d for d, _ in self.type_caps)


def compositions(total: int, parts: int, caps: Sequence[int]) -> Iterable[tuple[int, ...]]:
    """All (m_1..m_parts) with sum == total, 0 <= m_i <= caps[i]."""
    if parts == 1:
        if 0 <= total <= caps[0]:
            yield (total,)
        return
    for first in range(min(total, caps[0]) + 1):
        for rest in compositions(total - first, parts - 1, caps[1:]):
            yield (first,) + rest


def layer_assignments(
    num_layers: int, m: Sequence[int]
) -> Iterable[tuple[int, ...]]:
    """All (n_i >= 1) with sum_i m_i * n_i == num_layers (types with m_i == 0
    get n_i == 0). Brute force — the paper's O(N^{M-1})."""
    active = [i for i, mi in enumerate(m) if mi > 0]
    if not active:
        return
    def rec(idx: int, remaining: int, acc: dict[int, int]):
        if idx == len(active) - 1:
            i = active[idx]
            if remaining % m[i] == 0 and remaining >= m[i]:
                yield {**acc, i: remaining // m[i]}
            return
        i = active[idx]
        max_n = (remaining - sum(m[j] for j in active[idx + 1:])) // m[i]
        for n in range(1, max_n + 1):
            yield from rec(idx + 1, remaining - m[i] * n, {**acc, i: n})

    for sol in rec(0, num_layers, {}):
        yield tuple(sol.get(i, 0) for i in range(len(m)))


def enumerate_placements(
    arch: ModelArch,
    pool: HeteroPool,
    *,
    pipeline_parallel: int,
    data_parallel: int,
    tensor_parallel: int,
    max_assignments_per_composition: Optional[int] = None,
) -> Iterable[HeteroPlacement]:
    """Paper-faithful enumeration of Eq. 23 solutions."""
    dt = data_parallel * tensor_parallel
    caps = [cap // dt for _, cap in pool.type_caps]
    names = [d for d, _ in pool.type_caps]
    for m in compositions(pipeline_parallel, len(caps), caps):
        count = 0
        for n in layer_assignments(arch.num_layers, m):
            used = [i for i, mi in enumerate(m) if mi > 0]
            yield HeteroPlacement(
                devices=tuple(names[i] for i in used),
                stages_per_type=tuple(m[i] for i in used),
                layers_per_stage=tuple(n[i] for i in used),
            )
            count += 1
            if (
                max_assignments_per_composition is not None
                and count >= max_assignments_per_composition
            ):
                break


def balanced_placement(
    arch: ModelArch,
    pool: HeteroPool,
    *,
    pipeline_parallel: int,
    data_parallel: int,
    tensor_parallel: int,
    m: Sequence[int],
) -> Optional[HeteroPlacement]:
    """Water-filling layer balance for one composition (beyond-paper solver).

    Minimizes max_i n_i * t_layer(i) subject to sum m_i n_i = N by setting
    n_i proportional to the per-layer speed of type i, then repairing the
    integer budget greedily (always adjusting the stage whose time moves the
    minimax least).
    """
    names = [d for d, _ in pool.type_caps]
    active = [i for i, mi in enumerate(m) if mi > 0]
    if not active or sum(m) != pipeline_parallel:
        return None
    N = arch.num_layers
    if sum(m[i] for i in active) > N:
        return None
    # per-layer relative time ~ 1 / peak_flops (compute-bound proxy)
    speed = {i: get_device(names[i]).peak_flops_bf16 for i in active}
    total_speed = sum(m[i] * speed[i] for i in active)
    n = {i: max(1, round(N * speed[i] / total_speed)) for i in active}

    def budget() -> int:
        return sum(m[i] * n[i] for i in active)

    # greedy repair to hit the exact layer budget
    guard = 0
    while budget() != N and guard < 4 * N:
        guard += 1
        if budget() < N:
            # add a layer where it hurts the minimax least
            i = min(active, key=lambda j: (n[j] + 1) / speed[j])
            n[i] += 1
        else:
            cands = [j for j in active if n[j] > 1]
            if not cands:
                return None
            i = max(cands, key=lambda j: n[j] / speed[j])
            n[i] -= 1
    if budget() != N:
        return None
    return HeteroPlacement(
        devices=tuple(names[i] for i in active),
        stages_per_type=tuple(m[i] for i in active),
        layers_per_stage=tuple(n[i] for i in active),
    )


def balanced_placements_for(
    arch: ModelArch,
    pool: HeteroPool,
    *,
    pipeline_parallel: int,
    devices_per_stage: int,
    prune_slack: Optional[float] = None,
) -> list[HeteroPlacement]:
    """All water-filled placements for one (P, D*T) cell, optionally pruned.

    The water-filling minimax of a composition m is bounded below by its
    fractional relaxation LB(m) = N / sum_i m_i * speed_i (the stage time
    when n_i is exactly proportional to per-layer speed). With
    ``prune_slack`` set, compositions are visited in ascending-LB order and
    enumeration stops once LB(m) exceeds ``prune_slack`` times the best
    *achieved* discrete minimax so far — those compositions cannot come
    within the slack of the best placement's layer-compute time, so their
    strategies are dominated. ``prune_slack`` > 1 absorbs the gap between
    the FLOPs-speed proxy and the simulator's full stage time; ``None``
    keeps the exhaustive composition sweep.

    Placements depend on (P, D*T) only, so callers cache this per cell and
    share it across the (tp, dp, mbs) cells with the same product.
    """
    dt = devices_per_stage
    caps = [cap // dt for _, cap in pool.type_caps]
    speed = [get_device(d).peak_flops_bf16 for d, _ in pool.type_caps]
    N = arch.num_layers

    def frac_minimax(m: Sequence[int]) -> float:
        total = sum(mi * sp for mi, sp in zip(m, speed))
        return N / total if total > 0 else float("inf")

    comps = list(compositions(pipeline_parallel, len(caps), caps))
    if prune_slack is not None:
        comps.sort(key=frac_minimax)

    out: list[HeteroPlacement] = []
    ub_best = float("inf")
    for m in comps:
        if prune_slack is not None and frac_minimax(m) > prune_slack * ub_best:
            break  # ascending LB order: every remaining composition is dominated
        pl = balanced_placement(
            arch, pool, pipeline_parallel=pipeline_parallel,
            data_parallel=1, tensor_parallel=dt, m=m,
        )
        if pl is None or pl.total_layers != N:
            continue
        if prune_slack is not None:
            # discrete minimax in the LB's units: max_i n_i / speed_i
            active = [i for i, mi in enumerate(m) if mi > 0]
            achieved = max(
                pl.layers_per_stage[j] / speed[active[j]]
                for j in range(len(active))
            )
            ub_best = min(ub_best, achieved)
        out.append(pl)
    return out


def count_hetero_cells(
    arch: ModelArch,
    pool: HeteroPool,
    global_batch: int,
    *,
    tensor_parallel_options: Sequence[int] = (1, 2, 4, 8),
    micro_batches: Sequence[int] = (1, 2, 4),
    pipeline_options: Optional[Sequence[int]] = None,
) -> int:
    """Exact number of (tp, pp, dp, mbs) cells
    :func:`iter_hetero_strategies` deals to its shard workers — the sweep
    arithmetic below MUST mirror that generator's loop structure (a cell is
    counted exactly when its ``cell`` counter advances there). Backends
    clamp mode-2 worker fan-out to this, so a tiny placement sweep never
    forks idle workers."""
    pps = pipeline_options or [
        p for p in (2, 4, 8, 16, 32, 64)
        if p <= min(arch.num_layers, pool.total_devices)
    ]
    cells = 0
    for tp in tensor_parallel_options:
        if not arch.is_attention_free and arch.heads % tp != 0:
            continue
        for pp in pps:
            max_dp = pool.total_devices // (tp * pp)
            for dp in (1, 2, 4, 8, 16, 32, 64, 128, 256):
                if dp > max_dp:
                    continue
                for mbs in micro_batches:
                    if global_batch % (dp * mbs) == 0:
                        cells += 1
    return cells


def iter_hetero_strategies(
    arch: ModelArch,
    pool: HeteroPool,
    global_batch: int,
    *,
    tensor_parallel_options: Sequence[int] = (1, 2, 4, 8),
    micro_batches: Sequence[int] = (1, 2, 4),
    pipeline_options: Optional[Sequence[int]] = None,
    fast: bool = False,
    base_kwargs: Optional[dict] = None,
    prune_slack: Optional[float] = None,
    shard: tuple[int, int] = (0, 1),
    indexed: bool = False,
) -> Iterable[ParallelStrategy]:
    """Full mode-2 space: (D, T, P) x stage placements.

    ``fast=True`` uses the water-filling solver (one placement per
    composition) with the placements of each (P, D*T) cell computed once and
    shared across the (tp, dp, mbs) cells that map onto it; ``fast=False``
    is the paper's full enumeration. ``prune_slack`` (fast mode only) skips
    compositions whose water-filling lower bound is dominated — see
    :func:`balanced_placements_for`.

    ``shard=(i, n)`` deals the (tp, pp, dp, mbs) *cells* round-robin to the
    n workers: a worker computes placements (the water-filling solve or the
    paper's full enumeration — the expensive generation work) only for the
    cells it owns, so mode-2 generation shards along with evaluation.
    ``indexed=True`` yields ``((cell_idx, placement_idx), strategy)`` pairs
    — the lexicographic serial stream position the mergeable collectors
    tie-break on (cells in sweep order, placements in order within a cell).
    """
    shard_i, shard_n = shard
    if not (0 <= shard_i < shard_n):
        raise ValueError(f"shard index {shard_i} not in [0, {shard_n})")
    base_kwargs = dict(base_kwargs or {})
    pps = pipeline_options or [
        p for p in (2, 4, 8, 16, 32, 64) if p <= min(arch.num_layers, pool.total_devices)
    ]
    primary = pool.type_caps[0][0]
    placement_cache: dict[tuple[int, int], list[HeteroPlacement]] = {}
    cell = -1
    for tp in tensor_parallel_options:
        if not arch.is_attention_free and arch.heads % tp != 0:
            continue
        for pp in pps:
            # NOTE: hetero stages need not divide num_layers evenly — Eq. 23's
            # layer assignments handle ragged splits, so no pp filter here.
            max_dp = pool.total_devices // (tp * pp)
            dps = [d for d in (1, 2, 4, 8, 16, 32, 64, 128, 256) if d <= max_dp]
            for dp in dps:
                for mbs in micro_batches:
                    if global_batch % (dp * mbs) != 0:
                        continue
                    # cell-level round-robin: skip BEFORE the placement
                    # solve, so non-owned cells cost nothing. The cell
                    # index advances identically for every worker (it
                    # depends only on the sweep structure), which is what
                    # keeps the shards an exact partition.
                    cell += 1
                    if (cell - shard_i) % shard_n:
                        continue
                    if fast:
                        key = (pp, dp * tp)
                        placements = placement_cache.get(key)
                        if placements is None:
                            placements = balanced_placements_for(
                                arch, pool, pipeline_parallel=pp,
                                devices_per_stage=dp * tp,
                                prune_slack=prune_slack,
                            )
                            placement_cache[key] = placements
                    else:
                        placements = enumerate_placements(
                            arch, pool, pipeline_parallel=pp,
                            data_parallel=dp, tensor_parallel=tp,
                        )
                    pl_idx = -1
                    for pl in placements:
                        if pl is None or pl.total_layers != arch.num_layers:
                            continue
                        pl_idx += 1
                        s = ParallelStrategy(
                            device=primary,
                            num_devices=pp * dp * tp,
                            pipeline_parallel=pp,
                            tensor_parallel=tp,
                            micro_batch_size=mbs,
                            hetero=pl,
                            **base_kwargs,
                        )
                        yield ((cell, pl_idx), s) if indexed else s
