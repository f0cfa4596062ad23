"""Operator descriptors shared by the cost model, calibration and simulator.

Astra's distinguishing feature (§3.5) is that operator latency is computed
*analytically* — theta (work) from the op's algebraic shape, phi (peak rate)
from the device spec — with only the efficiency eta in (0,1] learned. These
descriptors carry exactly the information needed for that: the work term and
the features the eta model conditions on.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.hw.catalog import DeviceSpec, DEVICES

# stable integer ids for categorical features
COMPUTE_KINDS = ("matmul", "flash_attn", "attn", "elementwise", "norm", "embedding")
COMM_KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all", "p2p")
DEVICE_NAMES = tuple(sorted(DEVICES))
_DEVICE_IDS = {name: i for i, name in enumerate(DEVICE_NAMES)}
DEVICE_IDS = _DEVICE_IDS

# device-constant arrays indexed by the stable id — shared by every
# vectorized path (featurization here, the analytic prior in calibration)
PEAK_FLOPS = np.array([DEVICES[n].peak_flops_bf16 for n in DEVICE_NAMES])
MEM_BW = np.array([DEVICES[n].mem_bw for n in DEVICE_NAMES])
INTRA_BW = np.array([DEVICES[n].intra_node_bw for n in DEVICE_NAMES])
INTER_BW = np.array([DEVICES[n].inter_node_bw for n in DEVICE_NAMES])
MACHINE_BALANCE = PEAK_FLOPS / MEM_BW


def gather_attr(ops: "Sequence", attr: str, dtype=np.float64) -> np.ndarray:
    """One float array from an op attribute (the vectorization workhorse)."""
    return np.fromiter(
        (getattr(op, attr) for op in ops), dtype=dtype, count=len(ops)
    )


def gather_device_ids(ops: "Sequence") -> np.ndarray:
    return np.fromiter(
        (_DEVICE_IDS[op.device] for op in ops), dtype=np.intp, count=len(ops)
    )


@dataclasses.dataclass(frozen=True)
class ComputeOp:
    """One compute operator instance on one device type.

    ``m, n, k`` are the GEMM-like dims (for non-matmul ops, m = elements and
    n = k = 1). ``flops`` and ``bytes_accessed`` are the analytic theta terms.
    """

    kind: str
    device: str
    m: int
    n: int
    k: int
    flops: float
    bytes_accessed: float
    dtype_bytes: int = 2

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.bytes_accessed, 1.0)

    def features(self) -> np.ndarray:
        def quant(tile: int) -> float:
            c = lambda x: ((max(x, 1) + tile - 1) // tile) * tile
            return (self.m * self.n * self.k) / (c(self.m) * c(self.n) * c(self.k))

        dev = DEVICES[self.device]
        ai_ratio = self.arithmetic_intensity / dev.machine_balance
        return np.array(
            [
                COMPUTE_KINDS.index(self.kind),
                _DEVICE_IDS[self.device],
                np.log2(max(self.m, 1)),
                np.log2(max(self.n, 1)),
                np.log2(max(self.k, 1)),
                quant(64),
                quant(128),
                np.log2(max(self.flops, 1.0)),
                np.log2(max(self.bytes_accessed, 1.0)),
                np.log2(max(self.arithmetic_intensity, 1e-3)),
                min(ai_ratio, 1.0),
                np.log2(max(ai_ratio, 1e-6)),
                float(self.dtype_bytes),
            ],
            dtype=np.float64,
        )


@dataclasses.dataclass(frozen=True)
class CommOp:
    """One collective instance: payload bytes over a group on one device type."""

    kind: str
    device: str
    group: int
    payload_bytes: float
    intra_node: bool  # fast tier (NVLink/ICI) vs slow tier (PCIe/IB/DCN)

    def features(self) -> np.ndarray:
        # saturation proxy: payload relative to a 1MiB/8MiB half-saturation knee
        half = (1 << 20) if self.intra_node else (8 << 20)
        sat = self.payload_bytes / (self.payload_bytes + half)
        return np.array(
            [
                COMM_KINDS.index(self.kind),
                _DEVICE_IDS[self.device],
                np.log2(max(self.group, 1)),
                np.log2(max(self.payload_bytes, 1.0)),
                np.log2(max(self.payload_bytes / max(self.group, 1), 1.0)),
                sat,
                float(self.intra_node),
            ],
            dtype=np.float64,
        )


def matmul_op(device: str, m: int, n: int, k: int, dtype_bytes: int = 2) -> ComputeOp:
    flops = 2.0 * m * n * k
    bytes_accessed = dtype_bytes * (m * k + k * n + m * n)
    return ComputeOp(
        kind="matmul", device=device, m=m, n=n, k=k,
        flops=flops, bytes_accessed=bytes_accessed, dtype_bytes=dtype_bytes,
    )


def elementwise_op(device: str, elements: int, dtype_bytes: int = 2, reads: int = 2) -> ComputeOp:
    return ComputeOp(
        kind="elementwise", device=device, m=elements, n=1, k=1,
        flops=float(elements), bytes_accessed=float(dtype_bytes * elements * (reads + 1)),
        dtype_bytes=dtype_bytes,
    )


def featurize_compute(ops: Sequence[ComputeOp]) -> np.ndarray:
    """Vectorized feature matrix; row i == ``ops[i].features()`` exactly.

    One NumPy pass per column instead of one 13-element array per op — this
    is the GBT-prediction hot path (every cold-cache chunk featurizes all
    its unseen ops). The quantization columns stay in exact integer
    arithmetic (``m*n*k`` overflows int64 for the optimizer-update shapes),
    matching the per-op path bit for bit.
    """
    if not len(ops):
        return np.zeros((0, 13))
    kind = np.fromiter((COMPUTE_KINDS.index(op.kind) for op in ops),
                       dtype=np.float64, count=len(ops))
    dev = gather_device_ids(ops)
    m, n, k = gather_attr(ops, "m"), gather_attr(ops, "n"), gather_attr(ops, "k")
    flops = gather_attr(ops, "flops")
    nbytes = gather_attr(ops, "bytes_accessed")
    dtype_bytes = gather_attr(ops, "dtype_bytes")

    def quant(tile: int) -> np.ndarray:
        # exact Python-int arithmetic (the products exceed 2**53)
        def c(x: int) -> int:
            return ((max(x, 1) + tile - 1) // tile) * tile

        return np.fromiter(
            (
                (op.m * op.n * op.k) / (c(op.m) * c(op.n) * c(op.k))
                for op in ops
            ),
            dtype=np.float64, count=len(ops),
        )

    ai = flops / np.maximum(nbytes, 1.0)
    ai_ratio = ai / MACHINE_BALANCE[dev]
    cols = [
        kind,
        dev.astype(np.float64),
        np.log2(np.maximum(m, 1)),
        np.log2(np.maximum(n, 1)),
        np.log2(np.maximum(k, 1)),
        quant(64),
        quant(128),
        np.log2(np.maximum(flops, 1.0)),
        np.log2(np.maximum(nbytes, 1.0)),
        np.log2(np.maximum(ai, 1e-3)),
        np.minimum(ai_ratio, 1.0),
        np.log2(np.maximum(ai_ratio, 1e-6)),
        dtype_bytes,
    ]
    return np.stack(cols, axis=1)


def featurize_comm(ops: Sequence[CommOp]) -> np.ndarray:
    """Vectorized feature matrix; row i == ``ops[i].features()`` exactly."""
    if not len(ops):
        return np.zeros((0, 7))
    kind = np.fromiter((COMM_KINDS.index(op.kind) for op in ops),
                       dtype=np.float64, count=len(ops))
    dev = gather_device_ids(ops).astype(np.float64)
    group = gather_attr(ops, "group")
    payload = gather_attr(ops, "payload_bytes")
    intra = np.fromiter((op.intra_node for op in ops), dtype=np.float64,
                        count=len(ops))
    half = np.where(intra > 0, float(1 << 20), float(8 << 20))
    sat = payload / (payload + half)
    cols = [
        kind,
        dev,
        np.log2(np.maximum(group, 1.0)),
        np.log2(np.maximum(payload, 1.0)),
        np.log2(np.maximum(payload / np.maximum(group, 1.0), 1.0)),
        sat,
        intra,
    ]
    return np.stack(cols, axis=1)


def device_spec(op) -> DeviceSpec:
    return DEVICES[op.device]
