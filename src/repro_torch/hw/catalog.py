"""Accelerator device catalog.

Specs are public list numbers (dense bf16 TFLOP/s, HBM capacity/bandwidth,
interconnect). Prices are representative on-demand cloud list prices in $/hr —
the paper does not disclose its fee table (DESIGN.md §6.5), so the money-mode
experiments use these.

The ``ici_bw`` field is the *per-link, per-direction* bandwidth used by the
topology model in :mod:`repro_torch.hw.topology`; ``intra_node_bw`` is the all-lane
aggregate a single device can drive inside its node/pod.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

GB = 1e9
TFLOPS = 1e12


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """One accelerator type."""

    name: str
    kind: str  # "gpu" | "tpu"
    peak_flops_bf16: float  # FLOP/s, dense
    mem_bytes: float  # HBM capacity
    mem_bw: float  # HBM bandwidth, bytes/s
    intra_node_bw: float  # bytes/s one device can drive inside a node/pod
    inter_node_bw: float  # bytes/s one device can drive across nodes/pods
    devices_per_node: int  # devices sharing the fast domain
    price_per_hour: float  # $/device/hr, on-demand
    tdp_watts: float = 400.0  # board power (TDP) for the energy/carbon model

    @property
    def price_per_second(self) -> float:
        return self.price_per_hour / 3600.0

    @property
    def machine_balance(self) -> float:
        """FLOPs per HBM byte at the roofline ridge point."""
        return self.peak_flops_bf16 / self.mem_bw


# --- The paper's GPUs (used by the reproduced experiments) -------------------
A800 = DeviceSpec(
    name="A800",
    kind="gpu",
    peak_flops_bf16=312 * TFLOPS,
    mem_bytes=80 * GB,
    mem_bw=2039 * GB,
    intra_node_bw=400 * GB,  # A800 = A100 with NVLink capped at 400 GB/s
    inter_node_bw=25 * GB,  # 200 Gb/s IB/PCIe per GPU
    devices_per_node=8,
    price_per_hour=1.90,
    tdp_watts=400.0,
)

H100 = DeviceSpec(
    name="H100",
    kind="gpu",
    peak_flops_bf16=989 * TFLOPS,
    mem_bytes=80 * GB,
    mem_bw=3350 * GB,
    intra_node_bw=900 * GB,
    inter_node_bw=50 * GB,  # 400 Gb/s IB per GPU
    devices_per_node=8,
    price_per_hour=3.90,
    tdp_watts=700.0,
)

H800 = DeviceSpec(
    name="H800",
    kind="gpu",
    peak_flops_bf16=989 * TFLOPS,
    mem_bytes=80 * GB,
    mem_bw=3350 * GB,
    intra_node_bw=400 * GB,  # H800 = H100 with NVLink capped at 400 GB/s
    inter_node_bw=50 * GB,
    devices_per_node=8,
    price_per_hour=3.20,
    tdp_watts=700.0,
)

A100 = DeviceSpec(
    name="A100",
    kind="gpu",
    peak_flops_bf16=312 * TFLOPS,
    mem_bytes=80 * GB,
    mem_bw=2039 * GB,
    intra_node_bw=600 * GB,
    inter_node_bw=25 * GB,
    devices_per_node=8,
    price_per_hour=2.20,
    tdp_watts=400.0,
)

# --- TPUs (execution target; v5e constants match the assignment) ------------
TPU_V5E = DeviceSpec(
    name="tpu-v5e",
    kind="tpu",
    peak_flops_bf16=197 * TFLOPS,
    mem_bytes=16 * GB,
    mem_bw=819 * GB,
    intra_node_bw=50 * GB,  # ~50 GB/s per ICI link (assignment constant)
    inter_node_bw=12.5 * GB,  # DCN per chip
    devices_per_node=256,  # one v5e pod-slice = 16x16 torus
    price_per_hour=1.20,
    tdp_watts=200.0,
)

TPU_V5P = DeviceSpec(
    name="tpu-v5p",
    kind="tpu",
    peak_flops_bf16=459 * TFLOPS,
    mem_bytes=95 * GB,
    mem_bw=2765 * GB,
    intra_node_bw=90 * GB,
    inter_node_bw=25 * GB,
    devices_per_node=256,
    price_per_hour=4.20,
    tdp_watts=400.0,
)

DEVICES: Dict[str, DeviceSpec] = {
    d.name: d for d in (A800, H100, H800, A100, TPU_V5E, TPU_V5P)
}


def get_device(name: str) -> DeviceSpec:
    try:
        return DEVICES[name]
    except KeyError:
        raise KeyError(
            f"unknown device {name!r}; known: {sorted(DEVICES)}"
        ) from None
