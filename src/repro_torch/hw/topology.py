"""Cluster topology and collective traffic model.

The paper's topology (§4: 8-GPU NVLink nodes, PCIe across nodes) generalizes
to a two-tier model: a *fast domain* (NVLink node / ICI pod) and a *slow
domain* (PCIe/IB / DCN). A communicator group of size ``g`` is placed in the
fast domain when it fits inside one node, otherwise its bottleneck is the
slow tier. Collective time is then

    T_comm = bytes_on_wire(algorithm, g, payload) / (bw * eta_comm)

which is exactly the paper's Eq. 26 with theta_comm = bytes_on_wire and
phi_comm the tier bandwidth; eta_comm comes from the learned model.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.hw.catalog import DeviceSpec, get_device


def collective_bytes_on_wire(kind: str, group: int, payload_bytes: float) -> float:
    """Bytes each participant sends for a bandwidth-optimal (ring) algorithm.

    ``payload_bytes`` is the logical tensor size (full tensor for all-reduce /
    all-gather result; per-shard input for reduce-scatter is payload/group).
    """
    if group <= 1:
        return 0.0
    g = float(group)
    if kind == "all_reduce":
        return 2.0 * (g - 1.0) / g * payload_bytes
    if kind in ("all_gather", "reduce_scatter"):
        return (g - 1.0) / g * payload_bytes
    if kind == "all_to_all":
        return (g - 1.0) / g * payload_bytes
    if kind in ("p2p", "send_recv", "collective_permute"):
        return payload_bytes
    if kind == "broadcast":
        return payload_bytes
    raise ValueError(f"unknown collective kind {kind!r}")


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """A homogeneous group of devices within a (possibly mixed) cluster.

    Heterogeneous clusters are lists of ClusterSpecs (one per device type);
    see :mod:`repro_torch.core.hetero`.
    """

    device: DeviceSpec
    num_devices: int

    @staticmethod
    def of(name: str, num_devices: int) -> "ClusterSpec":
        return ClusterSpec(device=get_device(name), num_devices=num_devices)

    def group_bandwidth(self, group: int, *, hint: Optional[str] = None) -> float:
        """Per-device bandwidth available to a communicator of size ``group``.

        ``hint`` forces a tier ("intra" / "inter"); by default a group that
        fits inside one fast domain uses the fast tier.
        """
        if hint == "intra":
            return self.device.intra_node_bw
        if hint == "inter":
            return self.device.inter_node_bw
        if group <= self.device.devices_per_node:
            return self.device.intra_node_bw
        return self.device.inter_node_bw

    def collective_time(
        self,
        kind: str,
        group: int,
        payload_bytes: float,
        eta: float = 1.0,
        *,
        hint: Optional[str] = None,
    ) -> float:
        """Seconds for one collective at efficiency ``eta`` (paper Eq. 26)."""
        wire = collective_bytes_on_wire(kind, group, payload_bytes)
        if wire == 0.0:
            return 0.0
        bw = self.group_bandwidth(group, hint=hint)
        return wire / (bw * max(eta, 1e-6))
