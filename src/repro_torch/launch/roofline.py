"""Roofline terms of a dry-run cell on the H100, the counterpart of
``repro/launch/roofline.py``:

    compute term    = FLOPs / peak bf16 FLOP/s                  (per card)
    memory term     = HBM bytes / HBM bandwidth                 (per card)
    collective term = sum over collectives of
                      wire bytes / bandwidth of its slowest link (per card)

FLOPs, bytes and each collective's wire bytes come from the op accountant
(``op_account``), which counts what one rank runs; the constants are the
H100's in the port's catalog (``repro_torch.hw.catalog.H100``).

The JAX package's one link rate has no single counterpart on a cluster of
H100 nodes: 8 cards share a node over NVLink (``intra_node_bw``) and nodes
talk over InfiniBand (``inter_node_bw``). A collective runs at the rate of
the slowest link its group crosses: NVLink when every rank of the group lies
in one node (``rank // devices_per_node``), InfiniBand otherwise. On the
production meshes, 16x16 and 2x16x16 in row-major rank order, a "model"
group is 16 consecutive ranks (two nodes) and a "data" or "pod" group strides
across nodes, so every production collective runs at the InfiniBand rate.
"""
from __future__ import annotations

import dataclasses

from repro_torch.hw.catalog import H100

PEAK_FLOPS = H100.peak_flops_bf16
HBM_BW = H100.mem_bw
INTRA_NODE_BW = H100.intra_node_bw
INTER_NODE_BW = H100.inter_node_bw
DEVICES_PER_NODE = H100.devices_per_node
MEM_BYTES = H100.mem_bytes


def link_bw(ranks) -> float:
    """The rate of the slowest link a group of global ``ranks`` crosses."""
    nodes = {r // DEVICES_PER_NODE for r in ranks}
    return INTRA_NODE_BW if len(nodes) <= 1 else INTER_NODE_BW


def _wire_bytes(op: str, result_bytes: float, g: int) -> float:
    """Ring-model per-participant wire traffic."""
    if g <= 1:
        return 0.0
    if op == "all-gather":  # result is the gathered (full) tensor
        return result_bytes * (g - 1) / g
    if op == "all-reduce":  # result is the full tensor
        return 2.0 * result_bytes * (g - 1) / g
    if op == "reduce-scatter":  # result is one shard
        return result_bytes * (g - 1)
    if op == "all-to-all":
        return result_bytes * (g - 1) / g
    if op == "collective-permute":
        return result_bytes
    return 0.0


@dataclasses.dataclass
class RooflineReport:
    flops: float
    hbm_bytes: float
    wire_bytes: float
    chips: int
    model_flops_total: float  # useful flops for the whole step, all chips
    # sum over the collectives of wire bytes / their link's rate
    link_s: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.link_s

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        hlo_total = self.flops * self.chips
        return self.model_flops_total / hlo_total if hlo_total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful-FLOPs MFU at the modeled bound: what fraction of peak the
        card would sustain if the step ran exactly at max(term)."""
        if self.bound_s <= 0:
            return 0.0
        useful_per_chip = self.model_flops_total / self.chips
        return useful_per_chip / (self.bound_s * PEAK_FLOPS)

    def to_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "wire_bytes_per_chip": self.wire_bytes,
            "chips": self.chips,
            "model_flops_total": self.model_flops_total,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(arch, shape) -> float:
    """Useful-work estimate for one step (all chips), standard conventions:
    train: 6*N_active*tokens (+attention); fwd-only: 2*N_active*tokens."""
    N = arch.total_active_params()
    toks = shape.tokens_per_step
    if shape.kind == "train":
        base = 6.0 * N * toks
    else:
        base = 2.0 * N * toks
    # attention score/value FLOPs (not in N): 2*2*S_kv*q_dim per token per layer
    if not arch.is_attention_free:
        kv = min(shape.seq_len, arch.sliding_window or shape.seq_len)
        per_tok = 4.0 * kv * arch.attn_q_dim * (0.5 if shape.kind != "decode" else 1.0)
        layers = arch.num_layers + arch.encoder_layers
        mult = 3.0 if shape.kind == "train" else 1.0
        base += mult * per_tok * layers * toks
    return base
