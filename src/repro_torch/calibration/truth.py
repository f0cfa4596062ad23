"""Ground-truth cluster simulator: the stand-in for "measured" latencies.

The functional form encodes the non-idealities real accelerators exhibit;
the eta model (repro_torch/calibration/fit.py) never sees these formulas — it only
sees (features, measured latency) samples, exactly as the paper's XGBoost
only sees measured MegatronLM operator timings.

Compute:  T = flops / (peak * eta_true) + overhead
  eta_true = base_eff(kind, device)
           * tile_quantization(m, n, k)          # MXU/tensor-core padding
           * min(1, AI / machine_balance)^p      # memory-bound rolloff
  (elementwise/norm ops are modeled bandwidth-side: T = bytes/(bw*eff)+oh)

Comm:     T = wire_bytes / (bw * eta_true) + latency(group)
  eta_true = sustained_frac * msg/(msg + half_saturation)

Jitter: multiplicative lognormal, sigma configurable (0 => deterministic).

Drift knobs: ``base_eff_scale`` / ``comm_eff_scale`` multiply the hidden
sustained efficiencies, modeling the cluster changing underneath a fitted
eta model (driver regression, thermal derating, congested fabric). The
defaults (1.0) are exact no-ops, so an undrifted ``GroundTruth`` is
bit-identical to the pre-drift-knob one. The calibration feedback loop
(:mod:`repro_torch.calibration.loop`) uses a drifted truth as the stand-in for
"the measurements stopped matching the model".
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.opspec import ComputeOp, CommOp
from repro_torch.hw.catalog import DEVICES
from repro_torch.hw.topology import collective_bytes_on_wire

_BASE_EFF = {  # sustained fraction of peak for large aligned ops
    "gpu": {"matmul": 0.88, "flash_attn": 0.62, "attn": 0.40,
            "elementwise": 0.85, "norm": 0.70, "embedding": 0.55},
    "tpu": {"matmul": 0.90, "flash_attn": 0.65, "attn": 0.45,
            "elementwise": 0.88, "norm": 0.75, "embedding": 0.60},
}
_TILE = {"gpu": 64, "tpu": 128}  # effective pad granularity on the systolic unit
_LAUNCH_OVERHEAD_S = {"gpu": 4e-6, "tpu": 2e-6}
_COMM_SUSTAINED = 0.82
_COMM_HALF_SAT = {True: 1 << 20, False: 8 << 20}  # bytes; intra vs inter tier
_COMM_LAT_PER_HOP = {True: 2e-6, False: 12e-6}


def _ceil_to(x: int, t: int) -> int:
    return ((max(x, 1) + t - 1) // t) * t


@dataclasses.dataclass
class GroundTruth:
    """Deterministic-by-seed simulated 'measurements'."""

    jitter_sigma: float = 0.02
    seed: int = 0
    # drift knobs (1.0 = no drift): scale the hidden sustained efficiencies
    base_eff_scale: float = 1.0  # compute: multiplies every _BASE_EFF entry
    comm_eff_scale: float = 1.0  # comm: multiplies _COMM_SUSTAINED

    def __post_init__(self):
        if self.base_eff_scale <= 0 or self.comm_eff_scale <= 0:
            raise ValueError("drift scales must be positive")
        self._rng = np.random.default_rng(self.seed)

    def _jitter(self) -> float:
        if self.jitter_sigma <= 0:
            return 1.0
        return float(np.exp(self._rng.normal(0.0, self.jitter_sigma)))

    # -- compute ---------------------------------------------------------
    def compute_eta(self, op: ComputeOp) -> float:
        """The hidden true efficiency (no jitter) — used only for analysis."""
        dev = DEVICES[op.device]
        base = _BASE_EFF[dev.kind][op.kind] * self.base_eff_scale
        tile = _TILE[dev.kind]
        if op.kind in ("matmul", "flash_attn", "attn"):
            quant = (op.m * op.n * op.k) / (
                _ceil_to(op.m, tile) * _ceil_to(op.n, tile) * _ceil_to(op.k, tile)
            )
            ai_factor = min(1.0, op.arithmetic_intensity / dev.machine_balance) ** 0.6
            return base * quant * ai_factor
        # bandwidth-bound ops: express efficiency against FLOP peak so that
        # T = flops/(peak*eta) still holds (eta is tiny, as it is in reality)
        t_bw = op.bytes_accessed / (dev.mem_bw * base)
        return op.flops / (dev.peak_flops_bf16 * t_bw)

    def compute_time(self, op: ComputeOp) -> float:
        dev = DEVICES[op.device]
        eta = self.compute_eta(op)
        t = op.flops / (dev.peak_flops_bf16 * max(eta, 1e-9))
        return (t + _LAUNCH_OVERHEAD_S[dev.kind]) * self._jitter()

    # -- communication ----------------------------------------------------
    def comm_eta(self, op: CommOp) -> float:
        msg = op.payload_bytes
        sustained = _COMM_SUSTAINED * self.comm_eff_scale
        return sustained * msg / (msg + _COMM_HALF_SAT[op.intra_node])

    def comm_time(self, op: CommOp) -> float:
        dev = DEVICES[op.device]
        wire = collective_bytes_on_wire(op.kind, op.group, op.payload_bytes)
        if wire == 0.0:
            return 0.0
        bw = dev.intra_node_bw if op.intra_node else dev.inter_node_bw
        eta = self.comm_eta(op)
        lat = _COMM_LAT_PER_HOP[op.intra_node] * max(op.group - 1, 1)
        return (wire / (bw * max(eta, 1e-9)) + lat) * self._jitter()
