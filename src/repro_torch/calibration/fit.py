"""Train the eta model (paper §3.5) against the ground-truth simulator.

Formulation: the paper predicts eta in (0,1] with T = theta/(phi*eta). Raw
log-eta is a steep function of op size (launch-overhead-dominated small ops
have eta ~ 1e-6), which piecewise-constant trees approximate poorly. We
therefore boost the *residual* over a smooth analytic prior:

    T_hat(op) = T_analytic(op) * exp(GBT(features(op)))

and report eta_hat = theta/(phi * T_hat), clipped into (0,1]. This is
algebraically the paper's formulation (eta is still the learned quantity, the
analytic prior is just a feature transform) and matches how production cost
models are calibrated.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.opspec import (
    COMM_KINDS,
    COMPUTE_KINDS,
    INTER_BW,
    INTRA_BW,
    MACHINE_BALANCE,
    MEM_BW,
    PEAK_FLOPS,
    CommOp,
    ComputeOp,
    featurize_comm,
    featurize_compute,
    gather_attr,
    gather_device_ids,
)
from repro_torch.gbt import GradientBoostedTrees
from repro_torch.calibration.truth import GroundTruth
from repro_torch.hw.catalog import DEVICES
from repro_torch.hw.topology import collective_bytes_on_wire

_BASE_OVERHEAD_S = 3e-6  # analytic-prior launch overhead guess
_BASE_COMM_LAT_S = 6e-6  # analytic-prior per-hop latency guess

_MM_KINDS = frozenset({"matmul", "flash_attn", "attn"})

# ring-collective bytes-on-wire multiplier of (g-1)/g by comm kind, mirroring
# repro_torch.hw.topology.collective_bytes_on_wire; full-payload kinds carry -1.
# Kinds outside both tables fall back to the scalar reference below, so the
# two implementations can never diverge on a new collective.
_WIRE_GFRAC = {"all_reduce": 2.0, "all_gather": 1.0, "reduce_scatter": 1.0,
               "all_to_all": 1.0}
_WIRE_FULL = frozenset({"p2p", "send_recv", "collective_permute", "broadcast"})


def _wire_bytes(ops: Sequence[CommOp]) -> np.ndarray:
    """Vectorized :func:`collective_bytes_on_wire` over a CommOp array."""
    if any(op.kind not in _WIRE_GFRAC and op.kind not in _WIRE_FULL
           for op in ops):
        # rare/new kind: defer entirely to the scalar reference
        return np.array([
            collective_bytes_on_wire(op.kind, op.group, op.payload_bytes)
            for op in ops
        ])
    g = gather_attr(ops, "group")
    payload = gather_attr(ops, "payload_bytes")
    factor = np.fromiter(
        (_WIRE_GFRAC.get(op.kind, -1.0) for op in ops),
        dtype=np.float64, count=len(ops),
    )
    frac = np.where(factor > 0, factor * (g - 1.0) / np.maximum(g, 1.0), 1.0)
    return np.where(g <= 1, 0.0, frac * payload)


class AnalyticEtaModel:
    """Closed-form prior. Usable standalone (uncalibrated fallback) and as
    the baseline the GBT residual is boosted from.

    ``compute_times`` / ``comm_times`` are the vectorized batch entry points
    the simulators use (one NumPy pass over op arrays instead of a Python
    loop); the scalar ``compute_time`` / ``comm_time`` remain the reference
    definitions and the two agree exactly (tests/test_eta_vectorized.py).
    """

    def version_string(self) -> str:
        """Registry identity. The analytic prior has no learned state, so a
        fixed tag (bump the suffix if the closed form ever changes)."""
        return "analytic-1"

    def compute_time(self, op: ComputeOp) -> float:
        dev = DEVICES[op.device]
        if op.kind in ("matmul", "flash_attn", "attn"):
            eta = 0.75 * min(1.0, op.arithmetic_intensity / dev.machine_balance)
            t = op.flops / (dev.peak_flops_bf16 * max(eta, 1e-9))
        else:
            t = op.bytes_accessed / (dev.mem_bw * 0.8)
        return t + _BASE_OVERHEAD_S

    def comm_time(self, op: CommOp) -> float:
        wire = collective_bytes_on_wire(op.kind, op.group, op.payload_bytes)
        if wire == 0.0:
            return 0.0
        dev = DEVICES[op.device]
        bw = dev.intra_node_bw if op.intra_node else dev.inter_node_bw
        half = (1 << 20) if op.intra_node else (8 << 20)
        eta = 0.8 * op.payload_bytes / (op.payload_bytes + half)
        return wire / (bw * max(eta, 1e-9)) + _BASE_COMM_LAT_S * max(op.group - 1, 1)

    # -- vectorized batch predictions --------------------------------------
    def compute_times(self, ops: Sequence[ComputeOp]) -> np.ndarray:
        """One vectorized pass over op arrays; == [compute_time(op)] exactly
        (same IEEE operations in the same order)."""
        if not len(ops):
            return np.zeros(0)
        dev = gather_device_ids(ops)
        is_mm = np.fromiter((op.kind in _MM_KINDS for op in ops), dtype=bool,
                            count=len(ops))
        flops = gather_attr(ops, "flops")
        nbytes = gather_attr(ops, "bytes_accessed")
        ai = flops / np.maximum(nbytes, 1.0)
        eta = 0.75 * np.minimum(1.0, ai / MACHINE_BALANCE[dev])
        t_mm = flops / (PEAK_FLOPS[dev] * np.maximum(eta, 1e-9))
        t_mem = nbytes / (MEM_BW[dev] * 0.8)
        return np.where(is_mm, t_mm, t_mem) + _BASE_OVERHEAD_S

    def comm_times(self, ops: Sequence[CommOp]) -> np.ndarray:
        if not len(ops):
            return np.zeros(0)
        dev = gather_device_ids(ops)
        intra = np.fromiter((op.intra_node for op in ops), dtype=bool,
                            count=len(ops))
        g = gather_attr(ops, "group")
        payload = gather_attr(ops, "payload_bytes")
        wire = _wire_bytes(ops)
        bw = np.where(intra, INTRA_BW[dev], INTER_BW[dev])
        half = np.where(intra, float(1 << 20), float(8 << 20))
        eta = 0.8 * payload / (payload + half)
        t = wire / (bw * np.maximum(eta, 1e-9)) + _BASE_COMM_LAT_S * np.maximum(
            g - 1.0, 1.0
        )
        return np.where(wire == 0.0, 0.0, t)

    # eta views (paper Eq. 25/26), derived from time
    def eta_compute(self, ops: Sequence[ComputeOp]) -> np.ndarray:
        if not len(ops):
            return np.zeros(0)
        t = self.compute_times(ops)
        flops = gather_attr(ops, "flops")
        return np.clip(flops / (PEAK_FLOPS[gather_device_ids(ops)] * t), 1e-9, 1.0)

    def eta_comm(self, ops: Sequence[CommOp]) -> np.ndarray:
        if not len(ops):
            return np.zeros(0)
        t = self.comm_times(ops)
        dev = gather_device_ids(ops)
        intra = np.fromiter((op.intra_node for op in ops), dtype=bool,
                            count=len(ops))
        wire = _wire_bytes(ops)
        bw = np.where(intra, INTRA_BW[dev], INTER_BW[dev])
        with np.errstate(divide="ignore", invalid="ignore"):
            eta = np.clip(wire / (bw * t), 1e-9, 1.0)
        return np.where(t > 0, eta, 1.0)


@dataclasses.dataclass
class EtaModel:
    """GBT-calibrated cost model (the paper's XGBoost component)."""

    comp_model: GradientBoostedTrees
    comm_model: GradientBoostedTrees
    prior: AnalyticEtaModel = dataclasses.field(default_factory=AnalyticEtaModel)

    # -- time predictions -------------------------------------------------
    def compute_times(self, ops: Sequence[ComputeOp]) -> np.ndarray:
        if not ops:
            return np.zeros(0)
        base = self.prior.compute_times(ops)  # vectorized analytic prior
        corr = np.exp(self.comp_model.predict(featurize_compute(ops)))
        return base * corr

    def comm_times(self, ops: Sequence[CommOp]) -> np.ndarray:
        if not ops:
            return np.zeros(0)
        base = self.prior.comm_times(ops)  # vectorized analytic prior
        corr = np.exp(self.comm_model.predict(featurize_comm(ops)))
        return base * corr

    # -- eta views (paper Eq. 25/26) --------------------------------------
    def eta_compute(self, ops: Sequence[ComputeOp]) -> np.ndarray:
        t = self.compute_times(ops)
        theta_over_phi = np.array(
            [op.flops / DEVICES[op.device].peak_flops_bf16 for op in ops]
        )
        return np.clip(theta_over_phi / np.maximum(t, 1e-12), 1e-9, 1.0)

    def eta_comm(self, ops: Sequence[CommOp]) -> np.ndarray:
        t = self.comm_times(ops)
        out = np.zeros(len(ops))
        for i, op in enumerate(ops):
            wire = collective_bytes_on_wire(op.kind, op.group, op.payload_bytes)
            dev = DEVICES[op.device]
            bw = dev.intra_node_bw if op.intra_node else dev.inter_node_bw
            out[i] = np.clip(wire / (bw * max(t[i], 1e-12)), 1e-9, 1.0)
        return out

    def prepare(self) -> "EtaModel":
        """Pre-build both GBTs' flat-forest node arrays (otherwise built
        lazily on the first predict). The evaluation engines call this at
        construction so long-lived warm engines — the serial backend's
        shared pair, each pool worker's private one — pay the flattening
        cost once, off the search hot path."""
        self.comp_model.forest()
        self.comm_model.forest()
        return self

    # -- identity ---------------------------------------------------------
    def to_dict(self) -> dict:
        return {"comp": self.comp_model.to_dict(), "comm": self.comm_model.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "EtaModel":
        return cls(
            comp_model=GradientBoostedTrees.from_dict(d["comp"]),
            comm_model=GradientBoostedTrees.from_dict(d["comm"]),
        )

    def version_string(self) -> str:
        """Content hash of the learned trees: identical models (however they
        were obtained) share a version; any refit that changes a single split
        gets a new one. Cached — tree state never mutates after fit."""
        cached = getattr(self, "_version", None)
        if cached is None:
            canon = json.dumps(self.to_dict(), sort_keys=True, separators=(",", ":"))
            cached = "eta-" + hashlib.sha256(canon.encode("utf-8")).hexdigest()[:16]
            self._version = cached
        return cached

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "EtaModel":
        with open(path) as f:
            d = json.load(f)
        return cls.from_dict(d)


# ---------------------------------------------------------------------------
# dataset sampling
# ---------------------------------------------------------------------------

def sample_compute_ops(
    rng: np.random.Generator, n: int, devices: Sequence[str]
) -> list[ComputeOp]:
    """Random op shapes spanning the ranges a transformer census produces."""
    ops = []
    for _ in range(n):
        device = str(rng.choice(list(devices)))
        kind = str(rng.choice(COMPUTE_KINDS))
        # log-uniform dims; aligned to 128 half the time (as real models are).
        # Ranges and flops/bytes signatures must COVER the operator census
        # repro_torch/core/costmodel.py emits (m = b*s reaches 2^21; optimizer
        # elementwise ops reach 2^33 elements) — tree models neither
        # extrapolate nor generalize across flops-to-bytes ratios they never
        # saw. This mirrors the paper's method of training on operators
        # sampled from real runs.
        def dim(lo=4, hi=21):
            d = int(2 ** rng.uniform(lo, hi))
            if rng.random() < 0.5:
                d = max(1, (d // 128) * 128)
            return max(d, 1)

        if kind in ("matmul", "flash_attn", "attn"):
            m, n_, k = dim(), dim(4, 17), dim(4, 17)
            flops = 2.0 * m * n_ * k
            bytes_accessed = 2.0 * (m * k + k * n_ + m * n_)
        elif kind == "norm":
            m, n_, k = dim(8, 31), 1, 1
            flops = 4.0 * m
            bytes_accessed = 6.0 * m
        elif kind == "embedding":
            m, n_, k = dim(8, 31), 1, 1
            flops = float(m)
            bytes_accessed = 4.0 * m
        else:  # elementwise: generic activations AND optimizer-update shapes
            m, n_, k = dim(8, 33), 1, 1
            if rng.random() < 0.5:
                flops, bytes_accessed = 10.0 * m, 18.0 * m  # adam update
            else:
                flops, bytes_accessed = float(m), 6.0 * m
        ops.append(
            ComputeOp(kind=kind, device=device, m=m, n=n_, k=k,
                      flops=flops, bytes_accessed=bytes_accessed)
        )
    return ops


def sample_comm_ops(
    rng: np.random.Generator, n: int, devices: Sequence[str]
) -> list[CommOp]:
    ops = []
    for _ in range(n):
        device = str(rng.choice(list(devices)))
        kind = str(rng.choice(COMM_KINDS))
        group = int(2 ** rng.integers(1, 13))
        payload = float(2 ** rng.uniform(10, 36))
        intra = bool(group <= DEVICES[device].devices_per_node and rng.random() < 0.7)
        ops.append(CommOp(kind=kind, device=device, group=group,
                          payload_bytes=payload, intra_node=intra))
    return ops


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

_LEARNING_RATE = 0.08  # shared by train and refit so warm starts compose


def _residual_targets(
    prior: AnalyticEtaModel,
    samples: Sequence[tuple],
    *,
    comm: bool,
) -> tuple[np.ndarray, np.ndarray]:
    """(features, log-residual targets) for measured (op, seconds) pairs."""
    ops = [op for op, _ in samples]
    t_meas = np.array([t for _, t in samples], dtype=np.float64)
    if comm:
        base = np.array([prior.comm_time(op) for op in ops])
        X = featurize_comm(ops)
        y = np.log(np.maximum(t_meas, 1e-12) / np.maximum(base, 1e-12))
    else:
        base = np.array([prior.compute_time(op) for op in ops])
        X = featurize_compute(ops)
        y = np.log(np.maximum(t_meas, 1e-12) / base)
    return X, y


def train_eta_model(
    devices: Optional[Sequence[str]] = None,
    n_samples: int = 6000,
    seed: int = 0,
    jitter_sigma: float = 0.02,
    n_estimators: int = 300,
    *,
    truth: Optional[GroundTruth] = None,
    extra_compute: Sequence[tuple] = (),
    extra_comm: Sequence[tuple] = (),
    warm_start: Optional[EtaModel] = None,
) -> tuple[EtaModel, dict]:
    """Train GBTs on simulated measurements; returns (model, accuracy report).

    Accuracy is the paper's metric: mean(1 - |T_pred - T_meas| / T_meas) on a
    held-out set, reported separately for compute and comm operators.

    ``truth`` injects a custom (e.g. drifted) simulator; ``extra_compute`` /
    ``extra_comm`` are measured (op, seconds) pairs appended to the training
    split — the calibration loop feeds ingested trace samples through here.
    ``warm_start`` continues boosting from an existing model's trees instead
    of restarting from the analytic prior alone.
    """
    devices = list(devices or DEVICES)
    rng = np.random.default_rng(seed)
    truth = truth if truth is not None else GroundTruth(jitter_sigma=jitter_sigma, seed=seed)
    prior = AnalyticEtaModel()

    comp_ops = sample_compute_ops(rng, n_samples, devices)
    comm_ops = sample_comm_ops(rng, n_samples, devices)

    t_comp = np.array([truth.compute_time(op) for op in comp_ops])
    t_comm = np.array([truth.comm_time(op) for op in comm_ops])
    base_comp = np.array([prior.compute_time(op) for op in comp_ops])
    base_comm = np.array([prior.comm_time(op) for op in comm_ops])

    Xc = featurize_compute(comp_ops)
    yc = np.log(t_comp / base_comp)
    Xm = featurize_comm(comm_ops)
    ym = np.log(np.maximum(t_comm, 1e-12) / np.maximum(base_comm, 1e-12))

    n_tr = int(0.8 * n_samples)
    Xc_tr, yc_tr = Xc[:n_tr], yc[:n_tr]
    Xm_tr, ym_tr = Xm[:n_tr], ym[:n_tr]
    if extra_compute:
        Xx, yx = _residual_targets(prior, extra_compute, comm=False)
        Xc_tr, yc_tr = np.vstack([Xc_tr, Xx]), np.concatenate([yc_tr, yx])
    if extra_comm:
        Xx, yx = _residual_targets(prior, extra_comm, comm=True)
        Xm_tr, ym_tr = np.vstack([Xm_tr, Xx]), np.concatenate([ym_tr, yx])

    comp_model = GradientBoostedTrees(
        n_estimators=n_estimators, learning_rate=_LEARNING_RATE, max_depth=7, seed=seed
    ).fit(Xc_tr, yc_tr, eval_set=(Xc[n_tr:], yc[n_tr:]), early_stopping_rounds=30,
          init_model=warm_start.comp_model if warm_start is not None else None)
    comm_model = GradientBoostedTrees(
        n_estimators=n_estimators, learning_rate=_LEARNING_RATE, max_depth=6, seed=seed
    ).fit(Xm_tr, ym_tr, eval_set=(Xm[n_tr:], ym[n_tr:]), early_stopping_rounds=30,
          init_model=warm_start.comm_model if warm_start is not None else None)

    model = EtaModel(comp_model=comp_model, comm_model=comm_model, prior=prior)

    comp_pred = model.compute_times(comp_ops[n_tr:])
    comm_pred = model.comm_times(comm_ops[n_tr:])
    comp_acc = float(np.mean(1.0 - np.abs(comp_pred - t_comp[n_tr:]) / t_comp[n_tr:]))
    comm_acc = float(np.mean(1.0 - np.abs(comm_pred - t_comm[n_tr:]) / t_comm[n_tr:]))

    report = {
        "compute_latency_accuracy": comp_acc,
        "comm_latency_accuracy": comm_acc,
        "n_train": n_tr,
        "n_test": n_samples - n_tr,
        "eta_model_version": model.version_string(),
    }
    return model, report


def refit_eta_model(
    compute_samples: Sequence[tuple],
    comm_samples: Sequence[tuple],
    *,
    base: Optional[EtaModel] = None,
    seed: int = 0,
    n_estimators: int = 120,
    holdout_frac: float = 0.2,
) -> tuple[EtaModel, dict]:
    """Refit from measured (op, seconds) samples alone — the online path.

    Unlike :func:`train_eta_model` this never touches the simulator: the
    inputs are whatever the calibration loop ingested from traces. With
    ``base`` set, boosting warm-starts from the stale model's trees and the
    new trees learn only the drift residual, which is far cheaper than a
    from-scratch fit and deterministic under a fixed seed (same samples +
    same seed => identical trees => identical version hash).
    """
    if not compute_samples and not comm_samples:
        raise ValueError("refit needs at least one measured sample")
    prior = base.prior if base is not None else AnalyticEtaModel()
    rng = np.random.default_rng(seed)
    report: dict = {"n_compute": len(compute_samples), "n_comm": len(comm_samples)}

    def _fit(samples, old_model, *, comm, max_depth):
        if not samples:
            if old_model is None:
                raise ValueError(
                    "no %s samples and no base model to keep" % ("comm" if comm else "compute")
                )
            return old_model, None
        X, y = _residual_targets(prior, samples, comm=comm)
        order = rng.permutation(len(y))
        X, y = X[order], y[order]
        n_tr = max(1, int((1.0 - holdout_frac) * len(y)))
        eval_set = (X[n_tr:], y[n_tr:]) if n_tr < len(y) else None
        model = GradientBoostedTrees(
            n_estimators=n_estimators, learning_rate=_LEARNING_RATE,
            max_depth=max_depth, seed=seed,
        ).fit(
            X[:n_tr], y[:n_tr], eval_set=eval_set,
            early_stopping_rounds=20 if eval_set is not None else None,
            init_model=old_model,
        )
        return model, (X[n_tr:], y[n_tr:])

    comp_model, comp_hold = _fit(
        compute_samples, base.comp_model if base is not None else None,
        comm=False, max_depth=7,
    )
    comm_model, comm_hold = _fit(
        comm_samples, base.comm_model if base is not None else None,
        comm=True, max_depth=6,
    )
    model = EtaModel(comp_model=comp_model, comm_model=comm_model, prior=prior)

    # holdout accuracy in time space (same metric train_eta_model reports)
    def _acc(hold, predict):
        if hold is None or not len(hold[1]):
            return None
        X_h, y_h = hold
        pred = predict(X_h)
        # both pred and target are log-residuals; compare in time ratio space
        ratio = np.exp(pred - y_h)
        return float(np.mean(1.0 - np.abs(ratio - 1.0)))

    report["compute_latency_accuracy"] = _acc(comp_hold, comp_model.predict)
    report["comm_latency_accuracy"] = _acc(comm_hold, comm_model.predict)
    report["eta_model_version"] = model.version_string()
    return model, report


def artifacts_dir() -> str:
    return os.environ.get(
        "REPRO_ARTIFACTS",
        os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(__file__)))),
            "artifacts",
        ),
    )


def load_or_train(path: Optional[str] = None, **kwargs):
    """Load the cached eta model or train+cache one. Returns (model, report|None)."""
    path = path or os.path.join(artifacts_dir(), "eta_model.json")
    if os.path.exists(path):
        return EtaModel.load(path), None
    model, report = train_eta_model(**kwargs)
    model.save(path)
    with open(os.path.join(artifacts_dir(), "eta_model_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return model, report
