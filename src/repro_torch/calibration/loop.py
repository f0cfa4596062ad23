"""Calibration feedback loop: drift scoring + auto-refit over a registry.

The paper's headline claim is >95% cost-model accuracy, but a model fitted
once drifts as the cluster changes underneath it (driver regressions,
thermal derating, congested fabric). :class:`CalibrationLoop` closes the
loop the way ByteProfile-style trace accounting does:

1. every ingested :class:`~repro_torch.calibration.traces.StepTrace` is scored —
   predicted step time under the *current* eta model vs the measured median
   — into rolling per-(model, pool, strategy) and global accuracy windows;
2. when the global rolling accuracy decays below the bar (default: the
   paper's 0.95) and enough measured op-level samples have accumulated,
   the loop refits (:func:`~repro_torch.calibration.fit.refit_eta_model`,
   warm-started from the stale model), registers the result under its new
   content-hash version, and swaps it in;
3. reports ranked under an older version are now *stale* — the search
   service can detect that via :meth:`version` and force a re-search.

Everything is deterministic and sleep-free: accuracy is a pure function of
the ingested traces, and a refit under a fixed seed and a fixed sample
sequence reproduces the same trees (hence the same version hash).
"""
from __future__ import annotations

import statistics
import threading
from collections import OrderedDict, deque
from typing import Optional

from repro_torch.calibration.fit import EtaModel, refit_eta_model
from repro_torch.calibration.registry import EtaModelRegistry, MemoryModelRegistry
from repro_torch.calibration.traces import StepTrace

# cap per-key accuracy bookkeeping so hostile/exhaustive strategy sweeps
# can't grow the stats surface without bound
_MAX_TRACKED_KEYS = 256


class CalibrationLoop:
    """Rolling accuracy tracker + auto-refit policy around an eta model.

    ``model`` is the live cost model (anything with ``version_string()``;
    refitting requires an :class:`EtaModel`). All entry points are
    thread-safe — the search service calls :meth:`ingest` from HTTP handler
    threads.
    """

    def __init__(
        self,
        model,
        *,
        registry: Optional[EtaModelRegistry] = None,
        threshold: float = 0.95,
        window: int = 32,
        min_traces: int = 8,
        min_refit_samples: int = 64,
        max_samples: int = 4096,
        refit_seed: int = 0,
        refit_estimators: int = 120,
        auto_refit: bool = True,
    ):
        if not 0.0 < threshold <= 1.0:
            raise ValueError("threshold must be in (0, 1]")
        if window < 1 or min_traces < 1:
            raise ValueError("window and min_traces must be >= 1")
        self.registry = registry if registry is not None else MemoryModelRegistry()
        self.threshold = threshold
        self.min_traces = min_traces
        self.min_refit_samples = min_refit_samples
        self.refit_seed = refit_seed
        self.refit_estimators = refit_estimators
        self.auto_refit = auto_refit
        self._window_len = window
        self._lock = threading.Lock()
        self._model = model
        self._register(model, meta={"reason": "initial"})
        self._global: deque = deque(maxlen=window)
        self._by_key: "OrderedDict[tuple, deque]" = OrderedDict()
        self._compute_samples: deque = deque(maxlen=max_samples)
        self._comm_samples: deque = deque(maxlen=max_samples)
        self._simulator = None
        self.traces = 0  # ingested traces (monotonic)
        self.refits = 0  # completed refits (monotonic)

    # -- current model -----------------------------------------------------
    @property
    def model(self):
        with self._lock:
            return self._model

    @property
    def version(self) -> str:
        with self._lock:
            return self._model.version_string()

    def _register(self, model, *, meta: Optional[dict] = None) -> None:
        # only tree-backed models have serializable state; the analytic
        # prior's version is a fixed tag with nothing to store
        if isinstance(model, EtaModel):
            self.registry.register(model, meta=meta)

    def _sim(self):
        # memoized per model generation: op predictions repeat across traces
        if self._simulator is None:
            from repro_torch.core.simulate import CostSimulator

            self._simulator = CostSimulator(self._model)
        return self._simulator

    # -- ingestion ---------------------------------------------------------
    def ingest(self, trace: StepTrace) -> dict:
        """Score one trace against the current model; maybe refit.

        Returns an ack the service serializes back to the submitter:
        predicted/measured step time, this trace's accuracy, the rolling
        accuracy, the model version that scored it, and — when this trace
        tripped a refit — the new version.
        """
        with self._lock:
            version = self._model.version_string()
            predicted = self._sim().simulate(
                trace.arch, trace.strategy,
                global_batch=trace.global_batch, seq=trace.seq,
            ).step_time
            measured = trace.measured_step_time
            accuracy = 1.0 - abs(predicted - measured) / max(measured, 1e-12)

            self.traces += 1
            self._global.append(accuracy)
            key = (version, trace.pool_key, trace.strategy_key)
            dq = self._by_key.get(key)
            if dq is None:
                dq = deque(maxlen=self._window_len)
                self._by_key[key] = dq
                while len(self._by_key) > _MAX_TRACKED_KEYS:
                    self._by_key.popitem(last=False)
            dq.append(accuracy)
            self._compute_samples.extend(trace.compute_samples)
            self._comm_samples.extend(trace.comm_samples)

            rolling = statistics.fmean(self._global)
            ack = {
                "eta_model_version": version,
                "predicted_step_time": predicted,
                "measured_step_time": measured,
                "accuracy": accuracy,
                "rolling_accuracy": rolling,
                "threshold": self.threshold,
                "refit": False,
            }
            if self.auto_refit and self._should_refit_locked(rolling):
                ack["refit"] = True
                ack["new_version"] = self._refit_locked(
                    reason="rolling accuracy %.4f < %.4f" % (rolling, self.threshold)
                )
            return ack

    def _should_refit_locked(self, rolling: float) -> bool:
        return (
            len(self._global) >= self.min_traces
            and rolling < self.threshold
            and isinstance(self._model, EtaModel)
            and len(self._compute_samples) + len(self._comm_samples)
            >= self.min_refit_samples
        )

    def _refit_locked(self, *, reason: str) -> str:
        old_version = self._model.version_string()
        new_model, report = refit_eta_model(
            tuple(self._compute_samples),
            tuple(self._comm_samples),
            base=self._model if isinstance(self._model, EtaModel) else None,
            seed=self.refit_seed,
            n_estimators=self.refit_estimators,
        )
        new_version = new_model.version_string()
        self._register(
            new_model,
            meta={"reason": reason, "refit_of": old_version, "report": report},
        )
        self._model = new_model
        self._simulator = None
        self.refits += 1
        # the new model starts with a clean slate: old-window scores measured
        # a different model, and absorbed samples were consumed by this fit
        self._global.clear()
        self._compute_samples.clear()
        self._comm_samples.clear()
        return new_version

    def refit(self, *, reason: str = "forced") -> str:
        """Unconditional refit from the absorbed samples (raises if none)."""
        with self._lock:
            return self._refit_locked(reason=reason)

    # -- observability -----------------------------------------------------
    def rolling_accuracy(self) -> Optional[float]:
        with self._lock:
            return statistics.fmean(self._global) if self._global else None

    def stats_dict(self) -> dict:
        with self._lock:
            by_key = {
                "|".join(k): {
                    "n": len(dq),
                    "mean_accuracy": statistics.fmean(dq) if dq else None,
                }
                for k, dq in self._by_key.items()
            }
            return {
                "eta_model_version": self._model.version_string(),
                "threshold": self.threshold,
                "traces": self.traces,
                "refits": self.refits,
                "rolling_accuracy": (
                    statistics.fmean(self._global) if self._global else None
                ),
                "window": {"n": len(self._global), "max": self._window_len},
                "pending_samples": {
                    "compute": len(self._compute_samples),
                    "comm": len(self._comm_samples),
                },
                "by_key": by_key,
                "registry": {
                    "kind": self.registry.kind,
                    "models": len(self.registry),
                    **self.registry.counters(),
                },
            }
