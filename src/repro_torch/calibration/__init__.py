"""Calibration: ground-truth simulator, eta-model training, feedback loop.

The paper trains its XGBoost eta model on measured MegatronLM operator
latencies. This environment has no cluster, so ``truth.py`` provides a
ground-truth simulator with realistic non-idealities (tile quantization,
roofline intensity limits, bandwidth saturation, launch overhead, jitter);
``fit.py`` trains the GBT eta model against it and reports accuracy —
reproducing the paper's >95% cost-model-accuracy experiment in simulation
(see DESIGN.md §2 for why this substitution is necessary and what it means).

The feedback half keeps that accuracy claim honest over time: ``traces.py``
defines the measured :class:`StepTrace` wire schema, ``registry.py`` stores
eta models under content-hash versions, and ``loop.py`` scores prediction
error against the 95% bar and refits (``refit_eta_model``) when it decays.

The port's copy of the JAX package's ``calibration`` (NumPy and stdlib only):
the port imports nothing of the JAX package.
"""
from repro_torch.calibration.truth import GroundTruth
from repro_torch.calibration.fit import (
    AnalyticEtaModel,
    EtaModel,
    refit_eta_model,
    train_eta_model,
)
from repro_torch.calibration.traces import (
    StepTrace,
    append_trace,
    read_traces,
    replay_profile,
    simulate_step_trace,
)
from repro_torch.calibration.registry import (
    EtaModelRegistry,
    MemoryModelRegistry,
    SqliteModelRegistry,
    parse_registry_url,
)
from repro_torch.calibration.loop import CalibrationLoop

__all__ = [
    "GroundTruth",
    "EtaModel",
    "AnalyticEtaModel",
    "train_eta_model",
    "refit_eta_model",
    "StepTrace",
    "append_trace",
    "read_traces",
    "replay_profile",
    "simulate_step_trace",
    "EtaModelRegistry",
    "MemoryModelRegistry",
    "SqliteModelRegistry",
    "parse_registry_url",
    "CalibrationLoop",
]
