"""Forward + backward of a train step (``models/lm.py``):
CUDA events from the step's start to the entry of the port's
``adamw_update``, the mean over the traced run's window."""
import statistics


def read(record):
    rows = record.get("spans", {}).get("fwd_bwd_ms")
    return statistics.fmean(rows) if rows else None
