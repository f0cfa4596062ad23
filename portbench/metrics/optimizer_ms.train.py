"""The optimizer of a train step (``train/optimizer.py``): CUDA events around
the port's ``adamw_update``, the mean over the traced run's window."""
import statistics


def read(record):
    rows = record.get("spans", {}).get("optimizer_ms")
    return statistics.fmean(rows) if rows else None
