"""The engine's prefill (``serve/engine.py``): the mean of
``GenerateResult.prefill_time`` (the cache's build and the prefill, ended by
a device synchronise) over the window's batches, in ms."""
import statistics


def read(record):
    rows = record.get("prefill_s")
    return 1e3 * statistics.fmean(rows) if rows else None
