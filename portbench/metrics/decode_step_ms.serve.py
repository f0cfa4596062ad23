"""A decode step through the KV cache and the cached attention
(``serve/engine.py``, ``models/lm.py``): the median of the window's
``GenerateResult.step_times`` after each batch's warm-up steps, in ms."""
import statistics


def read(record):
    rows = [t for steps in record.get("step_s", []) for t in steps]
    return 1e3 * statistics.median(rows) if rows else None
