"""The device's idle time in the engine's prefill (``serve/engine.py``: the
cache's build and the prefill, up to its synchronise): milliseconds of the
trace's gaps between device events inside the program's ``serve.prefill``
spans, a batch (``serve.generate``), in the chosen trace."""
from portbench.harness import program_spans as ps


def read(record):
    tr = record.get("trace")
    got = ps.in_trace(tr)
    batches, prefills = ps.named(got, "serve.generate"), ps.named(got, "serve.prefill")
    if not batches or not prefills:
        return None
    return ps.idle_ms_inside(tr, prefills) / len(batches)
