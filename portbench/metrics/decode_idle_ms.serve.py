"""The device's idle time in a decode step of the engine (``serve/engine.py``:
sampling to the step's synchronise): milliseconds of the trace's gaps
between device events inside the program's ``serve.decode_step`` spans,
their mean, in the chosen trace."""
from portbench.harness import program_spans as ps


def read(record):
    tr = record.get("trace")
    steps = ps.named(ps.in_trace(tr), "serve.decode_step")
    return ps.idle_ms_inside(tr, steps) / len(steps) if steps else None
