"""Kernel launches a decode step of the engine (eager decode, paced by the
host): the trace's host events named ``cudaLaunchKernel*`` or
``cuLaunchKernel*`` that begin inside the program's ``serve.decode_step``
spans, over the number of spans, in the chosen trace."""
from portbench.harness import program_spans as ps


def read(record):
    tr = record.get("trace")
    steps = ps.named(ps.in_trace(tr), "serve.decode_step")
    return ps.launches_inside(tr, steps) / len(steps) if steps else None
