"""The MoE dispatch's backward in a train step (``models/moe.py``: the
backward of ``_Dispatch`` and of ``_Combine``, two a MoE layer): the device
milliseconds of the program's ``moe.dispatch_backward`` spans a
``train.step``, in the chosen trace. None for a program without the span."""
from portbench.harness import program_spans as ps


def read(record):
    return ps.device_ms_per(ps.in_trace(record.get("trace")), "moe.dispatch_backward",
                            "train.step")
