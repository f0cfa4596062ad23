"""The optimizer of a train step (``train/optimizer.py`` ``adamw_update``):
the device milliseconds of the program's ``train.optimizer`` spans a
``train.step``, in the chosen trace; the program's twin of
``optimizer_ms.train``."""
from portbench.harness import program_spans as ps


def read(record):
    return ps.device_ms_per(ps.in_trace(record.get("trace")), "train.optimizer", "train.step")
