"""The model's forward and loss in a train step (``models/lm.py``
``forward_train``): the device milliseconds of the program's
``train.forward`` spans (CUDA events at both ends) a ``train.step``, in the
chosen trace."""
from portbench.harness import program_spans as ps


def read(record):
    return ps.device_ms_per(ps.in_trace(record.get("trace")), "train.forward", "train.step")
