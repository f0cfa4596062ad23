"""The backward of a train step (``train/train_step.py``: the autograd
pass and the grads' redistribution): the device milliseconds of the
program's ``train.backward`` spans a ``train.step``, in the chosen trace."""
from portbench.harness import program_spans as ps


def read(record):
    return ps.device_ms_per(ps.in_trace(record.get("trace")), "train.backward", "train.step")
