"""The attention backward of a train step (``kernels/ops.py``
``_FlashAttention.backward``, the plain VJP behind K2): the device
milliseconds of the program's ``attn.backward`` spans, every layer's, a
``train.step``, in the chosen trace."""
from portbench.harness import program_spans as ps


def read(record):
    return ps.device_ms_per(ps.in_trace(record.get("trace")), "attn.backward", "train.step")
