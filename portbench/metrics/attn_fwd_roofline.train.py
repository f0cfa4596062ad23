"""K2 (``csrc/flash_attention.cu``) in a train step's forward: the least time
of one layer's causal attention forward (the pairs the mask leaves at 989
TFLOP/s, or its bytes at 3.35 TB/s) times the layers the port sends to K2
(every layer but those whose window is shorter than the sequence, which run
``banded_flash_xla``), over the device time of the kernels named
``flash_fwd_*`` a step, in %. Nothing when K2 is off the step's path (no
launch); a traced run in which it launches other than once such a layer, or
leaves no device time under that name, fails."""
from portbench.harness import peaks
from portbench.harness.trace import device_seconds, expected_launches


def read(record):
    tr, s, mix = record.get("trace"), record["shape"], record["mix"]
    S = mix["seq"]
    layers = peaks.train_attn_launches(s, S)
    if tr is None or not expected_launches(tr, "flash_attention", layers):
        return None
    t = device_seconds(tr, r"^flash_fwd_", required=True) / tr.units
    one = peaks.attn_fwd_bound_s(mix["batch"], s.heads, s.kv_heads, S, S, s.head_dim)
    return 100.0 * layers * one / t
