"""K2 (``csrc/flash_attention.cu``) in a train step's forward: the least time
of one layer's causal attention forward (the pairs the mask leaves at 989
TFLOP/s, or its bytes at 3.35 TB/s) times the layers, over the device time
of the kernels named ``flash_fwd_*`` a step, in %. Nothing when K2 is off
the step's path (no launch); a traced run in which it launches other than
once a layer, or leaves no device time under that name, fails."""
from portbench.harness import peaks
from portbench.harness.trace import device_seconds, expected_launches


def read(record):
    tr, s, mix = record.get("trace"), record["shape"], record["mix"]
    if tr is None or not expected_launches(tr, "flash_attention", peaks.train_attn_launches(s)):
        return None
    t = device_seconds(tr, r"^flash_fwd_", required=True) / tr.units
    S = mix["seq"]
    one = peaks.attn_fwd_bound_s(mix["batch"], s.heads, s.kv_heads, S, S, s.head_dim)
    return 100.0 * peaks.train_attn_launches(s) * one / t
