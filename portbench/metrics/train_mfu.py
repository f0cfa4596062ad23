"""The whole train step's share of the H100's bf16 peak: model FLOPs a step
(6 x matmul params x tokens, plus causal attention) x the window's steps,
over the window's host seconds x 989e12, in %."""
from portbench.harness import peaks


def read(record):
    s, mix = record["shape"], record["mix"]
    flops = peaks.train_flops(s, mix["batch"], mix["seq"]) * record["steps"]
    return 100.0 * flops / (record["window_s"] * peaks.BF16_FLOPS)
