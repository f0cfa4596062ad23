"""The whole of serving's share of the H100's bf16 peak: model FLOPs of the
window's batches (each request's prefill, and the decode steps whose logits
are served, at their cache positions), over the window's host seconds x
989e12, in %."""
from portbench.harness import peaks


def read(record):
    s, mix = record["shape"], record["mix"]
    flops = peaks.serve_batch_flops(s, mix["batch"], mix["prompt_len"], mix["new_tokens"])
    return 100.0 * flops * record["batches"] / (record["window_s"] * peaks.BF16_FLOPS)
