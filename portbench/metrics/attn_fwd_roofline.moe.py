"""``attn_fwd_roofline.train`` read in a mixture-of-experts train cell, whose rate is
``moe_train_tokens_per_s``: the same reading, moving that rate."""
from portbench.run import read_metric


def read(record):
    return read_metric("attn_fwd_roofline.train", record)
