"""``idle_share.train`` read in a mixture-of-experts train cell, whose rate is
``moe_train_tokens_per_s``: the same reading, moving that rate."""
from portbench.run import read_metric


def read(record):
    return read_metric("idle_share.train", record)
