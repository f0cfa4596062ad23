"""The share of the (query, key) pairs that ``flash_xla`` scores in the
engine's prefill that its mask leaves live (``kernels/xla_flash.py``: every
query is scored against every key slot, the causal mask and the unwritten
slots then hide the rest): the program's ``attn.pairs_live`` over
``attn.pairs_scored`` under its ``serve.prefill`` spans, in %, in the chosen
trace."""
from portbench.harness import program_spans as ps


def read(record):
    counts = ps.subtree_counts(ps.in_trace(record.get("trace")), "serve.prefill")
    scored = counts.get("attn.pairs_scored")
    return 100.0 * counts.get("attn.pairs_live", 0) / scored if scored else None
