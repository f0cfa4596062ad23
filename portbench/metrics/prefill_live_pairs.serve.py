"""The share of the (query, key) pairs that the cached attention scores in
the engine's prefill that the causal mask leaves live, counted by the route
that ran: K2 over a plain cache's written slots (``models/lm.py``
``_flash_cached_attention``: its 64-row tiles up to their last key), or
``flash_xla`` over the others (``kernels/xla_flash.py``: every query against
every key slot, the mask and the unwritten slots hiding the rest). The
program's ``attn.pairs_live`` over ``attn.pairs_scored`` under its
``serve.prefill`` spans, in %, in the chosen trace."""
from portbench.harness import program_spans as ps


def read(record):
    counts = ps.subtree_counts(ps.in_trace(record.get("trace")), "serve.prefill")
    scored = counts.get("attn.pairs_scored")
    return 100.0 * counts.get("attn.pairs_live", 0) / scored if scored else None
