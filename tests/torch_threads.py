"""Pins torch's intra-op threads in the port's test files.

torch starts one intra-op thread per core in every process. Under pytest-xdist
each worker is such a process, so ``-n 6`` on 8 cores runs 48 threads on 8
cores, and one reduced train step that takes 0.035 s alone takes seconds.
Each worker gets its share of the cores instead.
"""
import os

import torch


def pin_threads() -> int:
    """Set torch's intra-op threads to the cores over the xdist workers (all
    cores without xdist); returns the count."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = max(1, (os.cpu_count() or 1) // workers)
    torch.set_num_threads(n)
    return n
