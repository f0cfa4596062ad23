"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
root of the checkout. They run on the CPU at small sizes."""
import os
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture(autouse=True)
def _threads():
    """torch's intra-op threads: the cores over the xdist workers."""
    import torch

    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
