"""``run.py`` without a CUDA card exits non-zero and prints no result."""
import subprocess
import sys

import pytest

from portbench.harness.spec import ROOT


@pytest.mark.parametrize("workload", ["train.yi-6b.s2048", "serve.yi-6b.doc4k",
                                      "train.granite-moe-3b-a800m.s2048"])
def test_no_card_no_result(workload):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload,
                          "--seed", "2147483711", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode != 0
    assert "metrics" not in res.stdout and res.stdout.strip() == ""
    assert "CUDA" in res.stderr
