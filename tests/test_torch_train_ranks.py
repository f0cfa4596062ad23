"""The port's train driver under ``torchrun`` on 2 gloo ranks (``--device
cpu``): a (2, 1) data x model mesh with FSDP. Its losses equal the
one-process run's with the same microbatching and remat (1e-5 relative on
the result line, every printed step's loss to its 4 decimals), its
``--auto-strategy`` searches for 2 cards and its trace says 2, and only rank
0 prints the result line and writes the trace and the checkpoints, whose
arrays are the one-process run's within 1e-4 of each leaf's largest element:
FSDP sums each grad over the ranks in another order, and AdamW's first steps
scale every element's grad to about one, so an element whose grad is near
zero carries that rounding into its update (1.8e-5 of 0.19 was read).
The same for ``--arch granite-moe-3b-a800m --reduced`` (its experts over
"data", the MoE dispatch's capacity from the global batch): the losses equal
the one-process run's.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import pin_threads  # noqa: E402

pin_threads()
pytest.importorskip("jax")

from repro_torch.calibration.traces import read_traces  # noqa: E402
from repro_torch.launch import train as driver  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARGS = ["--arch", "qwen3-8b", "--reduced", "--steps", "6", "--batch", "8", "--seq", "32",
        "--device", "cpu", "--log-every", "1", "--checkpoint-every", "3"]
TOL = 1e-5
CKPT_TOL = 1e-4


@pytest.fixture
def small_eta(tmp_path, monkeypatch):
    """A small GBT eta model where both runs' ``load_or_train`` look."""
    from repro.calibration.fit import train_eta_model

    model, _ = train_eta_model(n_samples=600, n_estimators=40, seed=0)
    model.save(str(tmp_path / "eta_model.json"))
    monkeypatch.setenv("REPRO_ARTIFACTS", str(tmp_path))
    return model


def _steps(lines) -> list[float]:
    return [float(x.split()[3]) for x in lines if x.startswith("step ")]


def test_driver_under_torchrun_matches_one_process(tmp_path, small_eta, capsys):
    ranks_ckpt, one_ckpt = tmp_path / "ranks", tmp_path / "one"
    trace = tmp_path / "t.jsonl"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "repro_torch.launch.train", *ARGS, "--auto-strategy",
         "--emit-traces", str(trace), "--checkpoint-dir", str(ranks_ckpt)],
        capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    out = res.stdout.splitlines()
    results = [json.loads(x) for x in out if x.startswith('{"first_loss"')]
    assert len(results) == 1 and len([x for x in out if x.startswith("[astra]")]) == 1
    (t,) = read_traces(str(trace))
    s = t.strategy
    assert s.num_devices == 2 and t.arch.name == "qwen3-8b-reduced"

    micro = max(s.num_microbatches(8), 1)
    one = driver.main(ARGS + ["--microbatches", str(micro), "--remat",
                              s.recompute_granularity, "--checkpoint-dir", str(one_ckpt)])
    assert abs(results[0]["first_loss"] - one["first_loss"]) <= TOL * one["first_loss"]
    assert abs(results[0]["last_loss"] - one["last_loss"]) <= TOL * one["last_loss"]
    assert _steps(out) == _steps(capsys.readouterr().out.splitlines())

    for step in (3, 6):
        with np.load(ranks_ckpt / f"step_{step:08d}" / "arrays.npz") as a, \
                np.load(one_ckpt / f"step_{step:08d}" / "arrays.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in b.files:
                x, y = a[k].astype(np.float64), b[k].astype(np.float64)
                assert np.abs(x - y).max() <= CKPT_TOL * (np.abs(y).max() + 1e-30), k
    assert sorted(os.listdir(ranks_ckpt)) == ["step_00000003", "step_00000006"]


def test_moe_driver_under_torchrun_matches_one_process(capsys):
    """``--arch granite-moe-3b-a800m --reduced`` on 2 gloo ranks: its 8
    experts over "data" of 2, the dispatch's capacity from the global batch.
    The losses equal the one-process run's (1e-5 relative on the result
    line, every printed step's to its 4 decimals)."""
    argv = ["--arch", "granite-moe-3b-a800m", "--reduced", "--steps", "6", "--batch", "8",
            "--seq", "32", "--device", "cpu", "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "repro_torch.launch.train", *argv],
        capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    out = res.stdout.splitlines()
    (result,) = [json.loads(x) for x in out if x.startswith('{"first_loss"')]
    one = driver.main(argv)
    for k in ("first_loss", "last_loss"):
        assert abs(result[k] - one[k]) <= TOL * one[k], k
    assert _steps(out) == _steps(capsys.readouterr().out.splitlines())
