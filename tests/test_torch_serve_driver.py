"""The port's serve driver (``repro_torch.launch.serve``) against the JAX
package's ``examples/serve_batched.py``, on the CPU: the trace
``--emit-traces`` appends, the report ``--search-spec`` replays, and an
unreachable ``--search-url``."""
import dataclasses
import importlib.util
import pathlib
import socket
import sys

import pytest

pytest.importorskip("torch")
from torch_threads import pin_threads  # noqa: E402

pin_threads()

from repro.calibration.traces import read_traces  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.core import FixedPool, SearchSpec, Workload  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--arch", "qwen3-8b", "--batch", "2", "--prompt-len", "8", "--tokens", "5"]


@pytest.fixture(scope="module")
def example():
    """examples/serve_batched.py as a module (it is a script, not a package)."""
    spec = importlib.util.spec_from_file_location("serve_batched",
                                                  ROOT / "examples" / "serve_batched.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_example(example, monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["serve_batched.py", *argv])
    return example.main()


@pytest.fixture
def small_eta(tmp_path, monkeypatch):
    """A small GBT eta model cached where both packages' ``load_or_train``
    look, so both searches score with one model."""
    from repro.calibration.fit import train_eta_model

    model, _ = train_eta_model(n_samples=600, n_estimators=40, seed=0)
    model.save(str(tmp_path / "eta_model.json"))
    monkeypatch.setenv("REPRO_ARTIFACTS", str(tmp_path))
    return model


@pytest.fixture
def spec_path(tmp_path):
    path = tmp_path / "spec.json"
    path.write_text(SearchSpec(jax_reduced("qwen3-8b"), FixedPool("H100", 1),
                               Workload(16, 64)).to_json())
    return str(path)


@pytest.mark.parametrize("searched", [False, True], ids=["no_spec", "spec"])
def test_emit_traces_writes_the_examples_trace(example, monkeypatch, tmp_path, searched,
                                               small_eta, spec_path):
    """One source="serve" trace each; apart from the measured step times and
    the device name, the same fields as the JAX example writes: the decode
    steps less the first call's warm-up step, the arch, the batch and
    sequence, the strategy (the searched one under --search-spec)."""
    extra = ["--search-spec", spec_path] * searched
    ours, theirs = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    assert serve.main(ARGS + extra + ["--device", "cpu", "--emit-traces", ours]) == 0
    assert _run_example(example, monkeypatch, ARGS + extra + ["--emit-traces", theirs]) is None
    (got,), (want,) = read_traces(ours), read_traces(theirs)
    assert got.source == want.source == "serve"
    assert got.warmup_steps_excluded == want.warmup_steps_excluded == 1
    assert len(got.step_times) == len(want.step_times) == 4
    assert all(t > 0 for t in got.step_times)
    assert dataclasses.asdict(got.arch) == dataclasses.asdict(want.arch)
    assert (got.global_batch, got.seq) == (want.global_batch, want.seq) == (2, 13)
    g, w = dataclasses.asdict(got.strategy), dataclasses.asdict(want.strategy)
    if searched:
        assert g == w and g["device"] == "H100"
    else:
        assert (g.pop("device"), w.pop("device")) == ("H100", "tpu-v5e")
        assert g == w


def test_search_spec_replays_the_examples_report(example, small_eta, spec_path, capsys,
                                                 monkeypatch):
    """The in-process replay: the same best strategy, cache key and report
    as the JAX example's pick_strategy_from_spec, and the same line."""
    spec, report = serve.pick_strategy_from_spec(spec_path)
    jspec, jreport = example.pick_strategy_from_spec(spec_path)
    assert spec.cache_key() == jspec.cache_key()
    assert dataclasses.asdict(report.best) == dataclasses.asdict(jreport.best)
    assert report.normalized_json() == jreport.normalized_json()
    capsys.readouterr()
    assert serve.main(ARGS + ["--tokens", "2", "--search-spec", spec_path,
                              "--device", "cpu"]) == 0
    ours = [x for x in capsys.readouterr().out.splitlines() if x.startswith("search spec")]
    _run_example(example, monkeypatch, ARGS + ["--tokens", "2", "--search-spec", spec_path])
    theirs = [x for x in capsys.readouterr().out.splitlines() if x.startswith("search spec")]
    assert len(ours) == 1 and ours == theirs


def test_unreachable_search_url_returns_2(example, spec_path, capsys, monkeypatch):
    """A service that is not there: exit code 2 and the reason on stderr,
    before any model is built, as the JAX example does."""
    with socket.socket() as s:  # a port nothing listens on once it is closed
        s.bind(("127.0.0.1", 0))
        url = f"http://127.0.0.1:{s.getsockname()[1]}"
    argv = ARGS + ["--search-spec", spec_path, "--search-url", url, "--search-timeout", "5"]
    assert serve.main(argv + ["--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("search service unavailable:") and url in err
    assert _run_example(example, monkeypatch, argv) == 2
