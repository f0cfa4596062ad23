"""``dispatch_bwd_ms.moe`` against spans worked by hand: the device time of
the MoE dispatch's backward spans a train step, and nothing where the
program records no such span (a program before it)."""
import pytest

from portbench.run import read_metric
from portbench.tests.test_program_span_readers import FakeSpan, _trace

METRIC = "dispatch_bwd_ms.moe"


@pytest.fixture
def recorded(monkeypatch):
    from repro_torch import spans

    got = []
    monkeypatch.setattr(spans, "recorded", lambda: list(got))
    return got


def _steps(got, dispatch=True):
    """Two steps, each a backward that holds two MoE layers' dispatch and
    combine backward (3 + 4 and 5 + 6 ms; 8 ms more in the second step)."""
    i = 0
    for step, t0 in enumerate((10, 600)):
        root = i = i + 1
        got.append(FakeSpan("train.step", root, None, t0, t0 + 500))
        i += 1
        bwd = i
        got.append(FakeSpan("train.backward", bwd, root, t0 + 1, t0 + 400, device_ms=300))
        for ms in ((3, 4, 5, 6 + 8 * step) if dispatch else ()):
            i += 1
            got.append(FakeSpan("moe.dispatch_backward", i, bwd, t0 + 2, t0 + 3,
                                device_ms=ms))


def _record():
    return {"trace": _trace([(0, 1200)], [("ProfilerStep#1", 0, 1200)])}


def test_the_spans_device_time_a_step(recorded):
    _steps(recorded)
    assert read_metric(METRIC, _record()) == pytest.approx((18 + 26) / 2)


@pytest.mark.parametrize("case", ["no_span", "untraced", "no_device_time"])
def test_nothing_to_read(recorded, case):
    _steps(recorded, dispatch=case != "no_span")
    if case == "no_device_time":  # spans the CPU recorded
        recorded[-1].device_ms = None
    rec = {"trace": None} if case == "untraced" else _record()
    assert read_metric(METRIC, rec) is None
