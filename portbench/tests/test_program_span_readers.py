"""The readers of the program's spans and counts (``harness/program_spans.py``
and the eight metrics built on it) against a synthetic trace and spans
worked by hand. Times are in ms (1e6 ns) for reading."""
import dataclasses
import sys

import pytest

from portbench.harness.trace import Trace
from portbench.run import read_metric

MS = 1_000_000
TRAIN = ["forward_ms.train", "backward_ms.train", "attn_bwd_ms.train", "adamw_ms.train"]
SERVE = ["prefill_idle_ms.serve", "decode_idle_ms.serve", "decode_launches.serve",
         "prefill_live_pairs.serve"]


@dataclasses.dataclass
class FakeSpan:
    name: str
    id: int
    parent: int | None
    start: float  # ms
    end: float
    device_ms: float | None = None
    counts: dict = dataclasses.field(default_factory=dict)

    @property
    def start_ns(self):
        return int(self.start * MS)

    @property
    def end_ns(self):
        return int(self.end * MS)


@pytest.fixture
def recorded(monkeypatch):
    from repro_torch import spans

    got = []
    monkeypatch.setattr(spans, "recorded", lambda: list(got))
    return got


def _trace(device, host):
    ev = [("k", int(a * MS), int(b * MS)) for a, b in device]
    hs = [(n, int(a * MS), int(b * MS)) for n, a, b in host]
    return Trace(device=ev, host=hs, window_s=1.0, units=1, launches={}, counts=[len(ev)] * 2)


def _serve_record():
    """One batch from 10 to 100 ms: device busy 12-30, 40-60, 70-75 and 80-95;
    prefill 10-35, decode steps 36-65 and 66-98."""
    host = [("ProfilerStep#1", 5, 100), ("aten::mm", 12, 13),
            ("cudaLaunchKernel", 11, 11.1), ("cudaLaunchKernel", 37, 37.1),
            ("cudaLaunchKernelExC", 38, 38.1), ("cuLaunchKernel", 67, 67.1),
            ("cudaLaunchKernel", 65.5, 65.6),  # between the steps: not counted
            ("cudaMemcpyAsync", 68, 68.1)]
    return {"trace": _trace([(12, 30), (40, 60), (70, 75), (80, 95)], host)}


def _serve_spans(got, earlier=False):
    got += [FakeSpan("serve.generate", 1, None, 10, 99),
            FakeSpan("serve.prefill", 2, 1, 10, 35,
                     counts={"attn.pairs_scored": 100, "attn.pairs_live": 40}),
            FakeSpan("serve.decode_step", 3, 1, 36, 65,
                     counts={"attn.pairs_scored": 7, "attn.pairs_live": 7}),
            FakeSpan("serve.decode_step", 4, 1, 66, 98)]
    if earlier:  # a trace retaken before the chosen one: outside its window
        got += [FakeSpan("serve.generate", 5, None, 1, 4),
                FakeSpan("serve.prefill", 6, 5, 1, 2,
                         counts={"attn.pairs_scored": 100, "attn.pairs_live": 100}),
                FakeSpan("serve.decode_step", 7, 5, 2, 4)]


@pytest.mark.parametrize("earlier", [False, True])
def test_serve_readers_intersect_the_trace_with_the_spans(recorded, earlier):
    _serve_spans(recorded, earlier)
    rec = _serve_record()
    # idle gaps 30-40, 60-70, 75-80; prefill 10-35 holds 30-35
    assert read_metric("prefill_idle_ms.serve", rec) == pytest.approx(5)
    # step 36-65: 36-40 and 60-65; step 66-98: 66-70, 75-80 and (past the
    # last device event, no gap) nothing; mean of 9 and 9
    assert read_metric("decode_idle_ms.serve", rec) == pytest.approx(9)
    # two launches in the first step, one in the second
    assert read_metric("decode_launches.serve", rec) == pytest.approx(1.5)
    # the prefill's own counts; a decode step's are not under it
    assert read_metric("prefill_live_pairs.serve", rec) == pytest.approx(40)


def test_counts_of_a_prefills_subtree(recorded):
    recorded += [FakeSpan("serve.prefill", 1, None, 10, 35,
                          counts={"attn.pairs_scored": 10, "attn.pairs_live": 5}),
                 FakeSpan("inner", 2, 1, 11, 20, counts={"attn.pairs_scored": 30}),
                 FakeSpan("deeper", 3, 2, 12, 13, counts={"attn.pairs_live": 10}),
                 FakeSpan("elsewhere", 4, None, 40, 50, counts={"attn.pairs_scored": 99})]
    rec = _serve_record()
    assert read_metric("prefill_live_pairs.serve", rec) == pytest.approx(100 * 15 / 40)


def _train_spans(got):
    """Two steps, each: forward 100 ms, backward 300 of which two layers'
    attention backward 80 + 90, optimizer 50."""
    i = 0
    for step, t0 in enumerate((10, 600)):
        root = i = i + 1
        got.append(FakeSpan("train.step", root, None, t0, t0 + 500))
        for name, ms in (("train.forward", 100), ("train.backward", 300 + step),
                         ("train.optimizer", 50)):
            i += 1
            got.append(FakeSpan(name, i, root, t0 + 1, t0 + 2, device_ms=ms))
            if name == "train.backward":
                bwd = i
                for ms_l in (80, 90):
                    i += 1
                    got.append(FakeSpan("attn.backward", i, bwd, t0 + 1, t0 + 2,
                                        device_ms=ms_l))


def test_train_readers_sum_each_step(recorded):
    _train_spans(recorded)
    rec = {"trace": _trace([(0, 1200)], [("ProfilerStep#1", 0, 1200)])}
    got = {m: read_metric(m, rec) for m in TRAIN}
    assert got == pytest.approx({"forward_ms.train": 100, "backward_ms.train": 300.5,
                                 "attn_bwd_ms.train": 170, "adamw_ms.train": 50})


def test_train_readers_need_device_time(recorded):
    _train_spans(recorded)
    recorded[1].device_ms = None  # a span the CPU recorded: no device time
    rec = {"trace": _trace([(0, 1200)], [("ProfilerStep#1", 0, 1200)])}
    assert read_metric("forward_ms.train", rec) is None
    assert read_metric("backward_ms.train", rec) == pytest.approx(300.5)


@pytest.mark.parametrize("metric", TRAIN + SERVE)
def test_nothing_without_spans(recorded, monkeypatch, metric):
    rec = _serve_record() if metric in SERVE else {
        "trace": _trace([(0, 1200)], [("ProfilerStep#1", 0, 1200)])}
    assert read_metric(metric, rec) is None  # none recorded
    assert read_metric(metric, {"trace": None}) is None  # untraced
    (_serve_spans if metric in SERVE else _train_spans)(recorded)
    assert read_metric(metric, rec) is not None
    # a program without ``repro_torch.spans`` (the commit before it)
    import repro_torch

    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert read_metric(metric, rec) is None


def test_the_moe_cell_reads_as_the_train_readers(recorded):
    _train_spans(recorded)
    rec = {"trace": _trace([(0, 1200)], [("ProfilerStep#1", 0, 1200)])}
    for m in TRAIN:
        assert read_metric(m.replace(".train", ".moe"), rec) == read_metric(m, rec), m
