"""The port's spans and counts (``repro_torch.spans``) on the CPU: off, they
record nothing; under the profiler they nest, lie on the trace's clock and
carry their counts; and the engine's, the train step's and ``flash_xla``'s
record what the benchmark's readers take from them."""
import contextlib
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import pin_threads  # noqa: E402

pin_threads()
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels.xla_flash import flash_xla, flash_xla_lse  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train import TrainStepCfg, adamw_init, make_train_step  # noqa: E402

ARCH = get_reduced("qwen3-8b")
CFG = lm.ModelCfg(dtype=torch.float32)


@pytest.fixture(autouse=True)
def _fresh():
    spans.clear()
    yield
    spans.clear()


def _profiling():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name(got):
    out = {}
    for s in got:
        out.setdefault(s.name, []).append(s)
    return out


def _params():
    return lm.init_params(ARCH, torch.Generator().manual_seed(0), device="cpu")


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_off_records_nothing_and_span_is_the_shared_noop():
    assert spans.span("a") is spans.span("b", ident=3, device=True)
    with spans.span("a"):
        spans.count("n", 1)
        assert not spans.counting()
    with spans.timed("t") as t:
        time.sleep(0.001)
    assert t.seconds >= 0.001
    assert spans.recorded() == []


def test_recording_ends_with_the_profile():
    with _profiling():
        with spans.span("in"):
            pass
    with spans.span("out"):
        pass
    assert [s.name for s in spans.recorded()] == ["in"]


def test_spans_nest_and_bracket_the_traces_own_stamps():
    x = torch.randn(64, 64)
    with _profiling() as prof:
        with spans.span("step", ident="req-7"):
            with spans.timed("inner") as inner_t:
                time.sleep(0.002)
                x @ x
                time.sleep(0.002)
            with spans.span("own", ident="req-8"):
                pass
    got = {s.name: s for s in spans.recorded()}
    step, inner, own = got["step"], got["inner"], got["own"]
    assert step.parent is None and inner.parent == own.parent == step.id
    assert len({step.id, inner.id, own.id}) == 3
    assert (step.ident, inner.ident, own.ident) == ("req-7", "req-7", "req-8")
    assert step.start_ns <= inner.start_ns < inner.end_ns <= own.start_ns <= step.end_ns
    assert inner.dur_ns == inner_t.ns and inner.device_ms is None
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mm) == 1
    # the profiler's host clock is Unix time: the op lies inside the span
    assert inner.start_ns < mm[0].start_ns() <= mm[0].end_ns() < inner.end_ns


def test_counts_land_on_the_innermost_open_span():
    spans.count("n", 100)  # no span open: dropped
    with _profiling():
        with spans.span("a"):
            spans.count("n", 1)
            with spans.span("b"):
                assert spans.counting()
                spans.count("n", 2)
                spans.count("m", 5)
            spans.count("n", 4)
    assert {s.name: s.counts for s in spans.recorded()} == {"a": {"n": 5},
                                                             "b": {"n": 2, "m": 5}}


def test_a_span_on_another_thread_takes_the_open_spans_parent_and_identifier():
    def work():
        with spans.span("worker"):
            spans.count("k", 1)

    with _profiling():
        with spans.span("step", ident=11):
            th = threading.Thread(target=work)
            th.start()
            th.join(timeout=30)
    assert not th.is_alive()
    got = {s.name: s for s in spans.recorded()}
    assert got["worker"].parent == got["step"].id and got["worker"].ident == 11
    assert got["worker"].counts == {"k": 1} and got["step"].counts == {}


# ---------------------------------------------------------------------------
# the program's spans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profiled", [True, False])
def test_engine_spans_are_its_timings(profiled):
    eng = ServeEngine(ARCH, CFG, _params(), max_len=24, device="cpu")
    prompts = np.random.default_rng(0).integers(0, ARCH.vocab, size=(2, 7))
    for _ in range(2):  # the second call's identifier differs
        with _profiling() if profiled else contextlib.nullcontext():
            r = eng.generate(prompts, max_new_tokens=4)
    assert len(r.step_times) == 4 and r.prefill_time > 0
    if not profiled:
        assert spans.recorded() == []
        return
    got = _by_name(spans.recorded())
    assert sorted(got) == ["serve.decode_step", "serve.generate", "serve.prefill"]
    gen, (prefill,), steps = got["serve.generate"][-1], got["serve.prefill"][-1:], \
        got["serve.decode_step"][-4:]
    assert len(got["serve.generate"]) == 2 and len(got["serve.decode_step"]) == 8
    assert got["serve.generate"][0].ident != gen.ident
    assert all(s.parent == gen.id and s.ident == gen.ident for s in [prefill, *steps])
    assert r.prefill_time == prefill.dur_ns / 1e9
    assert r.step_times == tuple(s.dur_ns / 1e9 for s in steps)
    assert prefill.end_ns <= steps[0].start_ns and all(
        a.end_ns <= b.start_ns for a, b in zip(steps, steps[1:]))
    # the prefill's attention through flash_xla: 7 causal queries over 24 slots
    B, H, S, T = 2, ARCH.heads, 7, 24
    assert prefill.counts == {"attn.pairs_scored": ARCH.num_layers * B * H * S * T,
                              "attn.pairs_live": ARCH.num_layers * B * H * S * (S + 1) // 2}
    assert steps[1].counts["attn.pairs_live"] == ARCH.num_layers * B * H * (S + 2)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_spans(microbatches):
    step = make_train_step(ARCH, CFG, TrainStepCfg(num_microbatches=microbatches))
    params = _params()
    opt = adamw_init(params)
    batch = {"tokens": torch.randint(0, ARCH.vocab, (4, 16),
                                     generator=torch.Generator().manual_seed(1))}
    step(params, opt, batch)  # off: nothing
    assert spans.recorded() == []
    with _profiling():
        step(params, opt, batch)
    got = _by_name(spans.recorded())
    (root,) = got.pop("train.step")
    assert root.ident == 1 and root.parent is None
    assert {k: len(v) for k, v in got.items()} == {
        "train.forward": microbatches, "train.backward": microbatches, "train.optimizer": 1,
        "attn.backward": microbatches * ARCH.num_layers}
    for name in ("train.forward", "train.backward", "train.optimizer"):
        for s in got[name]:
            assert s.parent == root.id and s.ident == root.ident
            assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
            assert s.device_ms is None  # no device on the CPU
    backward = {s.id for s in got["train.backward"]}
    assert all(s.parent in backward for s in got["attn.backward"])


def _mask_pairs(B, Hq, S, T, q_start, valid, ring, causal):
    """A brute-force count of flash_xla's mask: (scored, live)."""
    wrapped = ring and q_start + S - 1 >= T
    live = sum(1 for i in range(S) for j in range(T)
               if wrapped or (j < valid and (not causal or j <= q_start + i)))
    return B * Hq * S * T, B * Hq * live


@pytest.mark.parametrize("S,T,q_start,valid,ring,causal", [
    (6, 8, 0, 6, False, True),     # causal prefill into a longer cache
    (8, 8, None, None, False, True),  # the whole cache, default positions
    (2, 8, 3, 5, False, True),     # a chunk into a partly filled cache
    (1, 8, 6, 7, False, True),     # a decode step
    (1, 8, 9, 10, True, True),     # a decode step once the ring has wrapped
    (3, 8, 4, 7, True, True),      # a ring not yet wrapped
    (3, 8, -2, 1, False, True),    # a part of a T-split cache, queries before it
    (3, 8, 0, 5, False, False),    # not causal
], ids=["prefill", "whole", "chunk", "decode", "wrapped", "ring", "part", "bidir"])
def test_flash_xla_counts_the_pairs_of_its_mask(S, T, q_start, valid, ring, causal):
    B, Hq, Hkv, D = 2, 4, 2, 8
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, Hq, S, D, generator=g)
    k, v = (torch.randn(B, Hkv, T, D, generator=g) for _ in range(2))
    with _profiling():
        with spans.span("attn"):
            if q_start is not None and q_start < 0:
                flash_xla_lse(q, k, v, q_start=q_start, kv_valid_len=valid, causal=causal,
                              block=3)
            else:
                flash_xla(q, k, v, q_start=q_start, kv_valid_len=valid, ring=ring,
                          causal=causal, block=3)
    (got,) = spans.recorded()
    scored, live = _mask_pairs(B, Hq, S, T, T - S if q_start is None else q_start,
                               T if valid is None else valid, ring, causal)
    assert got.counts == {"attn.pairs_scored": scored, "attn.pairs_live": live}
