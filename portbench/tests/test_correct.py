"""``correct`` comes out false for the control and for each fault the cells
can have, under the cells' own limits, while a sound run at the same small
size passes them: whole runs on the CPU (the look for a card skipped), with
the timed path broken underneath, at full attention and under a sliding
window shorter than the sequence (the serve cell's KV cache a ring)."""
import pytest
import torch

from portbench.drivers import serve, train
from portbench.harness import faults, runtime as rt
from portbench.harness.compare import train_numbers, verdict
from portbench.harness.traffic import sample, serve_prompts, train_pool
from portbench.harness.weights import make_weights
from portbench.tests.cells import DENSE, MOE, WIDER, WINDOWED, serve_cell, train_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 101
TRAIN = {"dense": (DENSE, "train.yi-6b.s2048", "train-b4-s2048"),
         "moe": (MOE, "train.granite-moe-3b-a800m.s2048", "train-b8-s2048"),
         "windowed": (WINDOWED, "train.yi-6b.s2048", "train-b4-s2048")}
RUNS = [(fault, kind) for kind in TRAIN
        for fault in [None, *faults.train_faults(train_cell(TRAIN[kind][0]).shape, 32)]]
SERVE = {"dense": DENSE, "windowed": WINDOWED}


def _cell(kind):
    config, checks, mix = TRAIN[kind]
    return train_cell(config, checks=checks, mix=mix)


@pytest.mark.parametrize("fault,kind", RUNS)
def test_train_run(fault, kind):
    c = _cell(kind)
    if fault is None:
        out = train.run(c, SEED, 0.2, False, CPU, rt.now())
    else:
        with faults.train_faults(c.shape, c.mix["seq"])[fault]():
            out = train.run(c, SEED, 0.2, False, CPU, rt.now())
    ok, checks = verdict(out["numbers"], c.checks)
    assert ok == (fault is None), checks
    if fault == "router_reversed":  # its products are sound: the routing's number fails
        assert checks["route_gap"]["value"] > checks["route_gap"]["limit"], checks


@pytest.mark.parametrize("kind", TRAIN)
def test_train_control(kind):
    c = _cell(kind)
    batches = train_pool(c.mix, c.shape.vocab, SEED, CPU)[:3]
    routes = train.first_steps(c, train.program(c), SEED, batches, CPU)[2]["routes"]
    tokens = [b["tokens"] for b in batches]
    want = train.reference(c, SEED, tokens, CPU, routes)
    got = train.reference(c, SEED, tokens, CPU, routes, prec="fp8")
    ok, checks = verdict(train_numbers(got, want), c.checks)
    assert not ok, checks


@pytest.mark.parametrize("kind", SERVE)
@pytest.mark.parametrize("fault", [None, *faults.SERVE])
def test_serve_run(fault, kind):
    c = serve_cell(SERVE[kind])
    if fault is None:
        out = serve.run(c, SEED, 0.2, False, CPU, rt.now())
    else:
        with faults.SERVE[fault]():
            out = serve.run(c, SEED, 0.2, False, CPU, rt.now())
    ok, checks = verdict(out["numbers"], c.checks)
    assert ok == (fault is None), checks


def test_serve_control():
    # the fp8 control's widest gap grows with depth and width: at 2 layers of
    # 64 it can read under the cell's limit, at 8 of 256 it reads 0.37-0.46
    c = serve_cell(config=WIDER, prompt_len=128, new_tokens=8, max_len=136, batch=4)
    eng = serve.engine(c, make_weights(c.shape, SEED, torch.float32, CPU,
                                       c.mix.get("query_key_noise")), CPU)
    tokens = eng.generate(serve_prompts(c.mix, c.shape.vocab, SEED, 1),
                          max_new_tokens=c.mix["new_tokens"]).tokens
    tokens = tokens[sample(SEED, tokens.shape[0], c.mix["check_requests"])]
    got, ctl = serve.served_gap(c, SEED, tokens, CPU, control=True)
    assert verdict({"logit_gap": got}, c.checks)[0]
    ok, checks = verdict({"logit_gap": ctl}, c.checks)
    assert not ok, checks


def test_windows_only_some_layers_have_are_refused_while_the_port_lacks_layer_types():
    import dataclasses

    from repro_torch.core.arch import ModelArch

    if "layer_types" in {f.name for f in dataclasses.fields(ModelArch)}:
        pytest.skip("the port's ModelArch takes layer_types")
    mixed = dict(WINDOWED, layer_types=["sliding_attention", "full_attention"])
    with pytest.raises(ValueError, match="layer_types"):
        train.program(train_cell(mixed))
    with pytest.raises(ValueError, match="layer_types"):
        serve.engine(serve_cell(mixed), None, CPU)
    # one window on every layer is what the port runs today
    assert rt.port_arch(train_cell(WINDOWED).shape).sliding_window == 12
