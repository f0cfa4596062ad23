"""The train driver: the port's ``make_train_step`` on weights and batches
made from the seed.

Set-up builds one train step with its params and AdamW state and drives it
through the mix's ``check_steps`` first steps (also its warm-up), on batches
whose rows all differ, recording the experts that a mixture of experts
chose in them. The same objects then run the window, the program untouched:
whole steps, each ended by a device synchronise, until ``seconds`` have
passed. The check follows the first steps with the plain reference once the
window has closed, the program's state is freed and the peak memory read;
the reference takes the recorded experts (``harness/compare.py``).
"""
from __future__ import annotations

import contextlib
import inspect
import math

import torch

from portbench.harness import runtime as rt
from portbench.harness.compare import train_numbers
from portbench.harness.traffic import train_pool
from portbench.harness.weights import leaves, make_leaf, make_weights
from portbench.refs import lm as ref
from portbench.refs.moe import Routing


def program(cell):
    """The port's train step as the configuration and the mix state it."""
    from repro_torch.models.lm import ModelCfg
    from repro_torch.train import TrainStepCfg, make_train_step
    from repro_torch.train.optimizer import adamw_update

    s, mix = cell.shape, cell.mix
    opt = mix["optimizer"]
    defaults = {k: inspect.signature(adamw_update).parameters[k].default
                for k in ("b1", "b2", "eps")}
    if any(defaults[k] != opt[k] for k in defaults):
        raise ValueError(f"the port's AdamW runs {defaults}, the mix states {opt}")
    rt.check_port_constants(s)
    if s.experts and mix["remat"] != "none":
        raise ValueError("the record of the experts chosen holds one call of moe.select a "
                         "layer and step: remat none only")
    model_cfg = ModelCfg(dtype=rt.DTYPES[mix["compute_dtype"]], remat=mix["remat"],
                         **rt.moe_options(s, mix))
    step_cfg = TrainStepCfg(num_microbatches=mix["microbatches"], base_lr=opt["base_lr"],
                            warmup_steps=opt["warmup_steps"], total_steps=opt["total_steps"],
                            weight_decay=opt["weight_decay"], clip_norm=opt["clip_norm"])
    return make_train_step(rt.port_arch(s), model_cfg, step_cfg)


@contextlib.contextmanager
def recorded_routes(s):
    """While open, the experts (T, k) that each call of the port's
    ``moe.select`` chose, in the order of the calls: one a layer and step
    (nothing for a dense model)."""
    calls = []
    if not s.experts:
        yield calls
        return
    from repro_torch.models import moe

    real = moe.select

    def select(p, xt, top_k):
        gates, experts = real(p, xt, top_k)
        calls.append(experts.detach().to(torch.int32))
        return gates, experts

    moe.select = select
    try:
        yield calls
    finally:
        moe.select = real


def first_steps(cell, step, seed: int, batches: list, device):
    """Params and AdamW state from the seed, driven through ``batches`` by
    the program's ``step``: ``(params, opt, readings)``, the readings being
    each step's loss, each leaf's norm of the first step's clipped gradient
    (from AdamW's first moment, (1 - b1) x that gradient) and of its change
    over the steps, and the experts chosen (``routes``)."""
    from repro_torch.train import adamw_init

    s, f32, b1 = cell.shape, torch.float32, cell.mix["optimizer"]["b1"]
    qk = cell.mix.get("query_key_noise")
    params = make_weights(s, seed, f32, device, qk)
    opt = adamw_init(params)
    prog = {"losses": [], "grad_norms": {}, "change_norms": {}}
    with recorded_routes(s) as prog["routes"]:
        for i, batch in enumerate(batches):
            params, opt, metrics = step(params, opt, batch)
            prog["losses"].append(float(metrics["loss"]))
            if i == 0:
                prog["grad_norms"] = {p: rt.norm(m) / (1 - b1) for p, m in leaves(opt.mu)}
    prog["change_norms"] = {p: rt.norm(x - make_leaf(s, seed, p, f32, device, qk))
                            for p, x in leaves(params)}
    return params, opt, prog


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    mix = cell.mix
    step = program(cell)
    pool = train_pool(mix, cell.shape.vocab, seed, device)
    n_check = mix["check_steps"]
    params, opt, prog = first_steps(cell, step, seed, pool[:n_check], device)
    rt.sync(device)
    setup_s = rt.now() - t_start

    state = {"params": params, "opt": opt, "i": n_check}
    del params, opt

    def one_step():
        state["params"], state["opt"], m = step(state["params"], state["opt"],
                                                pool[state["i"] % len(pool)])
        state["i"] += 1
        rt.sync(device)
        return float(m["loss"])

    steps = failed = 0
    t0 = rt.now()
    while True:
        failed += not math.isfinite(one_step())
        steps += 1
        if rt.now() - t0 >= seconds:
            break
    wall = rt.now() - t0
    memory_peak = rt.memory_peak(device)
    tokens = mix["batch"] * mix["seq"]
    record = {"kind": "train", "shape": cell.shape, "mix": mix, "window_s": wall, "steps": steps,
              "tokens": tokens * steps}
    # a mixture's step follows its routing, which the seed's weights and the
    # steps' updates set: its rate spreads wider across seeds than a dense
    # model's, and is held to a bound of its own
    rate = "moe_train_tokens_per_s" if cell.shape.experts else "train_tokens_per_s"
    out = {"setup_s": setup_s, rate: tokens * steps / wall,
           "attempted": steps, "failed": failed, "memory_peak_bytes": memory_peak,
           "record": record}
    if trace:
        from portbench.harness.trace import profile_agreeing

        record["trace"] = profile_agreeing(one_step, mix["profile_steps"],
                                           lambda: rt.sync(device), rt.launch_counters)

    check = [pool[i]["tokens"] for i in range(n_check)]
    del state, pool, step
    rt.free(device)
    t_ref = rt.now()
    out["numbers"] = train_numbers(prog, reference(cell, seed, check, device, prog["routes"]))
    out["reference_s"] = rt.now() - t_ref
    return out


def replayed(s, batches: list, routes: list):
    """``routes``, the experts a run chose a call, as each step's list of
    each layer's; None where they do not fit one call a layer and step of
    (B x S, k) experts."""
    L, steps = s.layers, len(batches)
    if len(routes) != L * steps or any(
            r.shape != (batches[0].numel(), s.top_k) for r in routes):
        return None
    return [routes[t * L:(t + 1) * L] for t in range(steps)]


def reference(cell, seed: int, batches: list, device, routes=(), prec: str = "float32") -> dict:
    """The reference's first steps from the seed's weights: its losses, first
    gradient norms and change norms by leaf (``prec="fp8"``: the control). A
    mixture of experts takes the experts of ``routes`` (a run's record) and
    reads its own routing against them (``route``); a record that does not
    fit reads an infinite ``route_gap``, the reference then routing
    itself."""
    s, mix, qk = cell.shape, cell.mix, cell.mix.get("query_key_noise")
    routing = given = None
    if s.experts:
        given = replayed(s, batches, routes)
        routing = Routing(mix["capacity_factor"], mix["moe_aux_weight"], given)
    ref.exact()
    w = make_weights(s, seed, torch.float32, device, qk)
    got = ref.train(w, s, batches, mix["optimizer"],
                    lambda p: make_leaf(s, seed, p, torch.float32, device, qk), prec, routing)
    del w
    rt.free(device)
    if s.experts and given is None:
        got["route"]["gap"] = math.inf
    return got
