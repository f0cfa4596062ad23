"""The train driver: the port's ``make_train_step`` on weights and batches
made from the seed.

Set-up builds one train step with its params and AdamW state and drives it
through the mix's ``check_steps`` first steps (also its warm-up), on batches
whose rows all differ. The same objects then run the window: whole steps,
each ended by a device synchronise, until ``seconds`` have passed. The check
follows the first steps with the plain reference once the window has
closed, the program's state is freed and the peak memory read.
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
    model_cfg = ModelCfg(dtype=rt.DTYPES[mix["compute_dtype"]], remat=mix["remat"])
    step_cfg = TrainStepCfg(num_microbatches=mix["microbatches"], base_lr=opt["base_lr"],
                            warmup_steps=opt["warmup_steps"], total_steps=opt["total_steps"],
                            weight_decay=opt["weight_decay"], clip_norm=opt["clip_norm"])
    return make_train_step(rt.port_arch(s), model_cfg, step_cfg)


class Spans:
    """CUDA events at each step's start and around the port's
    ``adamw_update``, which the step looks up in its module at each call: the
    forward + backward is start to the optimizer's entry."""

    def __init__(self):
        self.rows = []

    def __enter__(self):
        from repro_torch.train import train_step

        self._module, self._real = train_step, train_step.adamw_update

        def timed(*args, **kwargs):
            enter, leave = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            enter.record()
            out = self._real(*args, **kwargs)
            leave.record()
            self.rows[-1] += [enter, leave]
            return out

        train_step.adamw_update = timed
        return self

    def start(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.rows.append([ev])

    def __exit__(self, *exc):
        self._module.adamw_update = self._real

    def read(self) -> dict:
        done = [r for r in self.rows if len(r) == 3]
        return {"fwd_bwd_ms": [a.elapsed_time(b) for a, b, _ in done],
                "optimizer_ms": [b.elapsed_time(c) for _, b, c in done]}


def first_steps(cell, step, seed: int, batches: list, device):
    """Params and AdamW state from the seed, driven through ``batches`` by
    the program's ``step``: ``(params, opt, readings)``, the readings being
    each step's loss, each leaf's norm of the first step's clipped gradient
    (from AdamW's first moment, (1 - b1) x that gradient) and of its change
    over the steps."""
    from repro_torch.train import adamw_init

    s, f32, b1 = cell.shape, torch.float32, cell.mix["optimizer"]["b1"]
    qk = cell.mix.get("query_key_noise")
    params = make_weights(s, seed, f32, device, qk)
    opt = adamw_init(params)
    prog = {"losses": [], "grad_norms": {}, "change_norms": {}}
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

    def one_step(spans=None):
        if spans is not None:
            spans.start()
        state["params"], state["opt"], m = step(state["params"], state["opt"],
                                                pool[state["i"] % len(pool)])
        state["i"] += 1
        rt.sync(device)
        return float(m["loss"])

    spans = Spans() if trace else None
    steps = failed = 0
    t0 = rt.now()
    with spans or contextlib.nullcontext():
        while True:
            failed += not math.isfinite(one_step(spans))
            steps += 1
            if rt.now() - t0 >= seconds:
                break
        wall = rt.now() - t0
    memory_peak = rt.memory_peak(device)
    tokens = mix["batch"] * mix["seq"]
    record = {"kind": "train", "shape": cell.shape, "mix": mix, "window_s": wall, "steps": steps,
              "tokens": tokens * steps}
    out = {"setup_s": setup_s, "train_tokens_per_s": tokens * steps / wall,
           "attempted": steps, "failed": failed, "memory_peak_bytes": memory_peak,
           "record": record}
    if trace:
        from portbench.harness.trace import profile_agreeing

        record["spans"] = spans.read()
        record["trace"] = profile_agreeing(one_step, mix["profile_steps"],
                                           lambda: rt.sync(device), rt.launch_counters)

    check = [pool[i]["tokens"] for i in range(n_check)]
    del state, pool, step
    rt.free(device)
    t_ref = rt.now()
    out["numbers"] = train_numbers(prog, reference(cell, seed, check, device))
    out["reference_s"] = rt.now() - t_ref
    return out


def reference(cell, seed: int, batches: list, device, prec: str = "float32") -> dict:
    """The reference's first steps from the seed's weights: its losses, first
    gradient norms and change norms by leaf (``prec="fp8"``: the control)."""
    s, qk = cell.shape, cell.mix.get("query_key_noise")
    ref.exact()
    w = make_weights(s, seed, torch.float32, device, qk)
    got = ref.train(w, s, batches, cell.mix["optimizer"],
                    lambda p: make_leaf(s, seed, p, torch.float32, device, qk), prec)
    del w
    rt.free(device)
    return got
