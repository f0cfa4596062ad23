"""The serve driver: the port's ``ServeEngine.generate`` in a closed loop of
static batches, on weights and prompts made from the seed.

Set-up makes the weights in the type they are served in and serves one whole
batch (the warm-up of every shape the window uses). The window then serves
batch after batch until ``seconds`` have passed, the batch in progress
finishing. Once it has closed, the program freed and the peak memory read,
a sample of the window's requests drawn from the seed is judged by the plain
reference's full forward over each prompt and its served tokens.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.harness import runtime as rt
from portbench.harness.traffic import sample, serve_prompts
from portbench.harness.weights import make_weights, widened
from portbench.refs import lm as ref


def engine(cell, params, device):
    from repro_torch.models.lm import ModelCfg
    from repro_torch.serve.engine import ServeEngine

    rt.check_port_constants(cell.shape)
    cfg = ModelCfg(dtype=rt.DTYPES[cell.mix["compute_dtype"]])
    return ServeEngine(rt.port_arch(cell.shape), cfg, params, max_len=cell.mix["max_len"],
                       device=device)


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    s, mix = cell.shape, cell.mix
    B, N = mix["batch"], mix["new_tokens"]
    if mix["sampling"] != "greedy":
        raise ValueError("the check of served tokens holds for greedy sampling only")
    params = make_weights(s, seed, rt.DTYPES[mix["compute_dtype"]], device,
                          mix.get("query_key_noise"))
    eng = engine(cell, params, device)
    del params
    eng.generate(serve_prompts(mix, s.vocab, seed, 0), max_new_tokens=N)
    rt.sync(device)
    setup_s = rt.now() - t_start

    served = []  # (tokens, prefill_s, step_s) a batch
    t0 = rt.now()
    while True:
        r = eng.generate(serve_prompts(mix, s.vocab, seed, len(served) + 1), max_new_tokens=N)
        served.append((r.tokens, r.prefill_time, r.step_times, r.warmup_steps))
        if rt.now() - t0 >= seconds:
            break
    wall = rt.now() - t0
    memory_peak = rt.memory_peak(device)
    out = {"setup_s": setup_s, "serve_tokens_per_s": B * N * len(served) / wall,
           "attempted": B * len(served),
           "failed": sum(int(((t < 0) | (t >= s.vocab)).any(axis=1).sum())
                         for t, _, _, _ in served),
           "memory_peak_bytes": memory_peak}
    record = {"kind": "serve", "shape": s, "mix": mix, "window_s": wall,
              "batches": len(served), "prefill_s": [p for _, p, _, _ in served],
              "step_s": [list(st[w:]) for _, _, st, w in served],
              # each request sees token i + 1 one decode step after token i;
              # the last decode step's logits are not served
              "gaps_s": [t for _, _, st, _ in served for t in st[:N - 1] for _ in range(B)]}
    out["record"] = record
    if trace:
        from portbench.harness.trace import profile_agreeing

        index = [len(served) + 1]

        def one_batch():
            eng.generate(serve_prompts(mix, s.vocab, seed, index[0]), max_new_tokens=N)
            index[0] += 1

        record["trace"] = profile_agreeing(one_batch, mix["profile_batches"],
                                           lambda: rt.sync(device), rt.launch_counters)
    tokens = np.concatenate([t for t, _, _, _ in served])
    del eng
    rt.free(device)
    picked = sample(seed, tokens.shape[0], mix["check_requests"])
    t_ref = rt.now()
    out["numbers"] = {"logit_gap": served_gap(cell, seed, tokens[picked], device)}
    out["reference_s"] = rt.now() - t_ref
    return out


def reference_logits(cell, seed: int, tokens: np.ndarray, device, prec: str = "float32"):
    """The reference's logits (n, new_tokens, V) at the positions that chose
    each served token of ``tokens`` (n, prompt + new_tokens), from the served
    weights (made again from the seed) widened to float32."""
    s, mix = cell.shape, cell.mix
    P, N = mix["prompt_len"], mix["new_tokens"]
    ref.exact()
    w = widened(make_weights(s, seed, rt.DTYPES[mix["compute_dtype"]], device,
                             mix.get("query_key_noise")))
    seqs = torch.from_numpy(tokens[:, :P + N - 1]).to(device)
    got = ref.logits_at(w, s, seqs, list(range(P - 1, P + N - 1)), prec)
    del w
    rt.free(device)
    return got


def served_gap(cell, seed: int, tokens: np.ndarray, device, control: bool = False):
    """The widest gap by which a served token's reference logit lies below
    the reference's best at its position. With ``control``, also that of the
    tokens the control (the reference with fp8 products) puts first at the
    same positions: ``(gap, control's gap)``."""
    P = cell.mix["prompt_len"]
    logits = reference_logits(cell, seed, tokens, device)
    best = logits.max(-1).values

    def gap(picked):
        return float((best - logits.gather(-1, picked[..., None])[..., 0]).max())

    got = gap(torch.from_numpy(tokens[:, P:]).to(device))
    if not control:
        return got
    return got, gap(reference_logits(cell, seed, tokens, device, prec="fp8").argmax(-1))
