"""The readings the limits of ``checks/<cell>.json`` are set from, on the card
at the cell's own size, in one process:

  * the program's numbers on each of ``--seeds`` (the lower readings);
  * the control's on the first ``--control`` of them: the plain reference in
    the next precision below the configuration's (fp8 products), in the
    program's place (the upper readings);
  * the cell's faults (``harness/faults.py``) on as many: for a train cell,
    half of each batch left out (the loss a mean over the rest) and the state
    returned unchanged, and for a mixture of experts each assignment
    computed by the next expert, gates of 1 / k and the router's top k
    reversed, and for a layer whose window is shorter than the sequence its
    attention over every earlier key; for a serve cell, a decode step's
    token altered, the KV cache left unwritten by decode, and decode's
    attention left out.

    python3 portbench/calibrate.py --workload <name> --seeds 11 12 ... [--control 3]

Prints one JSON line of readings a seed. Training needs no window; a
mixture of experts' reference takes the experts that each run (the
program's, or a fault's) chose, the control the program's. A serve cell's
readings come from one batch of the cell's load a seed (the same prompts
under each fault), as many requests judged as a run judges.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def _numbers(d: dict) -> dict:
    return {k: v for k, v in d.items() if not k.startswith("_")} | {"leaves": d["_leaves"]}


def train_seed(cell, step, seed: int, device, control: bool) -> dict:
    from portbench.drivers import train
    from portbench.harness import faults, runtime as rt
    from portbench.harness.compare import train_numbers
    from portbench.harness.traffic import train_pool

    batches = train_pool(dict(cell.mix, pool=cell.mix["check_steps"]), cell.shape.vocab, seed,
                         device)
    runs = {"program": train.first_steps(cell, step, seed, batches, device)[2]}
    rt.free(device)
    if control:
        for name, fault in faults.train_faults(cell.shape, cell.mix["seq"]).items():
            with fault():
                runs[name] = train.first_steps(cell, step, seed, batches, device)[2]
            rt.free(device)
    tokens = [b["tokens"] for b in batches]
    routes = runs["program"]["routes"]
    ref = train.reference(cell, seed, tokens, device, routes)
    row = {}
    for name, got in runs.items():
        want = ref if not cell.shape.experts or name == "program" else train.reference(
            cell, seed, tokens, device, got["routes"])
        row[name] = _numbers(train_numbers(got, want))
    if control:
        row["control"] = _numbers(train_numbers(
            train.reference(cell, seed, tokens, device, routes, prec="fp8"), ref))
    return row


def serve_seed(cell, seed: int, device, control: bool) -> dict:
    from portbench.drivers import serve
    from portbench.harness import faults, runtime as rt
    from portbench.harness.traffic import sample, serve_prompts
    from portbench.harness.weights import make_weights

    s, mix = cell.shape, cell.mix
    eng = serve.engine(cell, make_weights(s, seed, rt.DTYPES[mix["compute_dtype"]], device,
                                         mix.get("query_key_noise")),
                       device)
    prompts = serve_prompts(mix, s.vocab, seed, 1)
    served = {"program": eng.generate(prompts, max_new_tokens=mix["new_tokens"]).tokens}
    for name, fault in faults.SERVE.items() if control else ():
        with fault():
            served[name] = eng.generate(prompts, max_new_tokens=mix["new_tokens"]).tokens
    del eng
    rt.free(device)
    picked = sample(seed, prompts.shape[0], mix["check_requests"])
    row = {}
    for name, tokens in served.items():
        if name == "program" and control:
            got, ctl = serve.served_gap(cell, seed, tokens[picked], device, control=True)
            row |= {"program": {"logit_gap": got}, "control": {"logit_gap": ctl}}
        else:
            row[name] = {"logit_gap": serve.served_gap(cell, seed, tokens[picked], device)}
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args()
    import torch

    from portbench.harness.spec import load_cell

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    cell = load_cell(args.workload, ROOT)
    device = torch.device("cuda", 0)
    step = None
    if cell.mix["driver"] == "train":
        from portbench.drivers import train

        step = train.program(cell)
    for i, seed in enumerate(args.seeds):
        control = i < args.control
        row = (train_seed(cell, step, seed, device, control) if step is not None
               else serve_seed(cell, seed, device, control))
        print(json.dumps({"workload": args.workload, "seed": seed, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
