"""The numbers that decide ``correct``, each against the limit that
``checks/<cell>.json`` sets for it.

Training (per leaf of the params tree, worst leaf):
  * ``loss_gap``: the widest |program - reference| / |reference| of the
    losses of the first steps;
  * ``grad_gap``: the first step's gradient as the optimizer gets it (after
    clipping), each leaf's norm: |program - reference| over the larger of
    the reference leaf's norm and the median leaf's;
  * ``update_gap``: the same of each leaf's change over the first steps.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's move by round-off alone and are left out of it.
  * of a mixture of experts, whose reference takes the experts the program
    chose (so that the numbers above see arithmetic only), ``route_gap``:
    the widest over tokens, layers and steps of the reference's own k-th
    largest router logit less its logit of the lowest-ranked expert the
    program chose, over the spread of the token's logits (``refs/moe.py``):
    0 where the choices agree, a rounding on a near-tie, about 1 for a
    wrong router; infinite where the program's record of its choices does
    not fit the steps. Reported beside it and not compared:
    ``route_differed`` and ``route_dropped``, the shares of token-layers
    whose chosen experts differ from the reference's own and of assignments
    past their expert's capacity.
Serving:
  * ``logit_gap``: the widest gap by which a served token's logit lies below
    the reference's best at its position.
"""
from __future__ import annotations

import math
import statistics

TINY_GRAD = 1e-3  # of the median leaf's gradient norm


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's |prog - ref| / max(ref, the median leaf's ref)."""
    med = statistics.median(ref.values())
    return {path: abs(prog.get(path, math.nan) - r) / max(r, med, 1e-30)
            for path, r in ref.items() if keep is None or path in keep}


def _worst(gaps: dict) -> float:
    return max(gaps.values(), key=lambda g: math.inf if math.isnan(g) else g)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {"losses": [...], "grad_norms": {leaf: norm},
    "change_norms": {leaf: norm}}. The leaves' gaps come along under
    ``_leaves``."""
    loss_gap = max((abs(p - r) / abs(r) if math.isfinite(p) else math.inf)
                   for p, r in zip(prog["losses"], ref["losses"]))
    grads = ref["grad_norms"]
    med = statistics.median(grads.values())
    moved = {k for k, v in grads.items() if v >= TINY_GRAD * med}
    grad = leaf_gaps(prog["grad_norms"], grads)
    update = leaf_gaps(prog["change_norms"], ref["change_norms"], moved)
    out = {"loss_gap": loss_gap, "grad_gap": _worst(grad), "update_gap": _worst(update),
           "_leaves": {"grad": grad, "update": update, "left_out": sorted(set(grads) - moved)}}
    if "route" in ref:
        out |= {"route_gap": ref["route"]["gap"], "route_differed": ref["route"]["differed"],
                "route_dropped": ref["route"]["dropped"]}
    return out


def verdict(numbers: dict, checks: dict) -> tuple[bool, dict]:
    """Each number the cell's checks compare, beside its limit; ``correct``
    when none is over it (a NaN is over every limit, and so is a number
    compared but missing). Numbers the checks do not list are not compared."""
    out, ok = {}, bool(checks["numbers"])
    for name, check in checks["numbers"].items():
        value = numbers.get(name, float("nan"))
        ok = ok and value <= check["limit"]
        out[name] = {"value": value, "limit": check["limit"]}
    return ok, out
