"""The numbers that decide ``correct``, and how they are judged.

Training: a run's first steps are read on both sides, the program's and
the plain reference's, from the same weights and batches:

* ``loss``: the widest relative gap between the two sides' loss over the
  checked steps;
* ``grad``: the first gradient as the optimizer gets it (clipped), worked
  out from the first moment after step 1 (``mu / (1 - beta1)``); for each
  leaf the gap between the two sides' norms, over the larger of the
  reference's norm of that leaf and of the median leaf; the worst leaf;
* ``grad_norm``: the relative gap between the two sides' global norm of
  the first gradient before clipping (the step's own ``grad_norm``);
* ``update``: the same as ``grad`` for each leaf's change over the checked
  steps, leaving out leaves whose reference gradient is under a thousandth
  of the median leaf's (they move by round-off alone).

Serving: ``logit_gap``, the widest gap by which a served token's logit
lies below the reference's best at its position, over a sample of the
requests the window finished.
"""

from __future__ import annotations

import math
import statistics
import sys


def _leaf_gaps(prog, ref, keep=None):
    med = statistics.median(ref.values())
    return {p: abs(prog[p] - ref[p]) / max(ref[p], med, 1e-30)
            for p in ref if keep is None or p in keep}


def compare_train(prog, ref):
    """``prog`` and ``ref``: ``{"loss": [...], "grad": {leaf: norm},
    "grad_norm": norm, "update": {leaf: norm}}``.  Returns ``(numbers,
    notes)``."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                   ref["loss"]))
    if any(not math.isfinite(x) for x in prog["loss"]):
        loss = math.inf
    grad = _leaf_gaps(prog["grad"], ref["grad"])
    med = statistics.median(ref["grad"].values())
    moving = {p for p, g in ref["grad"].items() if g >= 1e-3 * med}
    update = _leaf_gaps(prog["update"], ref["update"], moving)
    g_leaf, u_leaf = max(grad, key=grad.get), max(update, key=update.get)
    notes = {"grad_leaf": g_leaf, "update_leaf": u_leaf,
             "still_leaves": sorted(set(ref["grad"]) - moving),
             "grad_median": statistics.median(grad.values()),
             "update_median": statistics.median(update.values())}
    gnorm = abs(prog["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
    return {"loss": loss, "grad": grad[g_leaf], "grad_norm": gnorm,
            "update": update[u_leaf]}, notes


def judge(numbers, limits):
    """``(correct, checks)``: every number within its limit; ``checks``
    holds each number beside its limit, in the limits' order."""
    checks = {}
    ok = True
    for name, lim in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= lim["limit"]
        ok = ok and good
        checks[name] = {"value": v, "limit": lim["limit"]}
    return ok, checks


def print_checks(checks, stream=sys.stderr):
    """The compared numbers beside their limits, as the last lines on
    standard error."""
    for name, c in checks.items():
        v = c["value"]
        verdict = "ok" if v is not None and math.isfinite(v) and \
            v <= c["limit"] else "FAIL"
        print(f"check {name} {v!r} limit {c['limit']!r} {verdict}",
              file=stream, flush=True)
