"""The comparison that decides ``correct``: the program's first training
steps against the plain reference's, from the same weights and batches.

Readings (``reference/train.py`` says how each side takes them): each
step's loss, each parameter's norm of the first gradient as the optimizer
took it, each parameter's norm of its change over the compared steps.
Five numbers come of them:

- ``loss_gap``: the largest relative gap of a step's loss,
  ``|loss - loss_ref| / |loss_ref|``; ``first_loss_gap``: that of the
  first step alone (Adam's first update moves every weight by about the
  learning rate whatever its gradient's size, so from the second step on
  the loss also carries the rounding of the smallest gradients);
- ``grad_norm_gap``: the relative gap of the first step's gradient norm
  over all parameters, before clipping, as the optimizer reports it;
- ``grad_gap``: over the parameters, the largest gap between the two
  gradient norms, ``|g - g_ref|``, measured against the reference's norm
  of that parameter or of the median parameter, whichever is larger;
- ``update_gap``: the same of the change's norms, over the parameters
  whose reference gradient is at least :data:`MOVED` times the median
  parameter's: a parameter whose gradient is nought to rounding (a key's
  bias under softmax) moves under Adam by round-off alone.

A cell compares the numbers that ``perfbench/limits/<cell>.json`` gives a
limit; the run is correct when each of them is finite and at most its
limit.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

MOVED = 1e-3
NUMBERS = ("loss_gap", "first_loss_gap", "grad_norm_gap", "grad_gap",
           "update_gap")


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
                names) -> Tuple[float, str]:
    names = list(names)
    med = statistics.median(ref[k] for k in names)
    worst, where = 0.0, ""
    for k in names:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if not math.isfinite(gap):
            return math.inf, k
        if gap > worst:
            worst, where = gap, k
    return worst, where


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The compared numbers of two sets of readings, and where the worst
    parameter of each was (``grad_worst``, ``update_worst``)."""
    if set(prog["grad"]) != set(ref["grad"]):
        raise ValueError("the two sides' parameters differ: "
                         f"{sorted(set(prog['grad']) ^ set(ref['grad']))[:5]}")
    gaps = [abs(p - r) / abs(r) if math.isfinite(p) else math.inf
            for p, r in zip(prog["loss"], ref["loss"])]
    grad_gap, grad_worst = _worst_leaf(prog["grad"], ref["grad"], ref["grad"])
    med = statistics.median(ref["grad"].values())
    moved = [k for k, g in ref["grad"].items() if g >= MOVED * med]
    update_gap, update_worst = _worst_leaf(prog["update"], ref["update"], moved)
    g0, g0_ref = prog["grad_norm"][0], ref["grad_norm"][0]
    return {"loss_gap": max(gaps), "first_loss_gap": gaps[0],
            "grad_norm_gap": abs(g0 - g0_ref) / g0_ref
            if math.isfinite(g0) else math.inf,
            "grad_gap": grad_gap,
            "update_gap": update_gap, "grad_worst": grad_worst,
            "update_worst": update_worst}


def verdict(nums: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, List[dict]]:
    """(correct, each compared number beside its limit): the numbers that
    ``limits`` names; none compared is not correct."""
    checks = [{"name": k, "value": nums[k], "limit": limits[k]}
              for k in NUMBERS if k in limits]
    ok = bool(checks) and all(math.isfinite(c["value"])
                              and c["value"] <= c["limit"] for c in checks)
    return ok, checks
