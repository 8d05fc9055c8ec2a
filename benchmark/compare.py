"""The numbers that decide ``correct``, from two sets of readings (the
program's or the control's, and the reference's), each {"loss": [...],
"grad": {leaf: norm}, "grad_vec": {leaf: gradient}, "change": {leaf:
norm}}:

  * ``loss_gap``: the largest |loss - reference| / |reference| over the
    steps (and, in TTO, the objects);
  * ``grad_gap``: over the leaves, the largest |norm - reference's norm|
    of the first step's gradient, against the larger of the reference's
    norm of that leaf and of the median leaf;
  * ``grad_leaf_gap``: the first step's gradients compared element by
    element: per leaf, the median over its elements whose reference
    gradient is not 0 of |gradient - reference's| / |reference's|;
    the least of these over the leaves.  Rounding that leaves a norm
    all but unchanged (an error across a vector moves its norm only to
    second order) shows here to first order; the least leaf, since a
    leaf whose gradient sums terms that all but cancel magnifies its
    rounding on some seeds, while a drop in the precision of every
    product shows in every leaf;
  * ``change_gap``: the same for each leaf's change over the steps,
    leaving out the leaves whose reference gradient is under a
    thousandth of the median leaf's: Adam moves those by round-off
    alone; ``change_all_gap`` the same for the change of all those
    leaves taken as one vector (the norm of their norms), which small
    leaves whose first steps flip with rounding do not swing.

A cell's limits file names the numbers it compares.  A number passes
when it is at most its limit; a number that is not finite fails.
"""

from __future__ import annotations

import math
import statistics

NAMES = ("loss_gap", "grad_gap", "grad_leaf_gap",
         "change_gap", "change_all_gap")


def _leaf_gaps(prog: dict, ref: dict, leaves) -> list:
    leaves = list(leaves)
    scale = statistics.median(ref[k] for k in leaves)
    return [abs(prog[k] - ref[k]) / max(ref[k], scale, 1e-30)
            for k in leaves]


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Every leaf's gap of both kinds, for a look at which leaf sets a
    number."""
    out = {}
    for kind in ("grad", "change"):
        scale = statistics.median(ref[kind].values())
        out[kind] = {k: abs(prog[kind][k] - ref[kind][k])
                     / max(ref[kind][k], scale, 1e-30) for k in ref[kind]}
    return out


def elem_gaps(prog: dict, ref: dict) -> dict:
    """{leaf: the median relative gap of its elements} over the leaves
    whose reference gradient is not all 0; inf for a leaf of another
    size."""
    out = {}
    for k, r in ref.items():
        p, r = prog[k].flatten(), r.flatten()
        keep = r != 0
        if len(p) != len(r):
            out[k] = math.inf
        elif bool(keep.any()):
            out[k] = float(((p - r)[keep].abs() / r[keep].abs()).median())
    return out


def numbers(prog: dict, ref: dict) -> dict:
    loss = [abs(p - r) / max(abs(r), 1e-30)
            for p, r in zip(prog["loss"], ref["loss"])]
    if len(prog["loss"]) != len(ref["loss"]):
        loss = [math.inf]
    median_grad = statistics.median(ref["grad"].values())
    moving = [k for k, g in ref["grad"].items() if g >= 1e-3 * median_grad]
    change = _leaf_gaps(prog["change"], ref["change"], moving)
    total = [math.sqrt(sum(d[k] ** 2 for k in moving))
             for d in (prog["change"], ref["change"])]
    return {"loss_gap": max(loss),
            "grad_gap": max(_leaf_gaps(prog["grad"], ref["grad"],
                                       ref["grad"])),
            "grad_leaf_gap": min(elem_gaps(prog["grad_vec"],
                                           ref["grad_vec"]).values(),
                                 default=math.inf),
            "change_gap": max(change),
            "change_all_gap": abs(total[0] - total[1])
            / max(total[1], 1e-30)}


def judge(nums: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers ``limits``
    names: each at most its limit; no limit at all fails."""
    check = {n: {"value": nums[n], "limit": limits[n]} for n in NAMES
             if n in limits}
    ok = bool(check) and all(math.isfinite(c["value"])
                             and c["value"] <= c["limit"]
                             for c in check.values())
    return ok, check
