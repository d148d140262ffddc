"""The numbers that decide ``correct``, each against its limit.

Training: the program's first three steps against the reference's on the
same weights and the same rows. Compared: the first step's loss
(``loss_gap``); the norm of each leaf's first gradient as Adam received
it, worked out from Adam's first moment after one step, by the worst leaf
(``grad_gap``); the norm of each leaf's change after the three steps, by
the median leaf (``change_gap``). Norms are compared as the gap between
the program's and the reference's, over the larger of the reference's
norm of that leaf and of the median leaf. Leaves whose reference gradient
is under a thousandth of the median leaf's move by round-off alone and
are left out of the change.

The later steps' loss and the worst leaf's change are reported beside
them (``_loss_gap_3_steps``, ``_worst_change_gap``) but not compared: the
hardest-negative objective picks each row's negative by a maximum, and
where two similarities nearly tie, a pick that flips between the program
and the reference at step 2 or 3 moves one leaf's change and the later
losses by far more than rounding (on 1 seed in 52 of ``cmhse_full``).

Late steps: steps that set-up takes after the prefetcher's pinned ring has
wrapped (their batches sit in reused slots), one of each frame and word
bucket at the least. The reference repeats each from a copy of the
program's state before it (parameters, Adam's moments and step count) on
rows it pads itself. Compared, each the largest over the late steps: the
step's loss (``late_loss_gap``) and the median leaf's change
(``late_change_gap``). Starting each from the program's state keeps a
near tie at one step from carrying into the next. The worst leaf's
gradient is reported (``_late_grad_gap``) but not compared: at a near tie
within the step itself a pick flips between the program and the
reference, and a few leaves' gradients move by far more than rounding
(1 late step of about 150 read: 1.9e-4 where every other read under
5.5e-6, the program's card and CPU paths agreeing there to 1e-7 on every
leaf).
"""

from __future__ import annotations

import math

import numpy as np

FROZEN_GRAD_SHARE = 1e-3


def _norm_gap(prog: dict, ref: dict, scale_from: dict | None = None,
              keys=None) -> tuple[float, str]:
    keys = list(keys if keys is not None else ref)
    base = scale_from if scale_from is not None else ref
    median = float(np.median([base[k] for k in ref])) if ref else 0.0
    worst, leaf = 0.0, ""
    for k in keys:
        denom = max(ref[k], median, 1e-30)
        gap = abs(prog.get(k, math.nan) - ref[k]) / denom
        if not gap <= worst:  # NaN counts as the worst
            worst, leaf = (gap if gap == gap else math.inf), k
    return worst, leaf


def training_numbers(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: {"losses": [...], "grad_norms": {leaf: norm},
    "change_norms": {leaf: norm}} -> the three compared numbers."""
    losses = []
    for a, b in zip(prog["losses"], ref["losses"]):
        losses.append(abs(a - b) / max(abs(b), 1e-30))
    if len(prog["losses"]) != len(ref["losses"]):
        losses.append(math.inf)
    loss_gap = max(losses) if all(x == x for x in losses) else math.inf
    grad_gap, grad_leaf = _norm_gap(prog["grad_norms"], ref["grad_norms"])
    gmed = float(np.median(list(ref["grad_norms"].values())))
    moving = [k for k, g in ref["grad_norms"].items()
              if g >= FROZEN_GRAD_SHARE * gmed]
    change_gap, change_leaf = _norm_gap(prog["change_norms"],
                                        ref["change_norms"], keys=moving)
    cmed = float(np.median(list(ref["change_norms"].values())))
    per_leaf = [abs(prog["change_norms"].get(k, math.nan)
                    - ref["change_norms"][k])
                / max(ref["change_norms"][k], cmed, 1e-30) for k in moving]
    return {"loss_gap": losses[0], "grad_gap": grad_gap,
            "change_gap": float(np.median(per_leaf)) if per_leaf else math.inf,
            "_loss_gap_3_steps": loss_gap, "_loss_gaps": losses,
            "_worst_change_gap": change_gap,
            "_grad_leaf": grad_leaf, "_change_leaf": change_leaf,
            "_left_out": sorted(set(ref["grad_norms"]) - set(moving))}



def late_numbers(per_step: list, steps: list) -> dict:
    """The late steps' numbers (``training_numbers`` of each step, taken
    from the program's state before it), each the largest over the steps;
    no late step reads as infinitely far. The worst leaf's gradient is
    reported, not compared (``_late_grad_gap``): see the module
    docstring."""
    out = {}
    for name, key in (("late_loss_gap", "loss_gap"),
                      ("_late_grad_gap", "grad_gap"),
                      ("late_change_gap", "change_gap")):
        values = [n[key] for n in per_step]
        out[name] = (max(values) if values and all(v == v for v in values)
                     else math.inf)
    out["_late"] = [{"step": s["step"], "shape": s["shape"],
                     **{k: n[k] for k in ("loss_gap", "grad_gap",
                                          "change_gap", "_grad_leaf")}}
                    for s, n in zip(steps, per_step)]
    return out


def checks(numbers: dict, limits: dict) -> list:
    """[{name, value, limit, ok}] for every number that has a limit."""
    out = []
    for name, limit in limits.items():
        value = float(numbers[name])
        out.append({"name": name, "value": value, "limit": limit,
                    "ok": bool(value <= limit)})
    return out
