"""The numbers that decide `correct`, from the program's readings and the
reference's.

Training: each step's loss (relative gap: the first step's alone, and the
largest over the steps), the first gradient and the parameters' change
after the first steps, each by the worst leaf: the gap
between the program's norm of the leaf and the reference's, over the
reference's norm of that leaf or of the median leaf, whichever is larger.
Leaves whose reference gradient is under a thousandth of the median
leaf's move under Adam by round-off alone; they are left out of the
change.
"""

from __future__ import annotations

import numpy as np
import torch

ZERO_GRAD = 1e-3


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.norm(v.double())) for k, v in d.items()}


def worst_leaf(prog: dict, ref: dict, keys) -> tuple:
    """(gap, leaf) of the worst leaf among keys."""
    np_, nr = _norms({k: prog[k] for k in keys}), _norms(
        {k: ref[k] for k in keys})
    med = float(np.median(list(nr.values())))
    gaps = {k: abs(np_[k] - nr[k]) / max(nr[k], med, 1e-30) for k in keys}
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def training(losses_p, losses_r, g_p, g_r, w0, w_p, w_r) -> dict:
    """{number: value} of the program's (losses, first gradient g_p,
    weights w_p after the steps) against the reference's, both from w0."""
    steps = [abs(a - b) / max(abs(b), 1e-30)
             for a, b in zip(losses_p, losses_r)]
    grad, grad_leaf = worst_leaf(g_p, g_r, list(g_r))
    gn = _norms(g_r)
    med = float(np.median(list(gn.values())))
    moved = [k for k in g_r if gn[k] >= ZERO_GRAD * med]
    d_p = {k: w_p[k].double() - w0[k].double() for k in moved}
    d_r = {k: w_r[k].double() - w0[k].double() for k in moved}
    change, change_leaf = worst_leaf(d_p, d_r, moved)
    return {"first_loss_rel": steps[0], "loss_rel": max(steps),
            "grad_norm_gap": grad, "_step_loss_rel": steps,
            "change_norm_gap": change, "_grad_leaf": grad_leaf,
            "_change_leaf": change_leaf,
            "_left_out": sorted(set(g_r) - set(moved))}


def numbers(readings: dict) -> dict:
    """The compared numbers only (keys without a leading underscore)."""
    return {k: v for k, v in readings.items() if not k.startswith("_")}
