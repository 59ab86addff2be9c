"""The comparison that decides ``correct`` for a training cell.

Set-up drives the program's trainer from the seed through its first
three steps, on three distinct batches, through the window's own call;
the plain reference follows the same three steps from the same weights
on the same rows. Three numbers come of it (each a relative gap, 0 when
the two agree):

- ``loss_gap``: the largest over the three steps of
  |loss_program − loss_reference| / |loss_reference|;
- ``grad_gap``: the first step's gradient as the optimizer got it, worked
  out from the optimizer's state after that step, against the reference's
  gradient: over the leaves, the largest gap between the two norms of a
  leaf, |‖g_p‖ − ‖g_r‖|, over the reference's norm of that leaf or of the
  median leaf, whichever is larger (some gradients are all but zero);
- ``change_gap``: the same for each leaf's change over the three steps,
  over the leaves whose reference gradient is at least a thousandth of
  the median leaf's (a leaf whose gradient is nought to rounding moves
  under the optimizer by round-off alone).

Each gap is also read over the kernels alone (``*_kernels``: the leaves
of two or more axes, the convs' and dense layers' weights), and as the
median leaf's (``*_median``). A cell compares the numbers its
``limits/<workload>.json`` names; the others are printed as readings.
"""

from __future__ import annotations

import math
import statistics

GRAD_FLOOR = 1e-3       # leaves under this share of the median gradient
                        # are left out of the change


def leaf_norms(tensors) -> list[float]:
    import torch
    if not tensors:
        return []
    return [float(x) for x in torch.stack(
        [t.detach().float().norm() for t in tensors]).cpu()]


def worst_leaf_gap(prog: list[float], ref: list[float]) -> float:
    if len(prog) != len(ref):
        raise ValueError(f"{len(prog)} leaves against {len(ref)}")
    if not ref:
        return math.inf
    med = statistics.median(ref)
    worst = 0.0
    for p, r in zip(prog, ref):
        denom = max(r, med)
        gap = abs(p - r) / denom if denom > 0 else (0.0 if p == r else math.inf)
        if not math.isfinite(p):
            gap = math.inf
        worst = max(worst, gap)
    return worst


def median_leaf_gap(prog: list[float], ref: list[float]) -> float:
    if not ref:
        return math.inf
    med = statistics.median(ref)
    return statistics.median(abs(p - r) / max(r, med) if max(r, med) > 0
                             else 0.0 for p, r in zip(prog, ref, strict=True))


def training_numbers(prog: dict, ref: dict, kernels=None) -> dict:
    """The gaps of a program run against the reference (each a dict of
    ``losses``, ``grad_norms``, ``change_norms``); ``kernels`` marks the
    leaves of two or more axes."""
    loss_gap = 0.0
    for lp, lr in zip(prog["losses"], ref["losses"], strict=True):
        gap = abs(lp - lr) / abs(lr) if lr else abs(lp)
        loss_gap = max(loss_gap, gap if math.isfinite(lp) else math.inf)
    med = statistics.median(ref["grad_norms"])
    keep = [i for i, g in enumerate(ref["grad_norms"]) if g >= GRAD_FLOOR * med]
    out = {"loss_gap": loss_gap}
    for name, key, leaves in (
            ("grad", "grad_norms", range(len(ref["grad_norms"]))),
            ("change", "change_norms", keep)):
        p = [prog[key][i] for i in leaves]
        r = [ref[key][i] for i in leaves]
        out[f"{name}_gap"] = worst_leaf_gap(p, r)
        out[f"{name}_gap_median"] = median_leaf_gap(p, r)
        if kernels is not None:
            ks = [i for i in leaves if kernels[i]]
            out[f"{name}_gap_kernels"] = worst_leaf_gap(
                [prog[key][i] for i in ks], [ref[key][i] for i in ks])
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the compared numbers:
    every one at or under its limit. A number the limits name and the run
    lacks fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks
