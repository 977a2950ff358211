"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``reference.py``), number by number, each
against its limit in ``limits/<workload>.json``.

Frames: ``off_share``, the largest share over the checked frames of the
pixels whose colour (any channel) or z differs from the reference's by
more than 1e-3 of the reference's value plus 1e-4 of the frame's mean
magnitude.  A pixel that is not finite on both sides, with the same
value, agrees; one that is finite on one side only does not.

Gradient steps, the first three: ``loss_gap``, the largest relative gap
of a step's loss; ``grad_gap``, the gap between the norms of the first
step's gradient, the program's and the reference's, by the worst leaf;
``change_gap``, the same for the change of each updated leaf after the
three steps.  A gap is taken against the reference's norm of that leaf
or of the median leaf, whichever is larger; leaves whose reference norm
is under a thousandth of the median leaf's are nought to rounding and
left out.
"""

from __future__ import annotations

import json
import math
import os
import statistics

import torch

RTOL, MEAN_TOL = 1e-3, 1e-4
NEGLIGIBLE = 1e-3


def _off(a, b):
    """Per element: a and b disagree (see the module's rule)."""
    a, b = a.double(), b.double()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    both = fa & fb
    scale = b[fb].abs().mean() if bool(fb.any()) else torch.zeros(())
    tol = RTOL * b.abs() + MEAN_TOL * scale
    close = both & ((a - b).abs() <= tol)
    same_nonfinite = ~fa & ~fb & ((a == b) | (torch.isnan(a)
                                              & torch.isnan(b)))
    return ~(close | same_nonfinite)


def frame_numbers(img, z, ref_img, ref_z) -> dict:
    """``off_share`` of one frame (image (H, W, 3), z (H, W))."""
    off = _off(img, ref_img).any(-1) | _off(z, ref_z)
    return {"off_share": float(off.double().mean())}


def _norms(d: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in d.items()
            if v.numel()}


def _worst_gap(prog: dict, ref: dict) -> tuple[float, str]:
    """The largest gap between norms over the leaves that count, and its
    leaf."""
    pn, rn = _norms(prog), _norms(ref)
    med = statistics.median(rn.values())
    worst, leaf = 0.0, ""
    for k, r in rn.items():
        if r < NEGLIGIBLE * med:
            continue
        gap = abs(pn[k] - r) / max(r, med)
        if not math.isfinite(gap):      # a norm that is not a number
            gap = math.inf
        if gap > worst:
            worst, leaf = gap, k
    return worst, leaf


def step_numbers(prog: dict, ref: dict) -> dict:
    """prog and ref hold ``losses`` (three floats), ``grad1`` (leaf name ->
    first step's gradient) and ``change`` (updated leaf -> its change after
    three steps)."""
    loss_gap = max(abs(p - r) / abs(r) if math.isfinite(p) else math.inf
                   for p, r in zip(prog["losses"], ref["losses"]))
    grad_gap, grad_leaf = _worst_gap(prog["grad1"], ref["grad1"])
    change_gap, change_leaf = _worst_gap(prog["change"], ref["change"])
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap,
            "_leaves": {"grad_gap": grad_leaf, "change_gap": change_leaf}}


def limits(root: str, workload: str) -> dict:
    """The cell's limits: {number: limit}."""
    with open(os.path.join(root, "benchmark", "limits",
                           f"{workload}.json")) as f:
        return {k: v["limit"] for k, v in json.load(f).items()}


def judge(numbers: dict, lim: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): every number at or under
    its limit (so none missing and none a NaN)."""
    ok = all(isinstance(numbers.get(k), float) and numbers[k] <= v
             for k, v in lim.items())
    # JSON has no inf or nan: a number that is not finite shows as null
    shown = {k: {"value": numbers[k] if isinstance(numbers.get(k), float)
                 and math.isfinite(numbers[k]) else None, "limit": v}
             for k, v in lim.items()}
    return ok, shown
