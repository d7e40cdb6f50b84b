"""The comparison that decides ``correct``: the program's outputs against
the plain reference's, as numbers each held to a limit of its own.

* ``loss_gap``: the largest relative gap between the program's objective
  and the reference's after any outer of the warm-up and of the window's
  first outers (the inner steps, the flush, the snapshot's margins);
* ``grad_gap``: the same for the norm of the full gradient ``|z + lam w|``
  (the snapshot's coefficients and scatter);
* ``change_gap``: the gap between the norms of the iterate's change over
  the warm-up (from zeros), over the reference's norm.

A missing outer or a number that is not finite reads infinity.  The
limits of a cell live in ``bench/limits/<cell>.json``; a number with no
limit fails.
"""

from __future__ import annotations

import math

NAMES = ("loss_gap", "grad_gap", "change_gap")


def _rel(a: float, b: float) -> float:
    gap = abs(a - b) / abs(b) if b != 0 else abs(a - b)
    return gap if math.isfinite(gap) else math.inf


def _worst(got: list[float], want: list[float]) -> float:
    if len(got) != len(want) or not want:
        return math.inf
    return max(_rel(a, b) for a, b in zip(got, want))


def numbers(got, want) -> dict[str, float]:
    """The compared numbers of program (or stand-in) outputs ``got``
    against reference outputs ``want`` (both ``Outputs``)."""
    return {
        "loss_gap": _worst(got.objectives, want.objectives),
        "grad_gap": _worst(got.grad_norms, want.grad_norms),
        "change_gap": _rel(got.change_norm, want.change_norm),
    }


def judge(nums: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """``correct`` and each number beside its limit."""
    checks = {k: {"value": nums[k], "limit": limits.get(k)} for k in NAMES}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
