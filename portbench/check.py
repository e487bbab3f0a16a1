"""The comparison that decides ``correct`` for a training cell.

The program and the reference each start from the same inputs and take the
same first steps (the same cameras and draws). Three numbers are compared,
each against its limit in ``portbench/limits.json``:

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the first step's gradient as the optimiser got it, by the
  worst leaf: the gap between the two sides' norms of a leaf over the larger
  of the reference's norm of that leaf and of the median leaf;
- ``change_gap``: the same for each leaf's change over the steps, leaving
  out the leaves whose reference gradient is under a thousandth of the
  median leaf's (their moves are round-off that Adam scales up); rows that
  densification added count by their value;
- ``densify_gap``: the densify event among the steps, by its rows: the
  source rows cloned, split or pruned on one side and not on the other,
  plus the gap of the Gaussian counts after it, over the rows the
  reference cloned, split or pruned (0 where no step densifies).
"""

from __future__ import annotations

import json
import os
import statistics

import torch

LIMITS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "limits.json")
NUMBERS = ("loss_gap", "grad_gap", "change_gap", "densify_gap")
FLAT_SHARE = 1e-3


def norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def worst_leaf(prog: dict, ref: dict, names) -> tuple:
    names = list(names)
    med = statistics.median(ref[k] for k in names)
    per = {k: abs(prog[k] - ref[k]) / max(ref[k], med) if max(ref[k], med) > 0 else 0.0
           for k in names}
    return max(per.values()), per


def densify_gap(prog: dict | None, ref: dict | None) -> float:
    """Readings ``{"cloned", "split", "pruned": [row, ...], "n_active"}``."""
    if ref is None and prog is None:
        return 0.0
    if ref is None or prog is None:
        return float("inf")
    kinds = ("cloned", "split", "pruned")
    differ = sum(len(set(prog[k]) ^ set(ref[k])) for k in kinds)
    differ += abs(prog["n_active"] - ref["n_active"])
    return differ / max(1, sum(len(ref[k]) for k in kinds))


def summary(dens: dict | None) -> dict | None:
    """A densify reading with its rows counted."""
    if dens is None:
        return None
    return {k: len(v) if isinstance(v, list) else v for k, v in dens.items()}


def compare(prog: dict, ref: dict) -> dict:
    """Readings ``{"losses": [...], "grad": {leaf: norm}, "change": {leaf:
    norm}, "densify": {...} or None}`` of both sides → the compared numbers
    and their parts."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    grad_gap, grad_per = worst_leaf(prog["grad"], ref["grad"], ref["grad"])
    med = statistics.median(ref["grad"].values())
    moved = [k for k, g in ref["grad"].items() if g >= FLAT_SHARE * med]
    change_gap, change_per = worst_leaf(prog["change"], ref["change"], moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "densify_gap": densify_gap(prog.get("densify"), ref.get("densify")),
            "parts": {"grad": grad_per, "change": change_per,
                      "densify": {side: summary(r.get("densify"))
                                  for side, r in (("program", prog), ("reference", ref))},
                      "left_out": sorted(set(ref["grad"]) - set(moved))}}


def load_limits() -> dict:
    with open(LIMITS) as f:
        return json.load(f)


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}})."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(c["value"] == c["value"] and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
