"""How ``correct`` is decided for a training cell: the program's first
steps held against the plain reference's on the same weights and rows.

Both sides give *readings*: ``loss`` (each checked step's loss on this
rank), ``grad1`` (each leaf's norm of the first gradient as the
optimizer got it) and ``change`` (each leaf's norm of the parameters'
change after the checked steps).  The reference also gives ``gmax``,
each leaf's largest gradient norm over those steps.  Three numbers are
compared, each against its limit in ``limits/<workload>.json``:

- ``loss_rel``: the largest ``|loss - ref| / |ref|`` over the steps;
- ``grad1_gap``: over the leaves, the largest gap between the two norms
  of the first gradient, ``|g - ref| / max(ref, median ref)`` (the
  median over the leaves whose reference gradient is not exactly 0);
- ``change_gap``: the same of the change, leaving out the leaves whose
  reference gradient stays under a thousandth of the median leaf's
  (round-off moves them under Adam, whatever their gradient)."""

from __future__ import annotations

import math
import statistics

NUMBERS = ("loss_rel", "grad1_gap", "change_gap")
# A leaf whose reference gradient is below this share of the median
# leaf's is nought to rounding, and is left out of the change.
QUIET_LEAF = 1e-3


def median_leaf(ref: dict) -> float:
    """The median of the leaves' norms, over the leaves the reference
    moves at all (a gradient that is exactly nought, as behind a norm
    whose scale starts at 0, is no leaf's typical size)."""
    moved = [v for v in ref.values() if v > 0]
    return statistics.median(moved) if moved else 0.0


def worst_leaf_gap(prog: dict, ref: dict, leaves=None) -> tuple:
    """(gap, leaf) of the worst leaf: ``|prog - ref|`` over the larger of
    the reference's norm of that leaf and of the median leaf."""
    med = median_leaf(ref)
    worst, at = 0.0, None
    for k in (ref if leaves is None else leaves):
        if k not in prog:
            return math.inf, k                      # a leaf never read
        diff, scale = abs(prog[k] - ref[k]), max(ref[k], med)
        gap = diff / scale if scale > 0 else (0.0 if diff == 0
                                              else math.inf)
        if not math.isfinite(gap):
            return math.inf, k
        if gap > worst:
            worst, at = gap, k
    return worst, at


def gaps(prog: dict, ref: dict) -> dict:
    """The three numbers and where the worst leaf lies."""
    losses = list(zip(prog["loss"], ref["loss"]))
    if len(prog["loss"]) != len(ref["loss"]):
        loss_rel = math.inf
    else:
        loss_rel = max((abs(a - b) / abs(b) if math.isfinite(a)
                        else math.inf) for a, b in losses)
    g1, g1_at = worst_leaf_gap(prog["grad1"], ref["grad1"])
    med = median_leaf(ref["gmax"])
    moving = [k for k, v in ref["gmax"].items() if v >= QUIET_LEAF * med]
    ch, ch_at = worst_leaf_gap(prog["change"], ref["change"], moving)
    return {"loss_rel": loss_rel, "grad1_gap": g1, "change_gap": ch,
            "grad1_worst_leaf": g1_at, "change_worst_leaf": ch_at,
            "quiet_leaves": len(ref["gmax"]) - len(moving)}


def compare(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number at or under its
    limit, and finite."""
    rows = [(n, numbers[n], limits[n]) for n in NUMBERS if n in limits]
    ok = bool(rows) and all(math.isfinite(v) and v <= lim
                            for _, v, lim in rows)
    return ok, rows


def worst(per_rank: list) -> dict:
    """The worst of each number over the ranks."""
    return {n: max(g[n] for g in per_rank) for n in NUMBERS}
