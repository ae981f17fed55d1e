"""The numbers the output check compares, each against the reference.

Serving: the widest relative gap between a request's total cycles as the
service returned it and as the reference computes them.  Training: the
widest relative gap of a step's loss; by the worst leaf, the gap between
the norms of the program's and the reference's first gradient (as the
optimizer holds it after one step); and the gap between the norms of the
parameters' change over the first steps, by the median leaf and by the
worst.  A leaf's gap is taken against the larger of its reference norm
and the median leaf's.  The median leaf's change is steady from seed to
seed and separates the control widely; the worst leaf's is the rounding
noise of a small leaf (``head/w2``, 128 numbers) that swings tenfold from
seed to seed, and is held to a wider limit, so that a leaf the program
leaves unmoved, or moves double, reads about 1 and fails it.
"""
from __future__ import annotations

import math
from statistics import median
from typing import Dict, List, Optional, Tuple

# A leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone and is left out of the change.
STILL_LEAF = 1e-3


def widest_gap(got: List[float], want: List[float]) -> float:
    """The widest relative gap of paired values."""
    return max(abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want))


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              skip: Tuple[str, ...] = ()) -> Dict[str, float]:
    """{leaf: the gap of its norms over the larger of its reference norm
    and the median leaf's}."""
    floor = median(want.values())
    return {k: abs(got[k] - w) / max(w, floor, 1e-30)
            for k, w in want.items() if k not in skip}


def still_leaves(grad_norms: Dict[str, float]) -> Tuple[str, ...]:
    floor = median(grad_norms.values())
    return tuple(k for k, v in grad_norms.items() if v < STILL_LEAF * floor)


def train_readings(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref`` each hold ``losses`` (per step), ``grad``
    ({leaf: norm of the first clipped gradient}) and ``change`` ({leaf:
    norm of the parameters' change over the steps})."""
    skip = still_leaves(ref["grad"])
    g = leaf_gaps(prog["grad"], ref["grad"])
    d = leaf_gaps(prog["change"], ref["change"], skip)
    g_leaf, d_leaf = max(g, key=g.get), max(d, key=d.get)
    return {"loss_gap": widest_gap(prog["losses"], ref["losses"]),
            "grad_gap": g[g_leaf], "change_gap": median(d.values()),
            "change_worst_gap": d[d_leaf], "grad_leaf": g_leaf,
            "change_leaf": d_leaf, "still_leaves": list(skip)}


def leaf_norms(named) -> Dict[str, float]:
    """{path: float64 L2 norm} of (path, tensor) pairs."""
    return {k: math.sqrt(float(v.double().square().sum())) for k, v in named}
