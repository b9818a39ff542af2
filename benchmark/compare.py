"""The numbers a cell's ``correct`` compares, worked out from the program's
readings and the reference's.

Norm gaps are taken leaf by leaf: the gap between the program's norm of a
leaf and the reference's (not the norm of their difference), over the
reference's norm of that leaf or of the median leaf, whichever is larger,
since some gradients are all but zero; the worst leaf gives the number.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional

# Leaves whose reference gradient is under this share of the median leaf's
# move under Adam by round-off alone, and are left out of the update's gap.
ROUNDOFF_GRAD_SHARE = 1e-3


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves: Optional[Iterable[str]] = None) -> float:
    keys = list(ref if leaves is None else leaves)
    median = statistics.median(ref[k] for k in ref)
    return max(abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], median) for k in keys)


def moved_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding."""
    median = statistics.median(ref_grad.values())
    return [k for k, g in ref_grad.items() if g >= ROUNDOFF_GRAD_SHARE * median]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref`` each hold ``losses`` (each step's), ``grad`` (the
    first step's gradient norm per leaf; ``prog`` may lack it) and
    ``update`` (the norm per leaf of the parameters' change over the steps).

    loss_gap: the largest relative gap of a step's loss.
    grad_gap: the worst leaf's gap of the first gradient's norm, where
    ``prog`` has it.
    update_gap: the worst moved leaf's gap of the change's norm."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss = float("inf")
    out = {"loss_gap": loss}
    if "grad" in prog:
        out["grad_gap"] = norm_gap(prog["grad"], ref["grad"])
    out["update_gap"] = norm_gap(prog["update"], ref["update"], moved_leaves(ref["grad"]))
    return out
