"""The comparison that decides `correct`: numbers worked out from the
program's outputs and the reference's, each held against the cell's limit
for it (`limits` in the cell's file; PERF.md gives the readings each
limit was set from). A number the cell gives no limit is not compared.

Training compares two checks of steps that set-up drove through the
window's own call (`jobs/train.py`), each number named
`<check>.<number>`: each step's loss (`loss_gap`, the largest relative
gap), the norm of each leaf's first gradient as Adam holds it after one
step (`grad_gap`, the worst leaf; `grad_gap_median`, the median leaf),
the norm of each trainable leaf's change over the steps (`update_gap`)
and, where the model has BatchNorm, of each running statistic's change
(`bn_gap`). A leaf's gap is |norm_program - norm_reference| over the
larger of the reference's norm of that leaf and of the median leaf.
Leaves whose reference first gradient is under a thousandth of the
median leaf's move by round-off alone under Adam and are left out of
`update_gap` and `grad_gap_median`."""

from __future__ import annotations

import math
import statistics
import sys
from typing import Dict, Iterable, Optional

# below this share of the median leaf's first gradient a leaf's change
# under Adam is round-off
QUIET_LEAF = 1e-3


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b != 0 else (0.0 if a == 0 else math.inf)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's |prog - ref| / max(ref, median of ref)."""
    if not ref:
        return {}
    med = statistics.median(ref.values())
    out = {}
    for name in (ref if leaves is None else leaves):
        r, p = ref[name], prog.get(name, 0.0)
        den = max(r, med)
        gap = abs(p - r) / den if den > 0 else (0.0 if p == 0 else math.inf)
        out[name] = gap if math.isfinite(p) else math.inf
    return out


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves: Optional[Iterable[str]] = None) -> float:
    """The worst leaf's gap."""
    return max(leaf_gaps(prog, ref, leaves).values(), default=0.0)


def moving_leaves(ref_grad: Dict[str, float]):
    """The leaves whose reference first gradient is at least QUIET_LEAF of
    the median leaf's."""
    med = statistics.median(ref_grad.values()) if ref_grad else 0.0
    return [n for n, g in ref_grad.items() if g >= QUIET_LEAF * med]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The compared numbers of two sets of train readings (`losses`,
    `grad`, `update`, and `bn` where present)."""
    moving = moving_leaves(ref["grad"])
    grads = leaf_gaps(prog["grad"], ref["grad"])
    out = {
        "loss_gap": max(rel_gap(p, r) if math.isfinite(p) else math.inf
                        for p, r in zip(prog["losses"], ref["losses"])),
        "grad_gap": max(grads.values(), default=0.0),
        "grad_gap_median": statistics.median(grads[n] for n in moving)
        if moving else 0.0,
        "update_gap": leaf_gap(prog["update"],
                               {n: ref["update"][n] for n in moving}),
    }
    if ref.get("bn"):
        out["bn_gap"] = leaf_gap(prog["bn"], ref["bn"])
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): correct where every number
    is finite and at most its limit, and every limit has its number."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks


def print_checks(checks: dict, stream=sys.stderr) -> None:
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=stream)
