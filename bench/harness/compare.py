"""The numbers that decide ``correct``, each beside its limit from the
cell's file (``check.limits``; a number whose limit is null is printed and
not compared).

Training: the gap between the port's and the reference's loss at each
checked step, relative to the reference's; and, by the worst leaf, the gap
between the norms of the first gradient as the optimizer takes it, and of
the weights' change over the checked steps, each relative to the larger of
the reference's norm of that leaf and of the median leaf.  The change
leaves out leaves whose reference gradient is under a thousandth of the
median leaf's (nought but rounding moves them under Adam).

Serving: the widest gap by which a served token's logit lies below the
reference's best at its position, over the sampled requests."""
from __future__ import annotations

import math
import statistics


def _worst_leaf(prog: dict, ref: dict, keep=None) -> tuple[float, str]:
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in names)
    worst, at = 0.0, ""
    for n in names:
        gap = abs(prog.get(n, math.nan) - ref[n]) / max(ref[n], med, 1e-30)
        if not gap <= worst:          # NaN counts as worst
            worst, at = gap, n
    return worst, at


def train_numbers(prog: dict, ref: dict) -> dict:
    """{name: (value, where)} from the port's and the reference's readings
    (``reference.train.run``'s keys)."""
    loss = max((abs(p - r) / abs(r) if math.isfinite(p) else math.inf, i)
               for i, (p, r) in enumerate(zip(prog["loss"], ref["loss"])))
    med = statistics.median(ref["grad_norm"].values())
    keep = {n for n, g in ref["grad_norm"].items() if g >= 1e-3 * med}
    g, gat = _worst_leaf(prog["grad_norm"], ref["grad_norm"])
    c, cat = _worst_leaf(prog["change"], ref["change"], keep)
    return {"loss_gap": (loss[0], f"step {loss[1] + 1}"), "grad_gap": (g, gat),
            "change_gap": (c, cat)}


def checks(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, the result line's ``checks``): every number with a limit
    at most its limit."""
    out, ok = {}, True
    for name, (value, where) in numbers.items():
        limit = limits.get(name)
        out[name] = {"value": value, "limit": limit, "at": where}
        if limit is not None and not value <= limit:
            ok = False
    return ok, out
