"""Host-side metrics helpers (the part of ``repro/obs/metrics.py`` the
serving engine uses)."""
from __future__ import annotations

import math


def percentiles(values, qs=(50, 95, 99)) -> dict:
    """``{"p50": ..., }`` over a value list (empty -> {})."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return {}
    out = {}
    for q in qs:
        # nearest-rank on the sorted list
        k = max(0, min(len(vals) - 1, math.ceil(q / 100 * len(vals)) - 1))
        out[f"p{q}"] = vals[k]
    return out
