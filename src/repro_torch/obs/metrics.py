"""Host-side metrics helpers (the parts of ``repro/obs/metrics.py`` the
serving engine and the trainer use)."""
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


# dense bf16 tensor-core peak of one NVIDIA H100 SXM (NVIDIA's data sheet, at
# its 700 W power limit); the JAX package's roofline peak is a TPU's
PEAK_FLOPS_H100_BF16 = 989e12


def mfu_estimate(cfg, *, global_batch: int, seq_len: int, step_time_s: float) -> float:
    """Model-flops utilization of one optimizer step on one card: 6ND
    training flops (fwd 2ND + bwd 4ND; recomputation not counted) over
    ``step_time * peak``."""
    if step_time_s <= 0:
        return 0.0
    flops = 6.0 * cfg.param_count() * global_batch * seq_len
    return flops / (step_time_s * PEAK_FLOPS_H100_BF16)
