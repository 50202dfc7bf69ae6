"""The attention kernels' share of their roofline in a training step: the
sum of each call's bound (``counts.attention_fwd`` / ``attention_bwd`` at
the shapes the port's attention entry was called with, a backward for
each call made under autograd) over the device time of the kernels named
below."""
from bench.harness import counts

UNIT = "%"

KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel", "dkv_sum_kernel")


def bound_s(calls) -> float:
    total = 0.0
    for b, sq, sk, hq, hkv, hd, bwd in calls:
        total += counts.bound_s(*counts.attention_fwd(b, sq, sk, hq, hkv, hd))
        if bwd:
            total += counts.bound_s(*counts.attention_bwd(b, sq, sk, hq, hkv, hd))
    return total


def read(run):
    if run.kind != "train" or run.trace is None or not run.attn_calls:
        return None
    t, n = run.trace.device_s(lambda name: any(k in name for k in KERNELS))
    return 100.0 * bound_s(run.attn_calls) / t if n else None
