"""K7's share of its roofline in the decode steps of the traced replay
(not the window; see ``attn_roofline.serve``): q read and the
output written for every slot, and the live K/V of every slot read once
(``counts.paged_decode_bytes``; the flops bound it nowhere), over the
kernel's device time."""
from bench.harness import counts

UNIT = "%"

KERNELS = ("paged_decode_kernel",)


def read(run):
    if run.kind != "serve" or run.trace is None or not run.paged_calls:
        return None
    t, n = run.trace.device_s(lambda name: any(k in name for k in KERNELS))
    bound = 0.0
    for rows, hq, hkv, hd, ctx in run.paged_calls:
        live = int(ctx.clamp(min=0).sum())
        bound += counts.bound_s(4.0 * live * hq * hd,
                                counts.paged_decode_bytes(rows, hq, hkv, hd, live))
    return 100.0 * bound / t if n else None
