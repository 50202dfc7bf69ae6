"""K3's share of its roofline in the prefills of the traced replay (not
the window: the window's requests due around its middle, served again
after the drain, traced once their slots have filled as in the window):
the bound of each call at the padded shape the engine gave the attention
entry, over the forward kernel's device time."""
from bench.harness import counts

UNIT = "%"

KERNELS = ("flash_fwd_kernel",)


def read(run):
    if run.kind != "serve" or run.trace is None or not run.attn_calls:
        return None
    t, n = run.trace.device_s(lambda name: any(k in name for k in KERNELS))
    bound = sum(counts.bound_s(*counts.attention_fwd(b, sq, sk, hq, hkv, hd))
                for b, sq, sk, hq, hkv, hd, _ in run.attn_calls)
    return 100.0 * bound / t if n else None
