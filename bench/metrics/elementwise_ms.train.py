"""Device milliseconds a training step spends in operations that are
neither a GEMM nor one of the port's kernels K1-K7: the plain-torch model
ops, casts, gradient adds and copies."""
UNIT = "ms"

GEMM = ("gemm", "xmma", "cutlass", "nvjet", "gemv")
PORT_KERNELS = ("rmsnorm_kernel", "rmsnorm_bwd_kernel", "flash_fwd_kernel",
                "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel", "dkv_sum_kernel",
                "adamw_kernel", "paged_decode_kernel")


def _other(name: str) -> bool:
    n = name.lower()
    return not any(k in n for k in GEMM) and not any(k in n for k in PORT_KERNELS)


def read(run):
    if run.kind != "train" or run.trace is None or not run.traced_steps:
        return None
    s, n = run.trace.device_s(_other)
    return 1e3 * s / run.traced_steps if n else None
