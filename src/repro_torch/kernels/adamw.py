"""K6, the one-pass AdamW update of one storage leaf: the CUDA kernel's
wrapper and its plain version.

Kernel source: ``csrc/adamw.cu``.  Replaces the TPU kernel
``repro/kernels/adamw.py:_adamw_kernel``.  The kernel updates p, m and v in
place, so a step allocates no leaf-sized buffers (three fewer copies of each
leaf than an out-of-place update: 1.44 GB each for the stacked ``w_up`` of
an 8-layer Yi-6B).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import adamw_ref as plain  # noqa: F401

MOMENT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
launches = 0   # kernel launches; chip_smoke.py resets and reads it


def adamw_cuda(p, m, v, g, scalars, *, b1: float, b2: float, eps: float,
               wd: float) -> None:
    """p, g: fp32; m, v: fp32 or bf16 (one dtype); all the same shape,
    contiguous, on the card.  ``scalars``: fp32 [4] on the card = (lr,
    1 - b1^t, 1 - b2^t, grad scale), read by the kernel.  Updates p, m, v in
    place."""
    global launches
    tensors = (p, m, v, g, scalars)
    if not (p.is_cuda and all(t.device == p.device for t in tensors)):
        raise ValueError("adamw_cuda: p, m, v, g and scalars must share a CUDA device")
    if p.dtype != torch.float32 or g.dtype != torch.float32 \
            or m.dtype not in MOMENT_DTYPES or v.dtype != m.dtype \
            or scalars.dtype != torch.float32 or scalars.shape != (4,):
        raise ValueError(f"adamw_cuda: unsupported dtypes p {p.dtype} m {m.dtype} "
                         f"v {v.dtype} g {g.dtype} scalars {scalars.dtype}")
    if not (m.shape == v.shape == g.shape == p.shape) or p.numel() == 0:
        raise ValueError("adamw_cuda: p, m, v and g must share one non-empty shape")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("adamw_cuda: inputs must be contiguous and 16-byte aligned")
    status = _build.library().rt_adamw(
        p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(), scalars.data_ptr(),
        p.numel(), float(b1), 1.0 - b1, float(b2), 1.0 - b2, float(eps), float(wd),
        MOMENT_DTYPES[m.dtype], torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(status, "rt_adamw")
    launches += 1
