"""K1, RMSNorm forward: the CUDA kernel's wrapper and its plain version.

Kernel source: ``csrc/rmsnorm.cu``.  Replaces the TPU kernel
``repro/kernels/rmsnorm.py:_rmsnorm_kernel``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm_ref as plain  # noqa: F401

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
launches = 0   # kernel launches; chip_smoke.py resets and reads it


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
                 plus_one: bool = False) -> torch.Tensor:
    """x: [..., D] contiguous fp32/bf16 on the card; scale: fp32 [D]."""
    global launches
    D = x.shape[-1]
    if not (x.is_cuda and scale.device == x.device):
        raise ValueError("rmsnorm_cuda: x and scale must be on the same CUDA device")
    if x.dtype not in DTYPES or scale.dtype != torch.float32 or scale.shape != (D,):
        raise ValueError(f"rmsnorm_cuda: unsupported x {x.dtype} / scale "
                         f"{scale.dtype}{tuple(scale.shape)}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm_cuda: x and scale must be contiguous")
    if x.numel() == 0 or x.data_ptr() % 16 or scale.data_ptr() % 16 \
            or (D * x.element_size()) % 16:
        raise ValueError("rmsnorm_cuda: rows must be non-empty 16-byte aligned vectors")
    out = torch.empty_like(x)
    status = _build.library().rt_rmsnorm_fwd(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), x.numel() // D, D,
        float(eps), int(plus_one), DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "rt_rmsnorm_fwd")
    launches += 1
    return out
