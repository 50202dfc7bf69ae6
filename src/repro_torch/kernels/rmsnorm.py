"""K1 and K2, RMSNorm forward and backward: the CUDA kernels' wrappers and
their plain versions.

Kernel sources: ``csrc/rmsnorm.cu`` (K1) and ``csrc/rmsnorm_bwd.cu`` (K2).
They replace the TPU kernels ``repro/kernels/rmsnorm.py:_rmsnorm_kernel``
and ``:_rmsnorm_bwd_kernel``.  Both read the scale in fp32; the
differentiable op in ``ops.py`` hands them a bf16 scale widened to fp32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm_bwd_ref as plain_bwd  # noqa: F401
from repro_torch.kernels.ref import rmsnorm_ref as plain  # noqa: F401

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BWD_BLOCKS = 264   # K2's row runs: two per SM of the H100
BWD_MAX_D = 8192   # K2 keeps a thread's share of a row in registers
launches = 0       # K1 launches; chip_smoke.py resets and reads it
bwd_launches = 0   # K2 launches


def _check(name, x, scale, *others):
    D = x.shape[-1]
    if not (x.is_cuda and all(t.device == x.device for t in (scale, *others))):
        raise ValueError(f"{name}: x, scale (and g) must be on the same CUDA device")
    if x.dtype not in DTYPES or scale.dtype != torch.float32 or scale.shape != (D,) \
            or any(t.dtype != x.dtype or t.shape != x.shape for t in others):
        raise ValueError(f"{name}: unsupported x {x.dtype} / scale "
                         f"{scale.dtype}{tuple(scale.shape)}")
    if not all(t.is_contiguous() for t in (x, scale, *others)):
        raise ValueError(f"{name}: x, scale (and g) must be contiguous")
    if x.numel() == 0 or any(t.data_ptr() % 16 for t in (x, scale, *others)) \
            or (D * x.element_size()) % 16:
        raise ValueError(f"{name}: rows must be non-empty 16-byte aligned vectors")


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
                 plus_one: bool = False) -> torch.Tensor:
    """x: [..., D] contiguous fp32/bf16 on the card; scale: fp32 [D]."""
    global launches
    _check("rmsnorm_cuda", x, scale)
    D = x.shape[-1]
    out = torch.empty_like(x)
    status = _build.library().rt_rmsnorm_fwd(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), x.numel() // D, D,
        float(eps), int(plus_one), DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "rt_rmsnorm_fwd")
    launches += 1
    return out


def rmsnorm_bwd_cuda(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, *,
                     eps: float = 1e-6, plus_one: bool = False):
    """K2.  x, g: [..., D] contiguous fp32/bf16 on the card; scale: fp32 [D]
    -> (dx like x, dscale fp32 [D]).  The per-run dscale partials are summed
    here, outside the kernel, as the TPU kernel's caller sums its blocks'."""
    global bwd_launches
    _check("rmsnorm_bwd_cuda", x, scale, g)
    D = x.shape[-1]
    if D > BWD_MAX_D:
        raise ValueError(f"rmsnorm_bwd_cuda: rows of {D} > {BWD_MAX_D} elements")
    rows = x.numel() // D
    per_block = -(-rows // min(rows, BWD_BLOCKS))
    blocks = -(-rows // per_block)
    dx = torch.empty_like(x)
    ds_part = torch.empty((blocks, D), dtype=torch.float32, device=x.device)
    status = _build.library().rt_rmsnorm_bwd(
        x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(), ds_part.data_ptr(),
        rows, D, float(eps), int(plus_one), blocks, DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "rt_rmsnorm_bwd")
    bwd_launches += 1
    return dx, ds_part.sum(0)
