"""K3, flash-attention forward: the CUDA kernel's wrapper and its plain
version.

Kernel source: ``csrc/flash_attention.cu``.  Replaces the TPU kernel
``repro/kernels/flash_attention.py:_attn_fwd_kernel``.  The kernel streams
K/V and masks the ragged edges itself, so it takes any S (no padding, and no
plain fallback for long sequences).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_fwd_ref as plain  # noqa: F401

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)
launches = 0   # kernel launches; chip_smoke.py resets and reads it


def _strides(t: torch.Tensor):
    if t.stride(-1) != 1 or any(s * t.element_size() % 16 for s in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError("flash_attention_fwd_cuda: the head dim must be dense and "
                         "every other stride and the base 16-byte aligned")
    return (ctypes.c_longlong * 3)(*t.stride()[:3])


def flash_attention_fwd_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                             softcap: float = 0.0, kv_len: int = 0):
    """q: [B, S, Hq, D]; k, v: [B, S, Hkv, D] on the card -> (out [B, S, Hq, D]
    in q's dtype, lse [B, Hq, S] fp32)."""
    global launches
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_fwd_cuda: q, k, v must share a CUDA device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_fwd_cuda: unsupported dtypes "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (B, S, Hkv, D) or v.shape != k.shape or D not in HEAD_DIMS \
            or Hq % Hkv:
        raise ValueError(f"flash_attention_fwd_cuda: unsupported shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    kv_len = kv_len or S
    if not 0 < kv_len <= S:
        raise ValueError(f"flash_attention_fwd_cuda: kv_len {kv_len} outside (0, {S}]")
    qs, ks, vs = _strides(q), _strides(k), _strides(v)
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    status = _build.library().rt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, S, Hq, Hkv, D, qs, ks, vs, kv_len, int(causal), int(window),
        float(softcap), DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "rt_flash_attention_fwd")
    launches += 1
    return out, lse
