"""K7, paged-attention decode: the CUDA kernel's wrapper and its plain
version.

Kernel source: ``csrc/paged_attention.cu``.  Replaces the TPU kernel
``repro/kernels/paged_attention.py:_paged_decode_kernel``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention_ref as plain  # noqa: F401

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)
launches = 0   # kernel launches; chip_smoke.py resets and reads it


def paged_attention_cuda(q, k_pool, v_pool, block_tables, context_lens, *,
                         window: int = 0, softcap: float = 0.0):
    """q: [R, Hq, D]; pools: [N, Hkv, bs, D]; block_tables: int32 [R, maxb];
    context_lens: int32 [R], all on the card -> [R, Hq, D] in q's dtype."""
    global launches
    R, Hq, D = q.shape
    N, Hkv, bs, _ = k_pool.shape
    tensors = (q, k_pool, v_pool, block_tables, context_lens)
    if not (q.is_cuda and all(t.device == q.device for t in tensors)):
        raise ValueError("paged_attention_cuda: all inputs must share a CUDA device")
    if q.dtype not in DTYPES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype \
            or block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise ValueError("paged_attention_cuda: q/pools must share fp32 or bf16, "
                         "tables and lengths must be int32")
    if v_pool.shape != k_pool.shape or k_pool.shape[3] != D or D not in HEAD_DIMS \
            or Hq % Hkv or block_tables.dim() != 2 or block_tables.shape[0] != R \
            or context_lens.shape != (R,):
        raise ValueError(f"paged_attention_cuda: unsupported shapes q {tuple(q.shape)} "
                         f"pool {tuple(k_pool.shape)} tables {tuple(block_tables.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention_cuda: inputs must be contiguous")
    out = torch.empty_like(q)
    status = _build.library().rt_paged_attention_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
        context_lens.data_ptr(), out.data_ptr(), R, Hq, Hkv, D, N, bs,
        block_tables.shape[1], int(window), float(softcap), DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "rt_paged_attention_decode")
    launches += 1
    return out
