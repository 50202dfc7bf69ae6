"""K7, paged-attention decode: the CUDA kernel's wrapper and its plain
version.

Kernel source: ``csrc/paged_attention.cu``.  Replaces the TPU kernel
``repro/kernels/paged_attention.py:_paged_decode_kernel``.  The kernel cuts
each request's key range into splits of ``KEYS_PER_SPLIT`` keys, one block
each, and merges the splits' partial softmax states inside the same launch
(``ref.paged_attention_split_ref`` is the same computation in plain PyTorch).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention_ref as plain  # noqa: F401

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)
KEYS_PER_SPLIT = 64   # must equal KPS in csrc/paged_attention.cu
launches = 0   # kernel launches; chip_smoke.py resets and reads it
# per device: the splits' fp32 partials, and the int32 merge counters (zero;
# every launch leaves them zero again, so no call clears them).  Each is made
# once and grown when needed; launches on one stream run in order, so they
# can share both.
_scratch: dict[tuple[torch.device, torch.dtype], torch.Tensor] = {}


def _buffer(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    buf = _scratch.get((device, dtype))
    if buf is None or buf.numel() < n:
        buf = _scratch[device, dtype] = torch.zeros(max(n, 256), dtype=dtype, device=device)
    return buf


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
    maxb = block_tables.shape[1]
    n_splits = -(-maxb * bs // KEYS_PER_SPLIT)
    out = torch.empty_like(q)
    part = _buffer(R * Hq * n_splits * (D + 2), torch.float32, q.device)
    counters = _buffer(R * Hq, torch.int32, q.device)   # >= one per (request, head group)
    status = _build.library().rt_paged_attention_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
        context_lens.data_ptr(), out.data_ptr(), part.data_ptr(), counters.data_ptr(),
        R, Hq, Hkv, D, N, bs, maxb, int(window), float(softcap),
        DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "rt_paged_attention_decode")
    launches += 1
    return out
