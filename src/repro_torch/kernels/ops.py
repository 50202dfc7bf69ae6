"""Device dispatch for the kernels the model code calls.

A tensor on the CPU goes to the kernel's plain version (the CPU tests); a
tensor on the card goes to the hand-written kernel, which launches or
raises.  There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import rmsnorm as _rn


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device {t.device}")


def rmsnorm(x, scale, *, eps: float = 1e-6, plus_one: bool = False):
    """x: [..., D]; scale: fp32 [D].  ``plus_one`` is the ``rmsnorm_p1``
    (gemma ``1 + scale``) variant."""
    if _on_cuda(x, "rmsnorm"):
        return _rn.rmsnorm_cuda(x, scale, eps=eps, plus_one=plus_one)
    return _rn.plain(x, scale, eps=eps, plus_one=plus_one)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, kv_len: int = 0):
    """q: [B, S, Hq, D]; k, v: [B, S, Hkv, D] -> out [B, S, Hq, D] (the
    forward; the lse is dropped until the training slice needs it)."""
    fn = _fa.flash_attention_fwd_cuda if _on_cuda(q, "flash_attention") else _fa.plain
    out, _ = fn(q, k, v, causal=causal, window=window, softcap=softcap, kv_len=kv_len)
    return out


def paged_attention(q, k_pool, v_pool, block_tables, context_lens, *,
                    window: int = 0, softcap: float = 0.0):
    """Single-token decode attention over a paged KV cache.  q: [R, Hq, D];
    pools: [N, Hkv, bs, D]; block_tables: [R, max_blocks]; context_lens: [R].
    Rows with ``context_lens == 0`` return zeros (idle serving slots)."""
    fn = _pa.paged_attention_cuda if _on_cuda(q, "paged_attention") else _pa.plain
    return fn(q, k_pool, v_pool, block_tables, context_lens, window=window,
              softcap=softcap)
