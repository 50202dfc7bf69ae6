"""K3, K4 and K5, flash attention forward and backward: the CUDA kernels'
wrappers and their plain versions.

Kernel sources: ``csrc/flash_attention.cu`` (K3, forward) and
``csrc/flash_attention_bwd.cu`` (K4, dq; K5, dk/dv).  They replace the TPU
kernels ``repro/kernels/flash_attention.py:_attn_fwd_kernel``,
``:_attn_bwd_dq_kernel`` and ``:_attn_bwd_dkv_kernel``.  The kernels stream
K/V (or Q) tiles and mask the ragged edges themselves, so they take any S (no
padding, and no plain fallback for long sequences).  In bf16 (training and
serving prefill) K3, K4 and K5 run on the tensor cores (wgmma) at every head
dim; at head dim 256 K4's and K5's two warpgroups split the head dim.  fp32
runs on the fp32 CUDA cores.  Head dim 112 (Zamba2-7B's shared attention)
runs head-dim-128 tiles in instances compiled for 112 (zero columns in the
tiles, no padded copy).  bf16 K5 may split a KV head's query heads over several
blocks (``dkv_split``: MQA with few key tiles, as gemma-2b's or granite-20b's
training micro-batch); its wrapper then gives it an fp32 workspace.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_bwd_dkv_ref as plain_bwd_dkv  # noqa: F401
from repro_torch.kernels.ref import flash_attention_bwd_dq_ref as plain_bwd_dq  # noqa: F401
from repro_torch.kernels.ref import flash_attention_fwd_ref as plain  # noqa: F401

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 112, 128, 256)
launches = 0           # K3 launches; chip_smoke.py resets and reads it
bwd_dq_launches = 0    # K4 launches
bwd_dkv_launches = 0   # K5 launches


def _strides(t: torch.Tensor, name: str):
    if t.stride(-1) != 1 or any(s * t.element_size() % 16 for s in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(f"{name}: the head dim must be dense and every other "
                         "stride and the base 16-byte aligned")
    return (ctypes.c_longlong * 3)(*t.stride()[:3])


def _check(name, q, k, v, *like_q, kv_len: int):
    """Device, dtype and shape checks shared by the three wrappers; returns
    (B, S, Hq, Hkv, D, kv_len)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    if not (q.is_cuda and all(t.device == q.device for t in (k, v, *like_q))):
        raise ValueError(f"{name}: q, k, v (and out, dO) must share a CUDA device")
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in (k, v, *like_q)):
        raise ValueError(f"{name}: unsupported dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (B, S, Hkv, D) or v.shape != k.shape or D not in HEAD_DIMS \
            or Hq % Hkv or any(t.shape != q.shape for t in like_q):
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    kv_len = kv_len or S
    if not 0 < kv_len <= S:
        raise ValueError(f"{name}: kv_len {kv_len} outside (0, {S}]")
    return B, S, Hq, Hkv, D, kv_len


def _rows(t: torch.Tensor, shape, name: str) -> None:
    """lse / delta: a dense fp32 [B, Hq, S] on the card."""
    if t.shape != shape or t.dtype != torch.float32 or not t.is_contiguous() \
            or not t.is_cuda:
        raise ValueError(f"{name}: lse and delta must be dense fp32 {list(shape)} "
                         f"CUDA tensors")


def flash_attention_fwd_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                             softcap: float = 0.0, kv_len: int = 0):
    """q: [B, S, Hq, D]; k, v: [B, S, Hkv, D] on the card -> (out [B, S, Hq, D]
    in q's dtype, lse [B, Hq, S] fp32)."""
    global launches
    name = "flash_attention_fwd_cuda"
    B, S, Hq, Hkv, D, kv_len = _check(name, q, k, v, kv_len=kv_len)
    qs, ks, vs = (_strides(t, name) for t in (q, k, v))
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


def flash_attention_bwd_dq_cuda(q, k, v, out, lse, do, *, causal: bool = True,
                                window: int = 0, softcap: float = 0.0, kv_len: int = 0):
    """K4.  The forward's inputs, out and lse, and dO [B, S, Hq, D] on the card
    -> (dq like q, delta = rowsum(dO * O) fp32 [B, Hq, S], which K5 reads)."""
    global bwd_dq_launches
    name = "flash_attention_bwd_dq_cuda"
    B, S, Hq, Hkv, D, kv_len = _check(name, q, k, v, out, do, kv_len=kv_len)
    _rows(lse, (B, Hq, S), name)
    strides = [_strides(t, name) for t in (q, k, v, out, do)]
    dq = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    status = _build.library().rt_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), delta.data_ptr(), B, S, Hq, Hkv, D, *strides,
        kv_len, int(causal), int(window), float(softcap), DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "rt_flash_attention_bwd_dq")
    bwd_dq_launches += 1
    return dq, delta


def dkv_split(B: int, S: int, Hq: int, Hkv: int, D: int, dtype: int,
              device: int | None = None) -> int:
    """K5's split of each KV head's query heads over blocks, as its C entry
    chooses it from the shape and the card's SM count (1 in fp32, at head
    dim 112, and below head dim 256 wherever the key tiles give every SM a
    block; ``device`` defaults to the current card); above 1 the kernel sums
    fp32 partials from a workspace in a fixed order."""
    return _dkv_split(B, S, Hq, Hkv, D, dtype,
                      torch.cuda.current_device() if device is None else device)


@functools.cache
def _dkv_split(B: int, S: int, Hq: int, Hkv: int, D: int, dtype: int, device: int) -> int:
    with torch.cuda.device(device):
        split = _build.library().rt_flash_attention_bwd_dkv_split(B, S, Hq, Hkv, D, dtype)
    if split < 1:
        _build.check(split, "rt_flash_attention_bwd_dkv_split")
    return split


def flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, *, causal: bool = True,
                                 window: int = 0, softcap: float = 0.0, kv_len: int = 0):
    """K5.  The forward's inputs, dO, lse and K4's delta on the card -> (dk
    like k, dv like v), each KV head summed over its query heads."""
    global bwd_dkv_launches
    name = "flash_attention_bwd_dkv_cuda"
    B, S, Hq, Hkv, D, kv_len = _check(name, q, k, v, do, kv_len=kv_len)
    _rows(lse, (B, Hq, S), name)
    _rows(delta, (B, Hq, S), name)
    strides = [_strides(t, name) for t in (q, k, v, do)]
    dk = torch.empty((B, S, Hkv, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, S, Hkv, D), dtype=v.dtype, device=q.device)
    split = dkv_split(B, S, Hq, Hkv, D, DTYPES[q.dtype], q.device.index)
    ws = (torch.empty((split, 2, B, S, Hkv, D), dtype=torch.float32, device=q.device)
          if split > 1 else None)
    status = _build.library().rt_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), None if ws is None else ws.data_ptr(),
        split, B, S, Hq, Hkv, D, *strides,
        kv_len, int(causal), int(window), float(softcap), DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "rt_flash_attention_bwd_dkv")
    bwd_dkv_launches += 1
    return dk, dv
