"""Grouped-query attention: training/prefill, and decode against a dense
cache (counterpart of ``repro/models/attention.py``).

Tensor parallelism (Megatron's, over the model group of an ``AxisCtx``):
query heads are sharded; KV heads are sharded when ``num_kv_heads % tp ==
0``, and otherwise ``wk``/``wv`` are replicated and each rank projects every
KV head and keeps the one its query heads use, so their per-rank gradients
are partial and are summed over the model group when they are reduced
(``transformer.model_partial_leaves``).  The output projection is
row-parallel, followed by the block's one all-reduce.

The window is a Python int per layer, so the JAX package's ``lax.cond``
specialisation on the traced window has no counterpart.  Past
``CHUNKED_THRESHOLD`` the JAX package always takes its query-chunked plain
path (the Pallas BlockSpec stages whole-S K/V); on the card the CUDA kernel
streams K/V at every S and stays, while on the CPU the port takes the same
query-chunked path (``_attend_chunked``) instead of the kernel's plain
version, whose S x S logits a 32k prefill could not hold.

``attention_decode`` is the dense-cache decode of the JAX package (plain
tensor code there too): the new token's K/V written into a ``[B, Hkv_l,
max_seq, hd]`` cache (in place), or into a sliding-window layer's ring of W
slots, then one fp32 softmax over the cache.  Over a seq group
(``AxisCtx.seq``) each rank holds one contiguous shard of the sequence: the
rank owning the position writes the token, and the softmax's max, sum and
weighted sum are reduced over the group.
"""
from __future__ import annotations

import torch

from repro_torch.core.dist import LOCAL, AxisCtx
from repro_torch.kernels import ops as kops
from repro_torch.models.common import (ModelConfig, apply_rope, copy_to_model, dense_init,
                                       reduce_from_model, softcap)

NEG_INF = -2.0e38
CHUNKED_THRESHOLD = 8192


def init_attention(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    d, hd, dt = cfg.d_model, cfg.head_dim, cfg.torch_dtype
    return {
        "wq": dense_init(generator, (d, cfg.num_heads * hd), dt, device),
        "wk": dense_init(generator, (d, cfg.num_kv_heads * hd), dt, device),
        "wv": dense_init(generator, (d, cfg.num_kv_heads * hd), dt, device),
        "wo": dense_init(generator, (cfg.num_heads * hd, d), dt, device),
    }


def local_counts(cfg: ModelConfig, tp: int) -> tuple[int, int, bool]:
    """(local q heads, local kv heads, kv replicated) at tensor-parallel
    width ``tp``."""
    if tp == 1:
        return cfg.num_heads, cfg.num_kv_heads, False
    if cfg.num_heads % tp:
        raise ValueError(f"{cfg.name}: tp={tp} does not divide {cfg.num_heads} q heads")
    if cfg.num_kv_heads % tp == 0:
        return cfg.num_heads // tp, cfg.num_kv_heads // tp, False
    if tp % cfg.num_kv_heads:
        raise ValueError(f"{cfg.name}: tp={tp} and {cfg.num_kv_heads} kv heads: "
                         f"neither divides the other")
    return cfg.num_heads // tp, 1, True


def replicated_kv_head(cfg: ModelConfig, axis: AxisCtx) -> int:
    """With the KV heads replicated over the model group, the one KV head
    this rank's query heads use (the head its cache holds)."""
    hq_l = cfg.num_heads // axis.tp
    return (axis.model_index * hq_l) // (cfg.num_heads // cfg.num_kv_heads)


def project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, axis: AxisCtx = LOCAL):
    """x: [B, S, D] -> q [B, S, Hq_l, hd], k/v [B, S, Hkv_l, hd] (this
    rank's heads)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    hq_l, _, kv_rep = local_counts(cfg, axis.tp)
    q = (x @ p["wq"].to(x.dtype)).view(B, S, hq_l, hd)
    k = (x @ p["wk"].to(x.dtype)).view(B, S, -1, hd)
    v = (x @ p["wv"].to(x.dtype)).view(B, S, -1, hd)
    if kv_rep:
        # every KV head projected; keep the one this rank's q heads map to
        kv_idx = replicated_kv_head(cfg, axis)
        k, v = k[:, :, kv_idx:kv_idx + 1], v[:, :, kv_idx:kv_idx + 1]
    return q, k, v


def _attend_dense(q, k, v, qpos, kpos, window: int, cap: float):
    """Materialised logits: q [B, Sq, H, hd] against k/v [B, Sk, H, hd]
    (K/V heads already repeated), causal on the positions [B, Sq] and
    [B, Sk], windowed when ``window`` > 0; softmax in fp32."""
    hd = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * hd ** -0.5
    logits = softcap(logits, cap)
    qi, kj = qpos[:, None, :, None], kpos[:, None, None, :]
    mask = qi >= kj
    if window > 0:
        mask = mask & (qi - kj < window)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _attend_chunked(q, k, v, positions, window: int, cap: float, *, block_q: int = 512):
    """Query-chunked attention (the JAX package's long-sequence path):
    logits of ``block_q`` queries at a time against every key, O(block_q * S)
    memory instead of O(S^2).  Exact."""
    rep = q.shape[2] // k.shape[2]
    ke = k.repeat_interleave(rep, dim=2)
    ve = v.repeat_interleave(rep, dim=2)
    return torch.cat([_attend_dense(q[:, i:i + block_q], ke, ve,
                                    positions[:, i:i + block_q], positions, window, cap)
                      for i in range(0, q.shape[1], block_q)], dim=1)


def attention_train(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                    positions: torch.Tensor, window: int,
                    return_kv: bool = False, axis: AxisCtx = LOCAL):
    """x: [B, S, D] -> [B, S, D], causal.  ``window``: 0 = global, >0 =
    sliding window.  ``return_kv`` also returns the rope'd K/V as
    [B, Hkv, S, hd] views for prefill cache building."""
    B, S, _ = x.shape
    x = copy_to_model(x, axis)
    q, k, v = project_qkv(cfg, p, x, axis)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if S > CHUNKED_THRESHOLD and not q.is_cuda:
        y = _attend_chunked(q, k, v, positions, int(window), cfg.attn_logit_softcap)
    else:
        y = kops.flash_attention(q, k, v, causal=True, window=int(window),
                                 softcap=cfg.attn_logit_softcap)
    out = reduce_from_model(y.reshape(B, S, -1) @ p["wo"].to(x.dtype), axis)
    if return_kv:
        return out, k.transpose(1, 2), v.transpose(1, 2)
    return out


def attention_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, *, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, window: int, axis: AxisCtx = LOCAL,
                     ring: bool = False):
    """x: [B, 1, D]; caches [B, Hkv_l, S_cache, hd]; ``pos`` the new token's
    position.  Writes the token's K/V into the caches (in place: at ``pos``,
    or at ``pos % W`` of a ring of W slots, which then holds position ``pos -
    ((pos - i) mod W)`` in slot i) and returns (y [B, 1, D], k_cache,
    v_cache).  With ``axis.seq`` a (non-ring) cache is this rank's shard,
    positions ``[seq_index * S_cache, (seq_index + 1) * S_cache)``."""
    B = x.shape[0]
    hd = cfg.head_dim
    x = copy_to_model(x, axis)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = project_qkv(cfg, p, x, axis)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)
    S_c = k_cache.shape[2]
    sharded = axis.seq is not None and not ring      # rings are never seq-sharded
    start = axis.seq_index * S_c if sharded else 0
    slot = pos % S_c if ring else pos - start
    if not sharded or 0 <= slot < S_c:                # only the owning shard writes
        k_cache[:, :, slot] = k_new[:, 0].to(k_cache.dtype)
        v_cache[:, :, slot] = v_new[:, 0].to(v_cache.dtype)
    rep = q.shape[2] // k_cache.shape[1]
    kk = k_cache.repeat_interleave(rep, dim=1) if rep > 1 else k_cache   # [B, Hq_l, S, hd]
    vv = v_cache.repeat_interleave(rep, dim=1) if rep > 1 else v_cache
    logits = torch.einsum("bqhd,bhkd->bhk", q, kk).float() * hd ** -0.5   # q length 1
    logits = softcap(logits, cfg.attn_logit_softcap)
    i = torch.arange(S_c, device=x.device)
    kpos = pos - (pos - i) % S_c if ring else start + i
    valid = (kpos >= 0) & (kpos <= pos)
    if window > 0:
        valid = valid & (pos - kpos < window)
    logits = torch.where(valid[None, None, :], logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(-1)
    if sharded:
        # a shard with no live key has m = NEG_INF; the group's max is a
        # live logit, so its exp below is exp(NEG_INF - m) = 0
        axis.all_reduce(m, "seq", op="max")
    e = torch.exp(logits - m[..., None])
    denom = e.sum(-1)
    num = torch.einsum("bhk,bhkd->bhd", e, vv.float()).contiguous()
    if sharded:
        axis.all_reduce(denom, "seq")
        axis.all_reduce(num, "seq")
    y = (num / denom[..., None]).to(x.dtype).reshape(B, 1, -1)
    out = reduce_from_model(y @ p["wo"].to(y.dtype), axis)
    return out, k_cache, v_cache
