"""Grouped-query attention, training/prefill form (counterpart of
``repro/models/attention.py``).

Tensor parallelism (Megatron's, over the model group of an ``AxisCtx``):
query heads are sharded; KV heads are sharded when ``num_kv_heads % tp ==
0``, and otherwise ``wk``/``wv`` are replicated and each rank projects every
KV head and keeps the one its query heads use, so their per-rank gradients
are partial and are summed over the model group when they are reduced
(``transformer.model_partial_leaves``).  The output projection is
row-parallel, followed by the block's one all-reduce.

The window is a Python int per layer, so the JAX package's ``lax.cond``
specialisation on the traced window has no counterpart.  Nor does its plain
path for ``S > CHUNKED_THRESHOLD``: that exists because the Pallas BlockSpec
stages whole-S K/V, while the CUDA kernel streams K/V at every S.
"""
from __future__ import annotations

import torch

from repro_torch.core.dist import LOCAL, AxisCtx
from repro_torch.kernels import ops as kops
from repro_torch.models.common import (ModelConfig, apply_rope, copy_to_model, dense_init,
                                       reduce_from_model)


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
        kv_idx = (axis.model_index * hq_l) // (cfg.num_heads // cfg.num_kv_heads)
        k, v = k[:, :, kv_idx:kv_idx + 1], v[:, :, kv_idx:kv_idx + 1]
    return q, k, v


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
    y = kops.flash_attention(q, k, v, causal=True, window=int(window),
                             softcap=cfg.attn_logit_softcap)
    out = reduce_from_model(y.reshape(B, S, -1) @ p["wo"].to(x.dtype), axis)
    if return_kv:
        return out, k.transpose(1, 2), v.transpose(1, 2)
    return out
