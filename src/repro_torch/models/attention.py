"""Grouped-query attention, training/prefill form (counterpart of
``repro/models/attention.py``).

The window is a Python int per layer, so the JAX package's ``lax.cond``
specialisation on the traced window has no counterpart.  Nor does its plain
path for ``S > CHUNKED_THRESHOLD``: that exists because the Pallas BlockSpec
stages whole-S K/V, while the CUDA kernel streams K/V at every S.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.common import ModelConfig, apply_rope, dense_init


def init_attention(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    d, hd, dt = cfg.d_model, cfg.head_dim, cfg.torch_dtype
    return {
        "wq": dense_init(generator, (d, cfg.num_heads * hd), dt, device),
        "wk": dense_init(generator, (d, cfg.num_kv_heads * hd), dt, device),
        "wv": dense_init(generator, (d, cfg.num_kv_heads * hd), dt, device),
        "wo": dense_init(generator, (cfg.num_heads * hd, d), dt, device),
    }


def project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x: [B, S, D] -> q [B, S, Hq, hd], k/v [B, S, Hkv, hd]."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"].to(x.dtype)).view(B, S, cfg.num_heads, hd)
    k = (x @ p["wk"].to(x.dtype)).view(B, S, cfg.num_kv_heads, hd)
    v = (x @ p["wv"].to(x.dtype)).view(B, S, cfg.num_kv_heads, hd)
    return q, k, v


def attention_train(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                    positions: torch.Tensor, window: int,
                    return_kv: bool = False):
    """x: [B, S, D] -> [B, S, D], causal.  ``window``: 0 = global, >0 =
    sliding window.  ``return_kv`` also returns the rope'd K/V as
    [B, Hkv, S, hd] views for prefill cache building."""
    B, S, _ = x.shape
    q, k, v = project_qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    y = kops.flash_attention(q, k, v, causal=True, window=int(window),
                             softcap=cfg.attn_logit_softcap)
    out = y.reshape(B, S, -1) @ p["wo"].to(x.dtype)
    if return_kv:
        return out, k.transpose(1, 2), v.transpose(1, 2)
    return out
