"""Config helpers shared by the architecture files.

Every architecture module defines:
  CONFIG  — the full-scale configuration
  SMOKE   — a reduced variant of the same family (<=2 layers, d_model<=512)
            for CPU tests
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.common import ModelConfig


def smoke_variant(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a config while preserving its family structure."""
    d_model = min(cfg.d_model, 256)
    heads = max(2, min(cfg.num_heads, 4)) if cfg.num_heads else 0
    kv = 0
    if cfg.num_kv_heads:
        ratio = max(cfg.num_heads // cfg.num_kv_heads, 1)
        kv = max(1, heads // ratio)
    changes = dict(
        num_layers=2,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=64 if cfg.head_dim >= 64 else cfg.head_dim,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        sliding_window=min(cfg.sliding_window, 8) if cfg.sliding_window else 0,
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        moe_dense_ff=min(cfg.moe_dense_ff, 256) if cfg.moe_dense_ff else 0,
        hybrid_attn_period=2 if cfg.hybrid_attn_period else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=min(cfg.ssm_head_dim, 32),
        vision_prefix_len=8 if cfg.vision_prefix_len else 0,
        dtype="float32",
    )
    changes.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **changes)
