"""Dense feed-forward blocks: SwiGLU / GeGLU / plain (counterpart of
``repro/models/mlp.py``)."""
from __future__ import annotations

import torch

from repro_torch.models.common import ModelConfig, activation, dense_init


def init_mlp(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.torch_dtype
    p = {"w_up": dense_init(generator, (d, f), dt, device),
         "w_down": dense_init(generator, (f, d), dt, device)}
    if cfg.glu:
        p["w_gate"] = dense_init(generator, (d, f), dt, device)
    return p


def apply_mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    act = activation(cfg.hidden_act)
    up = x @ p["w_up"].to(x.dtype)
    h = act(x @ p["w_gate"].to(x.dtype)) * up if cfg.glu else act(up)
    return h @ p["w_down"].to(x.dtype)
