"""Dense feed-forward blocks: SwiGLU / GeGLU / plain (counterpart of
``repro/models/mlp.py``).  Tensor parallel over the model group: column-
parallel up/gate projections (the hidden dim sharded), a row-parallel down
projection and one all-reduce."""
from __future__ import annotations

import torch

from repro_torch.core.dist import LOCAL, AxisCtx
from repro_torch.models.common import (ModelConfig, activation, copy_to_model, dense_init,
                                       reduce_from_model)


def init_mlp(cfg: ModelConfig, generator: torch.Generator, device, *,
             d_ff: int | None = None) -> dict:
    d, f, dt = cfg.d_model, d_ff or cfg.d_ff, cfg.torch_dtype
    p = {"w_up": dense_init(generator, (d, f), dt, device),
         "w_down": dense_init(generator, (f, d), dt, device)}
    if cfg.glu:
        p["w_gate"] = dense_init(generator, (d, f), dt, device)
    return p


def apply_mlp(cfg: ModelConfig, p: dict, x: torch.Tensor,
              axis: AxisCtx = LOCAL) -> torch.Tensor:
    x = copy_to_model(x, axis)
    act = activation(cfg.hidden_act)
    up = x @ p["w_up"].to(x.dtype)
    h = act(x @ p["w_gate"].to(x.dtype)) * up if cfg.glu else act(up)
    return reduce_from_model(h @ p["w_down"].to(x.dtype), axis)
