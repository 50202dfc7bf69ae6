"""Transformer parameters, inputs, the training forward and the loss
(counterpart of ``repro/models/transformer.py``; the serving steps in
``serving/steps.py`` run their own cached layer loop).

Parameters are a plain dict whose names follow the JAX tree, with the layer
stack as a list: ``layers.{i}.attn.wq`` and so on.  Matrices are stored in
``cfg.dtype`` (the JAX package casts its fp32 leaves to it at every use, so
the values are the same); norm scales stay fp32, and so does an MoE layer's
router (``moe.init_moe``: the JAX package keeps it fp32 and routes in fp32).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.core.dist import LOCAL, AxisCtx
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (ModelConfig, apply_norm, dense_init,
                                       embed_tokens, init_norm, lm_head_loss)


def init_layer(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    p = {
        "ln1": init_norm(cfg, cfg.d_model, device),
        "attn": attn_mod.init_attention(cfg, generator, device),
        "ln2": init_norm(cfg, cfg.d_model, device),
    }
    if cfg.is_moe:
        p["moe"] = moe_mod.init_moe(cfg, generator, device)
    else:
        p["mlp"] = mlp_mod.init_mlp(cfg, generator, device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Random weights for an attention stack (dense or MoE), drawn from
    ``generator`` (which must live on ``device``)."""
    if cfg.block_kind != "attn":
        raise NotImplementedError(f"{cfg.name}: the port has attention stacks "
                                  f"only so far")
    dt = cfg.torch_dtype
    params = {
        "embed": dense_init(generator, (cfg.vocab_size, cfg.d_model), dt, device,
                            scale=0.02),
        "layers": [init_layer(cfg, generator, device) for _ in range(cfg.num_layers)],
        "final_norm": init_norm(cfg, cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(generator, (cfg.vocab_size, cfg.d_model), dt,
                                    device, scale=0.02)
    return params


# ---------------------------------------------------------------------------
# Partition specs: the model-sharded dim of every leaf (the data/ZeRO
# partition is orthogonal).  Attention stacks, dense and MoE.
# ---------------------------------------------------------------------------
def _norm_specs(cfg: ModelConfig) -> dict:
    if cfg.norm == "layernorm":
        return {"scale": (None,), "bias": (None,)}
    return {"scale": (None,)}


def _strip_model(specs: dict) -> dict:
    """Drop the model axis (a mesh without tensor parallelism)."""
    return tree.tree_map(lambda sp: tuple(None if a == "model" else a for a in sp), specs)


def _mlp_specs(cfg: ModelConfig) -> dict:
    mlp = {"w_up": (None, "model"), "w_down": ("model", None)}
    if cfg.glu:
        mlp["w_gate"] = (None, "model")
    return mlp


def layer_specs(cfg: ModelConfig, tp: int) -> dict:
    """Specs of ONE layer (the caller prepends the stacking dim).  MoE: the
    experts over the model group on their expert dim, the router replicated,
    a dense residual FFN as the dense MLP."""
    if cfg.block_kind != "attn":
        raise NotImplementedError(f"{cfg.name}: the port shards attention stacks "
                                  f"only so far")
    kv = (None, None) if attn_mod.local_counts(cfg, tp)[2] else (None, "model")
    s = {"ln1": _norm_specs(cfg), "ln2": _norm_specs(cfg),
         "attn": {"wq": (None, "model"), "wk": kv, "wv": kv, "wo": ("model", None)}}
    if cfg.is_moe:
        moe = {"router": (None, None), "w_up": ("model", None, None),
               "w_down": ("model", None, None)}
        if cfg.glu:
            moe["w_gate"] = ("model", None, None)
        if cfg.moe_dense_residual:
            moe["dense"] = _mlp_specs(cfg)
        s["moe"] = moe
    else:
        s["mlp"] = _mlp_specs(cfg)
    return _strip_model(s) if tp == 1 else s


def param_specs(cfg: ModelConfig, tp: int) -> dict:
    """Specs of the parameter tree (layer leaves stacked on a leading dim);
    the vocabulary of the embedding and the head is sharded."""
    specs = {"embed": ("model", None), "final_norm": _norm_specs(cfg),
             "layers": tree.tree_map(lambda sp: (None, *sp), layer_specs(cfg, tp))}
    if not cfg.tie_embeddings:
        specs["head"] = ("model", None)
    return _strip_model(specs) if tp == 1 else specs


def model_partial_leaves(cfg: ModelConfig, tp: int) -> frozenset:
    """Paths of the layer leaves that are replicated over the model group
    but used on one rank's share only, so that each rank's gradient is
    partial: ``wk`` and ``wv`` when the KV heads are replicated."""
    if tp > 1 and attn_mod.local_counts(cfg, tp)[2]:
        return frozenset({("attn", "wk"), ("attn", "wv")})
    return frozenset()


def head_weight(cfg: ModelConfig, params: dict) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["head"]


def embed_inputs(cfg: ModelConfig, params: dict, batch: dict, axis: AxisCtx = LOCAL):
    """Returns (x [B, S, D], positions [B, S]) for token inputs."""
    if cfg.input_mode != "tokens":
        raise NotImplementedError(f"input mode {cfg.input_mode!r} is not ported yet")
    x = embed_tokens(cfg, params["embed"], batch["tokens"], axis)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    return x, positions


def layer_tables(cfg: ModelConfig):
    """(windows, shared-attention flags, KV slots), one Python int per layer."""
    return cfg.layer_windows(), cfg.attn_layer_flags(), cfg.attn_slot_index()


# ---------------------------------------------------------------------------
# Training forward and loss (dense attention stacks)
# ---------------------------------------------------------------------------
def apply_layer(cfg: ModelConfig, lp: dict, x: torch.Tensor, *,
                positions: torch.Tensor, window: int,
                axis: AxisCtx = LOCAL) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One layer, training mode: norm -> attention -> norm -> MLP or MoE,
    each with its residual.  ``lp`` holds this rank's model shards.  Returns
    (x, aux): the MoE router's load-balance loss, an fp32 scalar, or None
    for a dense layer (the JAX package's 0.0; nothing to differentiate)."""
    h = apply_norm(cfg, lp["ln1"], x)
    x = x + attn_mod.attention_train(cfg, lp["attn"], h, positions=positions,
                                     window=window, axis=axis)
    h = apply_norm(cfg, lp["ln2"], x)
    if cfg.is_moe:
        delta, aux = moe_mod.apply_moe(cfg, lp["moe"], h, axis)
        return x + delta, aux
    return x + mlp_mod.apply_mlp(cfg, lp["mlp"], h, axis), None


def forward(cfg: ModelConfig, params: dict, batch: dict, *, remat: bool = True,
            axis: AxisCtx = LOCAL):
    """Embed, the layer stack (each layer recomputed in the backward when
    ``remat``), the final norm -> (x [B, S, D], the layers' summed aux)."""
    x, positions = embed_inputs(cfg, params, batch, axis)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, w in zip(params["layers"], cfg.layer_windows()):
        if remat:
            x, a = checkpoint(apply_layer, cfg, lp, x, positions=positions, window=w,
                              axis=axis, use_reentrant=False)
        else:
            x, a = apply_layer(cfg, lp, x, positions=positions, window=w, axis=axis)
        aux = aux if a is None else aux + a
    return apply_norm(cfg, params["final_norm"], x), aux


def head_loss(cfg: ModelConfig, params: dict, x: torch.Tensor,
              batch: dict, axis: AxisCtx = LOCAL) -> torch.Tensor:
    return lm_head_loss(cfg, head_weight(cfg, params), x, batch["labels"],
                        batch["mask"], axis)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *, remat: bool = True,
            axis: AxisCtx = LOCAL):
    """Summed token loss plus the router's aux loss weighted per token (and,
    as the JAX package returns, (nll, n_tok)).  The caller divides by the
    global token count."""
    x, aux = forward(cfg, params, batch, remat=remat, axis=axis)
    nll = head_loss(cfg, params, x, batch, axis)
    n_tok = batch["mask"].float().sum()
    return nll + cfg.router_aux_weight * aux * n_tok, (nll, n_tok)


def to_device(params: dict, device) -> dict:
    """A copy of the parameter tree on ``device``."""
    return {k: ([to_device(lp, device) for lp in v] if isinstance(v, list)
                else to_device(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in params.items()}


def named_parameters(params: dict, prefix: str = ""):
    """(dotted name, tensor) pairs in the JAX tree's naming."""
    for key, val in params.items():
        items = enumerate(val) if isinstance(val, list) else [(None, val)]
        for i, sub in items:
            name = f"{prefix}{key}" if i is None else f"{prefix}{key}.{i}"
            if isinstance(sub, dict):
                yield from named_parameters(sub, name + ".")
            else:
                yield name, sub
