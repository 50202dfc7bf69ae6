"""Transformer parameters, inputs, the training forward and the loss, and
the dense-cache prefill and decode steps (counterpart of
``repro/models/transformer.py``; the paged serving steps in
``serving/steps.py`` run their own cached layer loop).

Three block kinds: attention (dense or MoE), Mamba-2 and RWKV-6
(``models/ssm.py``); a hybrid (Zamba2) runs one ``shared`` attention + MLP
block, one parameter set, after every ``hybrid_attn_period``-th Mamba layer.

Parameters are a plain dict whose names follow the JAX tree, with the layer
stack as a list: ``layers.{i}.attn.wq`` and so on; ``shared`` is present for
a hybrid only.  Matrices are stored in ``cfg.dtype`` (the JAX package casts
its fp32 leaves to it at every use, so the values are the same); norm scales
stay fp32, and so do an MoE layer's router (``moe.init_moe``: the JAX package
keeps it fp32 and routes in fp32) and the recurrent blocks' vectors
(``ssm.FP32_LEAVES``).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.core import partition as zp
from repro_torch.core.dist import LOCAL, AxisCtx
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (ModelConfig, apply_norm, dense_init,
                                       embed_tokens, init_norm, lm_head_loss, lm_logits)


def init_layer(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """One layer's parameters (unstacked)."""
    if cfg.block_kind == "rwkv":
        return {"rwkv": ssm_mod.init_rwkv(cfg, generator, device)}
    if cfg.block_kind == "mamba":
        return {"ln1": init_norm(cfg, cfg.d_model, device),
                "mamba": ssm_mod.init_mamba(cfg, generator, device)}
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


def init_shared(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """A hybrid's shared attention + MLP block, applied after every
    ``hybrid_attn_period``-th layer ({} for other stacks)."""
    if cfg.hybrid_attn_period <= 0:
        return {}
    return {"ln1": init_norm(cfg, cfg.d_model, device),
            "attn": attn_mod.init_attention(cfg, generator, device),
            "ln2": init_norm(cfg, cfg.d_model, device),
            "mlp": mlp_mod.init_mlp(cfg, generator, device)}


def init_params(cfg: ModelConfig, generator: torch.Generator, device,
                axis: AxisCtx = LOCAL) -> dict:
    """Random weights, drawn from ``generator`` (which must live on
    ``device``): the embedding, the layers one by one, a hybrid's shared
    block, the final norm and the head.  With a group ``axis``, this rank's
    block of each leaf by ``serve_param_specs`` (the serving layout): every
    rank draws every leaf in the same order, one layer at a time, and keeps
    its block, so the blocks are those of the whole weights for the same
    seed and no rank ever holds the model."""
    dt = cfg.torch_dtype
    specs = serve_param_specs(cfg, axis.tp)
    lspecs = tree.tree_map(lambda sp: sp[1:], specs["layers"])

    def cut(t, spec):
        return zp.block_of(t, spec, axis)

    params = {
        "embed": cut(dense_init(generator, (cfg.vocab_size, cfg.d_model), dt, device,
                                scale=0.02), specs["embed"]),
        "layers": [tree.tree_map(cut, init_layer(cfg, generator, device), lspecs)
                   for _ in range(cfg.num_layers)],
        "final_norm": init_norm(cfg, cfg.d_model, device),
    }
    if cfg.hybrid_attn_period > 0:
        params["shared"] = tree.tree_map(cut, init_shared(cfg, generator, device),
                                         specs["shared"])
    if not cfg.tie_embeddings:
        params["head"] = cut(dense_init(generator, (cfg.vocab_size, cfg.d_model), dt,
                                        device, scale=0.02), specs["head"])
    return params


# ---------------------------------------------------------------------------
# Partition specs: the model-sharded dim of every leaf (the data/ZeRO
# partition is orthogonal).
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


def _attn_specs(cfg: ModelConfig, tp: int) -> dict:
    kv = (None, None) if attn_mod.local_counts(cfg, tp)[2] else (None, "model")
    return {"wq": (None, "model"), "wk": kv, "wv": kv, "wo": ("model", None)}


def layer_specs(cfg: ModelConfig, tp: int) -> dict:
    """Specs of ONE layer (the caller prepends the stacking dim).  MoE: the
    experts over the model group on their expert dim, the router replicated,
    a dense residual FFN as the dense MLP.  Mamba and RWKV: the recurrence
    heads (and their per-head vectors) over the model group, the output
    projections row-parallel, Mamba's ``w_B``/``w_C`` and RWKV's norms,
    mixes and ``cm_r`` replicated."""
    if cfg.block_kind == "rwkv":
        s = {"rwkv": {
            "ln1": (None,), "ln2": (None,),
            "w_r": (None, "model"), "w_k": (None, "model"),
            "w_v": (None, "model"), "w_g": (None, "model"),
            "w_w": (None, "model"), "w_bias": ("model",),
            "u_bonus": ("model", None), "mix": (None, None),
            "w_time_out": ("model", None),
            "cm_mix": (None, None), "cm_k": (None, "model"),
            "cm_v": ("model", None), "cm_r": (None, None)}}
        return _strip_model(s) if tp == 1 else s
    if cfg.block_kind == "mamba":
        s = {"ln1": _norm_specs(cfg), "mamba": {
            "w_x": (None, "model"), "w_z": (None, "model"),
            "w_B": (None, None), "w_C": (None, None),
            "w_dt": (None, "model"), "dt_bias": ("model",),
            "A_log": ("model",), "D_skip": ("model",),
            "w_out": ("model", None)}}
        return _strip_model(s) if tp == 1 else s
    s = {"ln1": _norm_specs(cfg), "ln2": _norm_specs(cfg), "attn": _attn_specs(cfg, tp)}
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
    if cfg.hybrid_attn_period > 0:
        specs["shared"] = {"ln1": _norm_specs(cfg), "attn": _attn_specs(cfg, tp),
                           "ln2": _norm_specs(cfg), "mlp": _mlp_specs(cfg)}
    if not cfg.tie_embeddings:
        specs["head"] = ("model", None)
    return _strip_model(specs) if tp == 1 else specs


def serve_layer_overrides(cfg: ModelConfig) -> dict | None:
    """Serving: an MoE layer's expert stacks over the data group on their
    expert dim and over the model group on their hidden dim (a 2-D layout
    that fits a large MoE on the serving ranks; tokens reach their experts
    by all-to-all over the data group), the router replicated, a dense
    residual FFN Megatron-split.  None for a layer without experts."""
    if not cfg.is_moe:
        return None
    moe = {"router": (None, None), "w_up": ("data", None, "model"),
           "w_down": ("data", "model", None)}
    if cfg.glu:
        moe["w_gate"] = ("data", None, "model")
    if cfg.moe_dense_residual:
        moe["dense"] = _mlp_specs(cfg)
    return moe


def serve_param_specs(cfg: ModelConfig, tp: int) -> dict:
    """``param_specs`` with ``serve_layer_overrides`` in the layers: the
    serving steps' parameter layout.  A dim named "data" is split over the
    data group, "model" over the model group (dropped at ``tp`` 1)."""
    specs = param_specs(cfg, tp)
    over = serve_layer_overrides(cfg)
    if over is None:
        return specs
    over = tree.tree_map(lambda sp: (None, *sp), over)
    return dict(specs, layers=dict(specs["layers"],
                                   moe=_strip_model(over) if tp == 1 else over))


def model_partial_leaves(cfg: ModelConfig, tp: int) -> frozenset:
    """Paths of the layer leaves that are replicated over the model group
    but used on one rank's share only, so that each rank's gradient is
    partial: ``wk`` and ``wv`` when the KV heads are replicated, Mamba's
    ``w_B``/``w_C`` (one state projection feeds every head) and RWKV's
    ``mix`` (applied after Megatron's f, ``models/ssm.py``).  (A hybrid's
    shared block has as many KV heads as query heads, so they are never
    replicated.)"""
    if tp <= 1:
        return frozenset()
    if cfg.block_kind == "mamba":
        return frozenset({("mamba", "w_B"), ("mamba", "w_C")})
    if cfg.block_kind == "rwkv":
        return frozenset({("rwkv", "mix")})
    if attn_mod.local_counts(cfg, tp)[2]:
        return frozenset({("attn", "wk"), ("attn", "wv")})
    return frozenset()


def head_weight(cfg: ModelConfig, params: dict) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["head"]


def embed_inputs(cfg: ModelConfig, params: dict, batch: dict, axis: AxisCtx = LOCAL):
    """Returns (x [B, S, D] in ``cfg.dtype``, positions [B, S]).  Input modes:
    ``tokens`` ({tokens}); ``embeddings`` ({embeds}, the audio frontend's
    frames, cast: ``params["embed"]`` is not used); ``vlm`` ({tokens,
    vision_embeds}: the projected patches, cast, before the token embeddings,
    the positions running over both)."""
    if cfg.input_mode == "embeddings":
        x = batch["embeds"].to(cfg.torch_dtype)
    else:
        x = embed_tokens(cfg, params["embed"], batch["tokens"], axis)
        if cfg.input_mode == "vlm":
            x = torch.cat([batch["vision_embeds"].to(x.dtype), x], dim=1)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    return x, positions


def embed_grad(cfg: ModelConfig, params: dict, batch: dict, dx: torch.Tensor,
               axis: AxisCtx = LOCAL) -> torch.Tensor | None:
    """The embedding's gradient from ``dx``, the cotangent of
    ``embed_inputs``' output (the lookup recomputed): None in the
    ``embeddings`` mode, which does not use the embedding (the JAX
    package's gradient there is zeros); in the ``vlm`` mode the vision
    prefix's cotangent is dropped (it is data's)."""
    if cfg.input_mode == "embeddings":
        return None
    dx = dx[..., dx.shape[-2] - batch["tokens"].shape[-1]:, :]
    with torch.enable_grad():
        x = embed_tokens(cfg, params["embed"], batch["tokens"], axis)
    return torch.autograd.grad(x, [params["embed"]], dx)[0]


def layer_tables(cfg: ModelConfig):
    """(windows, shared-attention flags, KV slots), one Python int per layer."""
    return cfg.layer_windows(), cfg.attn_layer_flags(), cfg.attn_slot_index()


# ---------------------------------------------------------------------------
# Training forward and loss
# ---------------------------------------------------------------------------
def shared_attn_block(cfg: ModelConfig, shared: dict, x: torch.Tensor,
                      positions: torch.Tensor, axis: AxisCtx = LOCAL) -> torch.Tensor:
    """A hybrid's shared block: norm -> global attention -> norm -> MLP."""
    h = apply_norm(cfg, shared["ln1"], x)
    x = x + attn_mod.attention_train(cfg, shared["attn"], h, positions=positions,
                                     window=0, axis=axis)
    h = apply_norm(cfg, shared["ln2"], x)
    return x + mlp_mod.apply_mlp(cfg, shared["mlp"], h, axis)


def apply_layer(cfg: ModelConfig, lp: dict, x: torch.Tensor, *,
                positions: torch.Tensor, window: int, axis: AxisCtx = LOCAL,
                shared: dict | None = None,
                shared_flag: int = 0) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One layer, training mode.  Attention: norm -> attention -> norm -> MLP
    or MoE, each with its residual; RWKV: its whole block; Mamba: norm ->
    Mamba with its residual, then a hybrid's ``shared`` block when
    ``shared_flag`` (``cfg.attn_layer_flags()[l]``).  ``lp`` holds this
    rank's model shards.  Returns (x, aux): the MoE router's load-balance
    loss, an fp32 scalar, or None for a layer without a router (the JAX
    package's 0.0; nothing to differentiate)."""
    if cfg.block_kind == "rwkv":
        return ssm_mod.apply_rwkv(cfg, lp["rwkv"], x, axis)[0], None
    if cfg.block_kind == "mamba":
        h = apply_norm(cfg, lp["ln1"], x)
        x = x + ssm_mod.apply_mamba(cfg, lp["mamba"], h, axis)[0]
        if shared_flag:
            x = shared_attn_block(cfg, shared, x, positions, axis)
        return x, None
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
    shared = params.get("shared")
    for lp, w, fl in zip(params["layers"], cfg.layer_windows(), cfg.attn_layer_flags()):
        kw = dict(positions=positions, window=w, axis=axis, shared=shared, shared_flag=fl)
        if remat:
            x, a = checkpoint(apply_layer, cfg, lp, x, use_reentrant=False, **kw)
        else:
            x, a = apply_layer(cfg, lp, x, **kw)
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


# ---------------------------------------------------------------------------
# The dense-cache prefill and decode steps (the JAX package's only serving
# path for the recurrent families; the paged engine, ``serving/``, serves
# attention stacks).  Every request pays for the longest context it might
# reach: the KV slots are [B, Hkv_l, max_seq, hd].  Inference only (no
# autograd); the cache is updated in place and returned.
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, axis: AxisCtx = LOCAL,
               device="cpu") -> dict:
    """This rank's cache for ``batch`` rows (its own: the data group splits
    the rows, except under a seq group, where every rank holds every row):
    ``pos`` (the next position, a Python int), the KV slots
    (``num_attn_slots``; ``max_seq / nseq`` positions a rank over a seq
    group; a sliding-window stack's local layers get rings of ``min(W,
    max_seq)`` slots, ``kw``/``vw``, never sequence-sharded) and the
    recurrent state of every layer (``ssm``: fp32 Mamba states, or RWKV's
    fp32 ``S`` and its token-shift rows ``x_tm``/``x_cm``), with this
    rank's heads of the model group."""
    dt = cfg.torch_dtype

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    cache: dict = {"pos": 0}
    if cfg.num_attn_slots() > 0:
        if max_seq % axis.nseq:
            raise ValueError(f"max_seq {max_seq} does not split over {axis.nseq} seq shards")
        hkv_l = (cfg.num_kv_heads // axis.tp if cfg.num_kv_heads % axis.tp == 0 else 1)
        n_w, n_g = cfg.num_window_slots()
        cache["k"] = zeros(n_g, batch, hkv_l, max_seq // axis.nseq, cfg.head_dim)
        cache["v"] = zeros(n_g, batch, hkv_l, max_seq // axis.nseq, cfg.head_dim)
        if cfg.has_window_cache:
            W = min(cfg.sliding_window, max_seq)
            cache["kw"] = zeros(n_w, batch, hkv_l, W, cfg.head_dim)
            cache["vw"] = zeros(n_w, batch, hkv_l, W, cfg.head_dim)
    L = cfg.num_layers
    if cfg.block_kind == "mamba":
        cache["ssm"] = zeros(L, *ssm_mod.mamba_state_shape(cfg, batch, axis.tp),
                             dtype=torch.float32)
    elif cfg.block_kind == "rwkv":
        shp = ssm_mod.rwkv_state_shape(cfg, batch, axis.tp)
        cache["ssm"] = {"S": zeros(L, *shp["S"], dtype=torch.float32),
                        "x_tm": zeros(L, *shp["x_tm"]), "x_cm": zeros(L, *shp["x_cm"])}
    return cache


def _slots(cfg: ModelConfig) -> list[int]:
    return cfg.window_cache_tables()[1] if cfg.has_window_cache else cfg.attn_slot_index()


def _ffn(cfg: ModelConfig, lp: dict, x: torch.Tensor, axis: AxisCtx) -> torch.Tensor:
    h = apply_norm(cfg, lp["ln2"], x)
    if cfg.is_moe:
        return x + moe_mod.apply_moe(cfg, lp["moe"], h, axis)[0]
    return x + mlp_mod.apply_mlp(cfg, lp["mlp"], h, axis)


def _write_ring(cache: dict, slot: int, k: torch.Tensor, v: torch.Tensor) -> None:
    """The last W positions of k/v [B, H, S, hd] into ring slot ``slot``:
    ring index j holds the largest position p < S with p % W == j (zeros
    where there is none)."""
    W, S = cache["kw"].shape[3], k.shape[2]
    lo = max(S - W, 0)
    pj = [lo + ((j - lo) % W) for j in range(W)]
    pj = [p if p < S else p - W for p in pj]
    sel = torch.tensor([min(max(p, 0), S - 1) for p in pj], device=k.device)
    valid = torch.tensor([p >= 0 for p in pj], device=k.device)[None, None, :, None]
    for name, t in (("kw", k), ("vw", v)):
        cache[name][slot] = torch.where(valid, t[:, :, sel], 0).to(cache[name].dtype)


def _cached_layers(cfg: ModelConfig, params: dict, cache: dict, x: torch.Tensor,
                   positions: torch.Tensor, axis: AxisCtx, decode: bool) -> torch.Tensor:
    """The layer stack over the cache: a full-sequence prefill (``decode``
    False: the KV slots and rings written, every recurrent state taken to its
    end state) or one decode token at ``cache["pos"]``."""
    S = x.shape[1]
    shared = params.get("shared")
    for l, (lp, w, fl, slot) in enumerate(zip(params["layers"], cfg.layer_windows(),
                                              cfg.attn_layer_flags(), _slots(cfg))):
        if cfg.block_kind == "rwkv":
            ssm = cache["ssm"]
            x, st = ssm_mod.apply_rwkv(cfg, lp["rwkv"], x, axis, decode=decode,
                                       state={k: v[l] for k, v in ssm.items()})
            for k, v in st.items():
                ssm[k][l] = v.to(ssm[k].dtype)
            continue
        if cfg.block_kind == "mamba":
            h = apply_norm(cfg, lp["ln1"], x)
            delta, cache["ssm"][l] = ssm_mod.apply_mamba(cfg, lp["mamba"], h, axis,
                                                         state=cache["ssm"][l], decode=decode)
            x = x + delta
            if not fl:
                continue
            lp, w = shared, 0                 # the shared block, in this slot
        h = apply_norm(cfg, lp["ln1"], x)
        ring = cfg.has_window_cache and w > 0
        if decode:
            kc, vc = ("kw", "vw") if ring else ("k", "v")
            d, _, _ = attn_mod.attention_decode(cfg, lp["attn"], h, k_cache=cache[kc][slot],
                                                v_cache=cache[vc][slot], pos=cache["pos"],
                                                window=w, axis=axis, ring=ring)
        else:
            d, k, v = attn_mod.attention_train(cfg, lp["attn"], h, positions=positions,
                                               window=w, axis=axis, return_kv=True)
            if ring:
                _write_ring(cache, slot, k, v)
            else:
                cache["k"][slot, :, :, :S] = k.to(cache["k"].dtype)
                cache["v"][slot, :, :, :S] = v.to(cache["v"].dtype)
        x = _ffn(cfg, lp, x + d, axis)
    return x


@torch.no_grad()
def prefill_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict,
                 axis: AxisCtx = LOCAL):
    """Full-sequence prefill of ``batch["tokens"]`` [B, S]: runs the stack,
    writes the KV slots at positions [0, S) (the rings: their last W
    positions) and every layer's recurrent end state, and returns
    (last-position logits [B, V] fp32, cache); ``cache["pos"]`` becomes S.
    The cache is whole in the sequence: a sequence-sharded one is filled by
    decode steps (the JAX package's prefill has no seq axis either)."""
    if axis.seq is not None:
        raise ValueError("prefill writes an unsharded cache; decode fills a "
                         "sequence-sharded one")
    x, positions = embed_inputs(cfg, params, batch, axis)
    x = _cached_layers(cfg, params, cache, x, positions, axis, decode=False)
    x = apply_norm(cfg, params["final_norm"], x[:, -1:].contiguous())
    cache["pos"] = positions.shape[1]
    return lm_logits(cfg, head_weight(cfg, params), x, axis)[:, 0], cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: dict, cache: dict, tokens: torch.Tensor,
                axis: AxisCtx = LOCAL):
    """tokens [B] at position ``cache["pos"]`` -> (logits [B, V] fp32, the
    vocabulary whole on every rank of a model group; cache),
    the recurrent states advanced by one step (``ssm.linear_attention_step``)
    and the token's K/V written; ``cache["pos"]`` advances by one."""
    x = embed_tokens(cfg, params["embed"], tokens[:, None], axis)
    x = _cached_layers(cfg, params, cache, x, None, axis, decode=True)
    x = apply_norm(cfg, params["final_norm"], x)
    cache["pos"] += 1
    return lm_logits(cfg, head_weight(cfg, params), x, axis)[:, 0], cache


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
