"""Model steps against the paged KV cache (counterpart of
``repro/serving/steps.py``).

  * ``paged_prefill_step`` runs full-sequence attention (the flash kernel)
    over a right-padded ragged batch and writes each request's K/V into its
    table's blocks; padded chunks go to the trash block, and each request's
    logits are read at its true last prompt position;
  * ``paged_decode_step`` advances every slot by one token: the new K/V
    lands at ``(table[len // bs], len % bs)`` and attention runs through the
    paged decode kernel.

An MoE layer routes every row of the step, as the JAX package's does: the
pad positions of a prefill batch and the idle slots of a decode step take
expert capacity too (their outputs are discarded).

K/V writes into the pool are in place (``index_put_``, also behind the
indexed assignment in the decode step).  The JAX package writes through a
functional update of a donated buffer; here nothing is donated or copied,
which saves one pool copy per layer and step.

Over a data x model group (``build_paged_serve_step``) each rank holds its
block of the weights (``transformer.serve_param_specs``) and its KV heads of
the pool; block tables, lengths and tokens are the same on every rank, and
every data rank decodes every slot, as in the JAX package.  A step issues
2 L + 1 all-reduces over the model group (the embedding, each layer's
attention output and MLP or MoE) and one all-gather of the logits' vocabulary
blocks; an MoE layer with its experts over the data group adds two
all-to-alls over it.
"""
from __future__ import annotations

import torch

from repro_torch.core.dist import LOCAL, AxisCtx
from repro_torch.core.stepfn import serve_axis
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as T
from repro_torch.models.common import (ModelConfig, apply_norm, apply_rope,
                                       embed_tokens, lm_logits, reduce_from_model)


def _write_prefill_kv(pool: torch.Tensor, kv: torch.Tensor,
                      bids_flat: torch.Tensor) -> None:
    """pool: [N+1, H, bs, hd]; kv: [B, H, S, hd]; bids_flat: [B * S/bs]
    (padded chunks already pointed at the trash block)."""
    _, H, bs, hd = pool.shape
    B, _, S, _ = kv.shape
    tiles = kv.reshape(B, H, S // bs, bs, hd).transpose(1, 2)
    pool.index_put_((bids_flat,), tiles.reshape(-1, H, bs, hd).to(pool.dtype))


def _mlp_block(cfg: ModelConfig, lp: dict, x: torch.Tensor, axis: AxisCtx) -> torch.Tensor:
    """The feed-forward half of a layer: the MLP, or the MoE (its aux loss
    dropped)."""
    h = apply_norm(cfg, lp["ln2"], x)
    if cfg.is_moe:
        return x + moe_mod.apply_moe(cfg, lp["moe"], h, axis)[0]
    return x + mlp_mod.apply_mlp(cfg, lp["mlp"], h, axis)


def paged_prefill_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict,
                       block_tables: torch.Tensor, axis: AxisCtx = LOCAL):
    """batch: {"tokens": [B, S], "lens": [B]} with S a multiple of the block
    size and ``lens[r] <= S`` the true prompt lengths.  Returns (logits
    [B, V] fp32 at each request's last prompt position, the vocabulary whole
    on every rank of a model group; cache)."""
    tokens, lens = batch["tokens"], batch["lens"].long()
    x, positions = T.embed_inputs(cfg, params, {"tokens": tokens}, axis)
    B, S = tokens.shape
    bs = cache["k"].shape[3]
    trash = cache["k"].shape[1] - 1
    nb = S // bs
    # chunk j of request r is live iff it covers a written position
    valid = torch.arange(nb, device=x.device)[None, :] * bs < lens[:, None]
    bids_flat = torch.where(valid, block_tables[:, :nb].long(),
                            torch.full_like(valid, trash, dtype=torch.long)).reshape(-1)
    windows, _, slots = T.layer_tables(cfg)
    for lp, w, slot in zip(params["layers"], windows, slots):
        h = apply_norm(cfg, lp["ln1"], x)
        d, k, v = attn_mod.attention_train(cfg, lp["attn"], h, positions=positions,
                                           window=w, return_kv=True, axis=axis)
        x = x + d
        _write_prefill_kv(cache["k"][slot], k, bids_flat)
        _write_prefill_kv(cache["v"][slot], v, bids_flat)
        x = _mlp_block(cfg, lp, x, axis)
    last = (lens - 1).clamp(min=0)
    xl = x[torch.arange(B, device=x.device), last][:, None]          # [B, 1, D]
    xl = apply_norm(cfg, params["final_norm"], xl)
    return lm_logits(cfg, T.head_weight(cfg, params), xl, axis)[:, 0], cache


def paged_decode_step(cfg: ModelConfig, params: dict, cache: dict,
                      block_tables: torch.Tensor, lens: torch.Tensor,
                      tokens: torch.Tensor, axis: AxisCtx = LOCAL):
    """One token for every slot.  tokens/lens: [R]; ``lens[r]`` is the
    number of tokens already cached (the new token is written at that
    position and attended to).  Slots with ``lens < 0`` are idle: their
    writes hit the trash block, their attention output is zero and their
    logits are to be discarded.  Returns (logits [R, V] fp32, the vocabulary
    whole on every rank of a model group; cache).  K7 runs on this rank's
    heads.

    Capacity contract: the caller guarantees ``lens[r] // block_size <
    block_tables.shape[1]`` and that the named block is allocated.
    """
    R = tokens.shape[0]
    bs = cache["k"].shape[3]
    trash = cache["k"].shape[1] - 1
    lens = lens.long()
    lens_c = lens.clamp(min=0)
    x = embed_tokens(cfg, params["embed"], tokens[:, None], axis)   # [R, 1, D]
    positions = lens_c[:, None]
    bid = block_tables.long().gather(1, (lens_c // bs)[:, None])[:, 0]
    bid = torch.where(lens >= 0, bid, torch.full_like(bid, trash))
    off = lens_c % bs
    ctx = torch.where(lens >= 0, lens + 1, torch.zeros_like(lens)).to(torch.int32)
    tables = block_tables.to(torch.int32).contiguous()
    windows, _, slots = T.layer_tables(cfg)
    for lp, w, slot in zip(params["layers"], windows, slots):
        h = apply_norm(cfg, lp["ln1"], x)
        q, k_new, v_new = attn_mod.project_qkv(cfg, lp["attn"], h, axis)
        q = apply_rope(q, positions, cfg.rope_theta)
        k_new = apply_rope(k_new, positions, cfg.rope_theta)
        kc, vc = cache["k"][slot], cache["v"][slot]
        kc[bid, :, off] = k_new[:, 0].to(kc.dtype)
        vc[bid, :, off] = v_new[:, 0].to(vc.dtype)
        y = kops.paged_attention(q[:, 0].contiguous(), kc, vc, tables, ctx,
                                 window=w, softcap=cfg.attn_logit_softcap)
        x = x + reduce_from_model(y.reshape(R, 1, -1) @ lp["attn"]["wo"].to(x.dtype), axis)
        x = _mlp_block(cfg, lp, x, axis)
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_logits(cfg, T.head_weight(cfg, params), x, axis)[:, 0], cache


# ---------------------------------------------------------------------------
# Builders: plain callables over this rank's groups (the JAX package's jit and
# shard_map builders)
# ---------------------------------------------------------------------------
def build_paged_decode_fn(cfg: ModelConfig, axis: AxisCtx = LOCAL):
    """``decode(params, cache, block_tables, lens, tokens) -> (logits,
    cache)``: ``paged_decode_step`` over ``axis`` as given."""
    def decode(params, cache, block_tables, lens, tokens):
        return paged_decode_step(cfg, params, cache, block_tables, lens, tokens, axis)
    return decode


def build_paged_prefill_fn(cfg: ModelConfig, axis: AxisCtx = LOCAL):
    """``prefill(params, cache, batch, block_tables) -> (logits, cache)``:
    ``paged_prefill_step`` over ``axis`` as given."""
    def prefill(params, cache, batch, block_tables):
        return paged_prefill_step(cfg, params, cache, batch, block_tables, axis)
    return prefill


def paged_cache_specs(cfg: ModelConfig, axis: AxisCtx = LOCAL) -> dict:
    """The pool's layout: every block on every data rank, the KV heads over
    the model group (``init_paged_cache(..., axis)``)."""
    sp = (None, None, "model" if axis.tp > 1 else None, None, None)
    return {"k": sp, "v": sp}


def build_paged_serve_step(cfg: ModelConfig, *, axis: AxisCtx = LOCAL):
    """``serve(params, cache, block_tables, lens, tokens) -> (logits [R, V],
    cache)`` on this rank of a data x model group: its block of the weights
    (``transformer.serve_param_specs``; ``transformer.init_params`` or
    ``convert.params_from_numpy`` with the rank's axis), its pool (``init_paged_cache(cfg, pcfg,
    device, axis)``), the same tables, lengths and tokens on every rank; an
    MoE config's experts over the data group (``stepfn.serve_axis``)."""
    return build_paged_decode_fn(cfg, serve_axis(cfg, axis))
