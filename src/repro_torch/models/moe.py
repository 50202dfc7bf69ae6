"""Mixture-of-experts feed-forward (counterpart of ``repro/models/moe.py``).

Dispatch is GShard's capacity-bounded one-hot dispatch and combine, plain
matmuls (the JAX package's are einsums, no Pallas).  In the training layout
the expert dim is sharded over the model group: the tokens are replicated
there, each rank runs its own experts on the tokens routed to them, and the
combine folds into the block's model all-reduce.  Under expert parallelism
(``AxisCtx.expert``, the data group) the experts are spread over the data
group with their hidden dim over the model group, and tokens travel to their
experts through two all-to-alls (``_apply_moe_a2a``).  The serving layout
(``transformer.serve_param_specs``) is that one too: its experts over the
data group when there are several data ranks; with one, every expert is
local and only its hidden dim is split over the model group, and the
one-hot path runs them.  The branch is read from the weights' shapes
(``E > E_l``), not from the config, as in the JAX package.

The router runs in fp32 on the block's input before it enters the model
group (Megatron's f), so its gradient, the load-balance term's included, is
whole on every rank; the combine weights enter through f of their own, whose
backward sums their per-rank partial gradients.  (The JAX package gets the
same from its vma typing: ``pvary`` where the weights meet a rank's experts.)

The router's aux (load-balance) loss is Switch's ``E * sum_e f_e * p_e``,
with ``f_e`` the share of tokens whose *first* choice is expert ``e``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.core.dist import LOCAL, AllToAll, AxisCtx
from repro_torch.models.common import (ModelConfig, activation, copy_to_model, dense_init,
                                       reduce_from_model)
from repro_torch.models.mlp import apply_mlp, init_mlp


def _experts(generator: torch.Generator, e: int, shape, dtype, device) -> torch.Tensor:
    """``[e, *shape]``, drawn expert by expert (an fp32 draw of one expert at
    a time: full-width expert stacks are tens of GB)."""
    out = torch.empty((e, *shape), dtype=dtype, device=device)
    for i in range(e):
        out[i] = dense_init(generator, shape, dtype, device)
    return out


def init_moe(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """The router is fp32 whatever the matrices' dtype; expert stacks are
    ``[E, D, F]`` (up, gate) and ``[E, F, D]`` (down)."""
    d, f, e, dt = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.torch_dtype
    p = {"router": dense_init(generator, (d, e), torch.float32, device, scale=0.02),
         "w_up": _experts(generator, e, (d, f), dt, device),
         "w_down": _experts(generator, e, (f, d), dt, device)}
    if cfg.glu:
        p["w_gate"] = _experts(generator, e, (d, f), dt, device)
    if cfg.moe_dense_residual:
        p["dense"] = init_mlp(cfg, generator, device, d_ff=cfg.moe_dense_ff or cfg.d_ff)
    return p


def expert_capacity(cfg: ModelConfig, num_tokens: int, *, factor: float = 1.25) -> int:
    cap = int(math.ceil(num_tokens * cfg.experts_per_token * factor / cfg.num_experts))
    return max(cap, 4)


def _router(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x: [T, D] -> (combine weights [T, k] fp32, expert ids [T, k], aux):
    an fp32 softmax over the experts, its top k renormalised."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, cfg.experts_per_token, dim=-1)
    weights = weights / weights.sum(-1, keepdim=True)
    e = cfg.num_experts
    f_e = F.one_hot(ids[:, 0], e).float().mean(0)
    p_e = probs.mean(0)
    aux = e * (f_e * p_e).sum()
    return weights, ids, aux


def _slots(cfg: ModelConfig, ids: torch.Tensor, cap: int):
    """The capacity slot of each (token, k) assignment within its expert: a
    running count over the assignments in token-major order.  Returns
    (slot [T, k], kept = slot < cap)."""
    T, k = ids.shape
    onehot = F.one_hot(ids, cfg.num_experts)                        # [T, k, E]
    pos = onehot.reshape(T * k, -1).cumsum(0).reshape(T, k, -1) - 1
    slot = (pos * onehot).sum(-1)
    return slot, slot < cap


def _expert_ffn(cfg: ModelConfig, p: dict, xe: torch.Tensor) -> torch.Tensor:
    """xe: [E_l, C, D] -> [E_l, C, D] (the hidden dim possibly model-sharded)."""
    dt = xe.dtype
    act = activation(cfg.hidden_act)
    up = torch.bmm(xe, p["w_up"].to(dt))
    h = act(torch.bmm(xe, p["w_gate"].to(dt))) * up if cfg.glu else act(up)
    return torch.bmm(h, p["w_down"].to(dt))


def _apply_moe_a2a(cfg: ModelConfig, p: dict, xt: torch.Tensor, axis: AxisCtx,
                   weights: torch.Tensor, ids: torch.Tensor, *, capacity_factor: float,
                   chunk: int = 8192) -> torch.Tensor:
    """Expert-parallel dispatch over ``axis.expert`` by all-to-all.  The
    experts are spread over the expert group (this rank holds ``E_l`` of
    them), their hidden dim over the model group.  Dispatch and combine are
    a gather and a scatter by index, in token chunks so that the ``[E, cap,
    D]`` buffers in flight stay small; a token past its expert's capacity
    points at a zero row (index ``C``).  Pad tokens of the last chunk are
    routed to expert 0 and take capacity, as in the JAX package."""
    T, D = xt.shape
    dt = xt.dtype
    E, k = cfg.num_experts, cfg.experts_per_token
    e_local = p["w_up"].shape[0]
    n = E // e_local
    chunk = min(chunk, T)
    pad = (-T) % chunk
    if pad:
        xt = torch.cat([xt, xt.new_zeros(pad, D)])
        weights = torch.cat([weights, weights.new_zeros(pad, k)])
        ids = torch.cat([ids, ids.new_zeros(pad, k)])
    cap = expert_capacity(cfg, chunk, factor=capacity_factor)
    t_idx = torch.arange(chunk, device=xt.device)[:, None].expand(chunk, k).reshape(-1)
    out = []
    for c0 in range(0, T + pad, chunk):
        xc, wc, ic = xt[c0:c0 + chunk], weights[c0:c0 + chunk], ids[c0:c0 + chunk]
        slot, keep = _slots(cfg, ic, cap)
        xz = torch.cat([xc, xc.new_zeros(1, D)])                    # [C+1, D]
        tok = torch.full((E, cap + 1), chunk, dtype=torch.long, device=xt.device)
        s_idx = torch.where(keep, slot, torch.full_like(slot, cap)).reshape(-1)
        tok[ic.reshape(-1), s_idx] = t_idx
        xe = xz[tok[:, :cap]]                                       # [E, cap, D]
        # to the experts' ranks: [n, E_l, cap, D] by destination -> by source
        xe = AllToAll.apply(xe, axis, "expert")
        xe = xe.view(n, e_local, cap, D).transpose(0, 1).reshape(e_local, n * cap, D)
        ye = _expert_ffn(cfg, p, xe)
        # and back: [E_l, n * cap, D] -> [n, E_l, cap, D] by destination
        ye = ye.view(e_local, n, cap, D).transpose(0, 1)
        ye = AllToAll.apply(ye, axis, "expert").view(E, cap, D)
        yk = ye[ic, slot.clamp(0, cap - 1)]                         # [C, k, D]
        yk = yk * (wc * keep.to(wc.dtype))[..., None].to(dt)
        out.append(yk.sum(1))
    yt = torch.cat(out)
    return yt[:T] if pad else yt


def apply_moe(cfg: ModelConfig, p: dict, x: torch.Tensor, axis: AxisCtx = LOCAL, *,
              capacity_factor: float = 1.25) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> ([B, S, D], aux fp32 scalar).

    Training layout: the expert dim over the model group (this rank's
    experts start at ``model_index * E_l``), capacity-bounded one-hot
    dispatch over every token, the combine completed by the block's model
    all-reduce.  Under expert parallelism (``axis.expert`` set, the experts
    spread over it) the all-to-all dispatch of ``_apply_moe_a2a``.  Arctic's
    dense residual FFN (its hidden dim over the model group) runs beside the
    experts with no collective of its own: its partial sums fold into the
    same all-reduce."""
    B, S, D = x.shape
    T = B * S
    dt = x.dtype
    weights, ids, aux = _router(cfg, p, x.reshape(T, D))
    xm = copy_to_model(x, axis)
    xt = xm.reshape(T, D)
    wm = copy_to_model(weights, axis)
    e_total, e_local = cfg.num_experts, p["w_up"].shape[0]
    if axis.expert is not None and e_total > e_local:
        y = _apply_moe_a2a(cfg, p, xt, axis, wm, ids,
                           capacity_factor=capacity_factor).reshape(B, S, D)
    else:
        # profiler ranges (a few host microseconds each) split the block's
        # device time: the one-hot dispatch, the experts, the combine
        with record_function("moe.dispatch"):
            cap = expert_capacity(cfg, T, factor=capacity_factor)
            slot, keep = _slots(cfg, ids, cap)
            e_lo = (axis.model_index * e_local
                    if axis.model is not None and e_total > e_local else 0)
            local_eid = ids - e_lo
            local = (local_eid >= 0) & (local_eid < e_local) & keep
            # [T, k, E_l] x [T, k, cap] -> [T, E_l, cap]; a token never holds
            # two slots of one expert, so the sum over k is exact
            oh_e = (F.one_hot(local_eid.clamp(0, e_local - 1), e_local).to(dt)
                    * local[..., None].to(dt))
            oh_c = F.one_hot(slot.clamp(max=cap - 1), cap).to(dt)
            disp = torch.einsum("tke,tkc->tec", oh_e, oh_c).reshape(T, e_local * cap)
            xe = (disp.t() @ xt).view(e_local, cap, D)
        with record_function("moe.experts"):
            ye = _expert_ffn(cfg, p, xe)
        with record_function("moe.combine"):
            comb = torch.einsum("tke,tkc->tec", oh_e * wm.to(dt)[..., None],
                                oh_c).reshape(T, e_local * cap)
            y = (comb @ ye.reshape(e_local * cap, D)).view(B, S, D)
    if cfg.moe_dense_residual:
        y = y + apply_mlp(cfg, p["dense"], xm, LOCAL)
    return reduce_from_model(y, axis), aux
