"""Linear-recurrence (SSM) blocks: Mamba-2 (SSD) and RWKV-6 (Finch)
(counterpart of ``repro/models/ssm.py``).

Both run through one chunked linear-attention engine:

    S_t = diag(d_t) . S_{t-1} + k_t v_t^T          (S in R^{dk x dv} per head)
    o_t = q_t . S_t                                (inclusive, Mamba-2)
    o_t = q_t . (S_{t-1} + diag(u) k_t v_t^T)      (bonus form, RWKV-6)

with the per-step decay d_t a vector over dk (RWKV-6, data-dependent) or a
scalar per head (Mamba-2).  The sequence is cut into chunks: a Python loop
carries the fp32 inter-chunk state (the JAX package's ``lax.scan``) while the
intra-chunk part is an attention-like product with pairwise decay ratios
taken in log space, every exponent <= 0.  The JAX package computes all of
this outside Pallas, so the port is plain PyTorch too (cuBLAS products and
elementwise kernels on the card).  The state's recurrence is all that needs
the loop: the intra-chunk terms, each chunk's state increment and decay, and
the carried state's contribution to the outputs are batched over a group of
chunks (``GROUP_ELEMS`` bounds a group's pairwise-decay tensor), which takes
the host's launches per chunk from about a hundred to a few.  Under autograd
each group is recomputed in the backward (``torch.utils.checkpoint``), so a
layer's backward holds one group's ``[B, G, t, s, H, dk]`` decays at a time.

Tensor parallelism over the model group: the recurrence heads are sharded and
the output projections are row-parallel with one all-reduce each.  Megatron's
f (``copy_to_model``) sits where the replicated activation enters the
sharded projections: Mamba's normed input, whose replicated ``w_B``/``w_C``
feed only the rank's heads, so their gradients are partial on a rank; RWKV's
normed time-mix input, after which the replicated ``mix`` is applied, so its
gradient is partial too; and RWKV's channel-mix key input after its mix,
since the receptance ``cm_r`` is replicated and computed whole on every rank
(an f on the normed input would count that path once per rank).  The partial
leaves are ``transformer.model_partial_leaves``'s.

Leaves the JAX package reads in fp32 (``w_bias``, ``u_bonus``, ``dt_bias``,
``A_log``) or that are norm scales or mixes stay fp32 in the serving
parameters (``FP32_LEAVES``); the matrices are ``cfg.dtype``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.dist import LOCAL, AxisCtx
from repro_torch.models.common import (ModelConfig, copy_to_model, dense_init,
                                       reduce_from_model, rms_norm)

# the per-block leaves kept fp32 in the serving parameters
FP32_LEAVES = frozenset({"ln1", "ln2", "mix", "cm_mix", "w_bias", "u_bonus", "dt_bias",
                         "A_log", "D_skip"})


# ---------------------------------------------------------------------------
# Chunked linear-attention engine
# ---------------------------------------------------------------------------
# elements of one group's pairwise-decay tensor [B, G, t, s, H, dk'] (fp32):
# the chunks of a group are computed together, so that the per-chunk host
# work (a few launches each) is spread over G chunks, while a group's
# transient tensors stay near a quarter of a GB
GROUP_ELEMS = 1 << 26


def _group(S0, q, k, v, ld, tri, bonus):
    """G chunks at once: ``S0`` [B,H,dk,dv] fp32 and the chunks' fp32 inputs
    [B,G,t,H,d] -> (the state after the last chunk, o [B,G,t,H,dv]).  The
    intra-chunk terms, each chunk's state increment and its decay are
    batched over the G chunks; only the state's recurrence loops."""
    lc = torch.cumsum(ld, dim=2)                                   # inclusive, per chunk
    lc_tot = lc[:, :, -1:]                                         # [B,G,1,H,dk']
    # the bonus form reads S_{t-1}: the t-th decay is excluded through lc - ld
    lct = lc if bonus is None else lc - ld
    # intra-chunk pairs: A[t,s] = sum_dk q_t k_s exp(lct_t - lc_s), s <= t
    # (s < t in the bonus form)
    ld_pair = lct[:, :, :, None] - lc[:, :, None]                  # [B,G,t,s,H,dk']
    dec = torch.exp(torch.where(tri[:, :, None, None], ld_pair,
                                torch.full_like(ld_pair, float("-inf"))))
    if ld.shape[-1] == 1:
        A = torch.einsum("bgthk,bgshk->bghts", q, k) * dec[..., 0].permute(0, 1, 4, 2, 3)
    else:
        A = torch.einsum("bgthk,bgshk,bgtshk->bghts", q, k, dec)
    o = torch.einsum("bghts,bgshv->bgthv", A, v)
    if bonus is not None:
        o = o + torch.einsum("bgthk,hk,bgthk->bgth", q, bonus.float(), k)[..., None] * v
    # each chunk's state increment sum_s exp(lc_tot - lc_s) k_s v_s and decay
    inc = torch.einsum("bgshk,bgshv->bghkv", k * torch.exp(lc_tot - lc), v)
    dtot = torch.exp(lc_tot)[:, :, 0, :, :, None]                  # [B,G,H,dk',1]
    states = []
    for g in range(q.shape[1]):
        states.append(S0)
        S0 = S0 * dtot[:, g] + inc[:, g]
    # the carried state's contribution to each chunk's outputs
    o = o + torch.einsum("bgthk,bghkv->bgthv", q * torch.exp(lct), torch.stack(states, 1))
    return S0, o


def linear_attention_chunked(q, k, v, log_decay, state0, *, chunk: int = 64,
                             bonus: torch.Tensor | None = None):
    """q, k: [B,S,H,dk]; v: [B,S,H,dv]; log_decay: [B,S,H,dk] or [B,S,H,1];
    state0: [B,H,dk,dv].  ``bonus`` [H,dk] (RWKV's u): the output reads
    S_{t-1} plus the current token's bonus term; None: the inclusive q_t.S_t.
    S is padded to a multiple of ``chunk`` (zero inputs: the padded steps
    neither decay nor add to the state).  Returns (o [B,S,H,dv] in v's dtype,
    state_end [B,H,dk,dv] fp32)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        q, k, v, log_decay = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v, log_decay))
    n = (S + pad) // chunk
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=q.device),
                     diagonal=-1 if bonus is not None else 0)
    qc, kc, vc, ldc = (a.float().view(B, n, chunk, H, a.shape[-1])
                       for a in (q, k, v, log_decay))
    G = max(1, min(n, GROUP_ELEMS // (B * chunk * chunk * H * log_decay.shape[-1])))
    remat = torch.is_grad_enabled() and any(
        a.requires_grad for a in (q, k, v, log_decay, state0)
        + (() if bonus is None else (bonus,)))
    st = state0.float()
    outs = []
    for i in range(0, n, G):
        args = (st, qc[:, i:i + G], kc[:, i:i + G], vc[:, i:i + G], ldc[:, i:i + G], tri,
                bonus)
        if remat:
            st, o = checkpoint(_group, *args, use_reentrant=False)
        else:
            st, o = _group(*args)
        outs.append(o)
    o = torch.cat(outs, dim=1).reshape(B, n * chunk, H, dv)[:, :S]
    return o.to(v.dtype), st


def linear_attention_step(q, k, v, log_decay, state, *, bonus=None):
    """One decode token.  q, k: [B,H,dk]; v: [B,H,dv]; state: [B,H,dk,dv]
    fp32 -> (o [B,H,dv] in v's dtype, new state)."""
    out_dtype = v.dtype
    q, k, v, ld = (a.float() for a in (q, k, v, log_decay))
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    if bonus is None:
        state = state * torch.exp(ld)[..., None] + kv
        o = torch.einsum("bhk,bhkv->bhv", q, state)
    else:
        o = torch.einsum("bhk,bhkv->bhv", q, state + bonus.float()[None, :, :, None] * kv)
        state = state * torch.exp(ld)[..., None] + kv
    return o.to(out_dtype), state


# ---------------------------------------------------------------------------
# Mamba-2 (SSD): returns a residual delta (the caller's pre-norm)
# ---------------------------------------------------------------------------
def init_mamba(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    d, f, st = cfg.d_model, cfg.d_ff, cfg.ssm_state
    heads = f // cfg.ssm_head_dim
    dt = cfg.torch_dtype
    kw = dict(dtype=torch.float32, device=device)
    return {
        "w_x": dense_init(generator, (d, f), dt, device),
        "w_z": dense_init(generator, (d, f), dt, device),
        "w_B": dense_init(generator, (d, st), dt, device),   # shared across heads
        "w_C": dense_init(generator, (d, st), dt, device),
        "w_dt": dense_init(generator, (d, heads), dt, device),
        "dt_bias": torch.zeros(heads, **kw),
        "A_log": torch.zeros(heads, **kw),                    # A = -exp(A_log)
        "D_skip": torch.ones(heads, **kw),
        "w_out": dense_init(generator, (f, d), dt, device),
    }


def mamba_state_shape(cfg: ModelConfig, batch: int, tp: int = 1) -> tuple[int, ...]:
    heads = cfg.d_ff // cfg.ssm_head_dim // tp
    return (batch, heads, cfg.ssm_state, cfg.ssm_head_dim)


def apply_mamba(cfg: ModelConfig, p: dict, x: torch.Tensor, axis: AxisCtx = LOCAL, *,
                state: torch.Tensor | None = None, decode: bool = False,
                chunk: int = 64):
    """x: [B,S,D] (normed) -> (delta [B,S,D], state_end [B,H_l,dk,hd])."""
    B, S, _ = x.shape
    hd = cfg.ssm_head_dim
    dt_ = x.dtype
    f32 = torch.float32
    x = copy_to_model(x, axis)
    xs = x @ p["w_x"].to(dt_)
    z = x @ p["w_z"].to(dt_)
    Bm = x @ p["w_B"].to(dt_)
    Cm = x @ p["w_C"].to(dt_)
    heads = xs.shape[-1] // hd
    dt_t = F.softplus((x @ p["w_dt"].to(dt_)).float() + p["dt_bias"].float())  # [B,S,H]
    A = -torch.exp(p["A_log"].float())
    log_decay = (A * dt_t)[..., None]                                     # [B,S,H,1]
    v = (xs.view(B, S, heads, hd).float() * dt_t[..., None]).to(dt_)     # dt-scaled input
    k = Bm[:, :, None, :].expand(B, S, heads, Bm.shape[-1])
    q = Cm[:, :, None, :].expand(B, S, heads, Cm.shape[-1])
    if state is None:
        state = torch.zeros((B, heads, cfg.ssm_state, hd), dtype=f32, device=x.device)
    if decode:
        o, state = linear_attention_step(q[:, 0], k[:, 0], v[:, 0], log_decay[:, 0], state)
        o = o[:, None]
    else:
        o, state = linear_attention_chunked(q, k, v, log_decay, state, chunk=chunk)
    o = o + xs.view(B, S, heads, hd) * p["D_skip"].to(dt_)[None, None, :, None]
    o = o.reshape(B, S, -1) * F.silu(z.float()).to(dt_)
    return reduce_from_model(o @ p["w_out"].to(dt_), axis), state


# ---------------------------------------------------------------------------
# RWKV-6 (Finch): a whole layer (its own norms and residuals)
# ---------------------------------------------------------------------------
def init_rwkv(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.ssm_head_dim
    heads, inner, dt = cfg.rwkv_heads, cfg.rwkv_inner, cfg.torch_dtype
    kw = dict(dtype=torch.float32, device=device)
    return {
        "ln1": torch.ones(d, **kw),
        "ln2": torch.ones(d, **kw),
        "w_r": dense_init(generator, (d, inner), dt, device),
        "w_k": dense_init(generator, (d, inner), dt, device),
        "w_v": dense_init(generator, (d, inner), dt, device),
        "w_g": dense_init(generator, (d, inner), dt, device),
        "w_w": dense_init(generator, (d, inner), dt, device, scale=0.01),  # decay
        "w_bias": torch.full((inner,), -2.0, **kw),
        "u_bonus": dense_init(generator, (heads, hd), torch.float32, device, scale=0.5),
        "mix": torch.full((5, d), 0.5, **kw),             # token-shift mixes (r,k,v,g,w)
        "w_time_out": dense_init(generator, (inner, d), dt, device),
        "cm_mix": torch.full((2, d), 0.5, **kw),
        "cm_k": dense_init(generator, (d, f), dt, device),
        "cm_v": dense_init(generator, (f, d), dt, device),
        "cm_r": dense_init(generator, (d, d), dt, device),
    }


def rwkv_state_shape(cfg: ModelConfig, batch: int, tp: int = 1) -> dict:
    hd = cfg.ssm_head_dim
    return {"S": (batch, cfg.rwkv_heads // tp, hd, hd),
            "x_tm": (batch, cfg.d_model),
            "x_cm": (batch, cfg.d_model)}


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """x: [B,S,D] -> x shifted right by one (``prev`` fills position 0)."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def apply_rwkv(cfg: ModelConfig, p: dict, x: torch.Tensor, axis: AxisCtx = LOCAL, *,
               state: dict | None = None, decode: bool = False, chunk: int = 64):
    """The whole RWKV layer.  x: [B,S,D] -> (new x [B,S,D], state), state
    {"S": [B,H_l,hd,hd] fp32, "x_tm": [B,D], "x_cm": [B,D]}."""
    B, S, D = x.shape
    hd = cfg.ssm_head_dim
    heads_l = p["w_r"].shape[-1] // hd        # this rank's heads
    dt_ = x.dtype
    have_state = state is not None
    if not have_state:
        state = {"S": torch.zeros((B, heads_l, hd, hd), dtype=torch.float32,
                                  device=x.device),
                 "x_tm": torch.zeros((B, D), dtype=dt_, device=x.device),
                 "x_cm": torch.zeros((B, D), dtype=dt_, device=x.device)}
    # ---- time mix --------------------------------------------------------
    a = rms_norm(x, p["ln1"])
    a_last = a[:, -1]
    a = copy_to_model(a, axis)
    aprev = _token_shift(a, state["x_tm"] if (decode or have_state) else None)
    mix = p["mix"].to(dt_)
    xr, xk, xv, xg, xw = (a + mix[i] * (aprev - a) for i in range(5))
    r = (xr @ p["w_r"].to(dt_)).view(B, S, heads_l, hd)
    k = (xk @ p["w_k"].to(dt_)).view(B, S, heads_l, hd)
    v = (xv @ p["w_v"].to(dt_)).view(B, S, heads_l, hd)
    g = xg @ p["w_g"].to(dt_)
    wraw = (xw @ p["w_w"].to(dt_)).float()
    log_decay = -torch.exp(wraw + p["w_bias"].float())              # < 0
    log_decay = log_decay.view(B, S, heads_l, hd)
    if decode:
        o, S1 = linear_attention_step(r[:, 0], k[:, 0], v[:, 0], log_decay[:, 0],
                                      state["S"], bonus=p["u_bonus"])
        o = o[:, None]
    else:
        o, S1 = linear_attention_chunked(r, k, v, log_decay, state["S"], chunk=chunk,
                                         bonus=p["u_bonus"])
    # per-head group norm
    o32 = o.float()
    mu = o32.mean(-1, keepdim=True)
    var = (o32 - mu).square().mean(-1, keepdim=True)
    o = ((o32 - mu) * torch.rsqrt(var + 1e-5)).to(dt_)
    o = o.reshape(B, S, -1) * F.silu(g.float()).to(dt_)
    x = x + reduce_from_model(o @ p["w_time_out"].to(dt_), axis)
    # ---- channel mix -------------------------------------------------------
    b = rms_norm(x, p["ln2"])
    bprev = _token_shift(b, state["x_cm"] if (decode or have_state) else None)
    cmix = p["cm_mix"].to(dt_)
    xk2 = copy_to_model(b + cmix[0] * (bprev - b), axis)
    xr2 = b + cmix[1] * (bprev - b)
    kk = torch.square(F.relu(xk2 @ p["cm_k"].to(dt_)))
    vv = reduce_from_model(kk @ p["cm_v"].to(dt_), axis)
    rr = torch.sigmoid((xr2 @ p["cm_r"].to(dt_)).float()).to(dt_)
    x = x + rr * vv
    return x, {"S": S1, "x_tm": a_last, "x_cm": b[:, -1]}
