"""Plain PyTorch versions of the hand-written kernels.

Each follows the semantics of the TPU kernel it stands beside (not the
looser ``repro/kernels/ref.py`` oracles): q is scaled before the product,
masked logits take the finite ``NEG_INF``, a query row that sees no live key
gives out 0 and lse ``NEG_INF``, and a paged row with ``ctx == 0`` gives
zeros.  The backward versions recompute the probabilities from the lse as
the TPU backward kernels do (rows whose lse is ``NEG_INF`` get p = 0).  On
the CPU the dispatch in ``ops.py`` runs these; on the card ``chip_smoke.py``
holds each kernel against them.
"""
from __future__ import annotations

import torch

NEG_INF = -1.0e38


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
                plus_one: bool = False) -> torch.Tensor:
    """x: [..., D]; scale: [D] (read in fp32) -> like x."""
    x32 = x.float()
    s = scale.float() + 1.0 if plus_one else scale.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * s).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, *,
                    eps: float = 1e-6, plus_one: bool = False):
    """(dx like x, dscale fp32 [D]) for ``rmsnorm_ref``'s output cotangent g."""
    x32, g32 = x.float(), g.float()
    se = scale.float() + 1.0 if plus_one else scale.float()
    D = x.shape[-1]
    r = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    gs = g32 * se
    dx = (gs - x32 * (r * r / D) * (gs * x32).sum(-1, keepdim=True)) * r
    ds = (g32 * x32 * r).reshape(-1, D).sum(0)
    return dx.to(x.dtype), ds


def _softmax_rows(s: torch.Tensor, mask: torch.Tensor):
    """Masked softmax pieces in fp32: (p, l, m) with rows that see no live
    key giving p = 0, l = 0 and m = NEG_INF."""
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    return p, p.sum(-1), m


def _mask(S: int, Sk: int, *, causal: bool, window: int, kv_len: int, device):
    """[S, Sk] live (query, key) pairs: keys below kv_len, causal, windowed."""
    qi = torch.arange(S, device=device)[:, None]
    kj = torch.arange(Sk, device=device)[None, :]
    mask = kj < kv_len
    if causal:
        mask = mask & (qi >= kj)
    if window > 0:
        mask = mask & (qi - kj < window)
    return mask


def flash_attention_fwd_ref(q, k, v, *, causal: bool = True, window: int = 0,
                            softcap: float = 0.0, kv_len: int = 0, round_p: bool = False):
    """q: [B, S, Hq, D]; k, v: [B, S, Hkv, D] -> (out [B, S, Hq, D] in q's
    dtype, lse [B, Hq, S] fp32).  ``kv_len`` (0 = S) masks key rows at and
    past it; ``window`` > 0 keeps keys with ``q - k < window``.
    ``round_p`` (off by default; for the tests) rounds p to bf16 before the
    P*V product, as the tensor-core kernel does; the row sum keeps fp32 p."""
    B, S, Hq, D = q.shape
    rep = Hq // k.shape[2]
    kv_len = kv_len or S
    qf = q.float() * D ** -0.5
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    mask = _mask(S, k.shape[1], causal=causal, window=window, kv_len=kv_len,
                 device=q.device)
    p, l, m = _softmax_rows(s, mask)
    l = torch.where(l == 0, torch.ones_like(l), l)
    pv = p.to(torch.bfloat16).float() if round_p else p
    out = torch.einsum("bhqk,bkhd->bqhd", pv, vf) / l.transpose(1, 2)[..., None]
    return out.to(q.dtype), m + torch.log(l)


def _recompute_p(q, k, lse, *, causal, window, softcap, kv_len):
    """(p, tanh term or None, fp32 q, fp32 k repeated to Hq) with p
    [B, Hq, S, S] rebuilt from the raw logits and the forward's lse."""
    B, S, Hq, D = q.shape
    rep = Hq // k.shape[2]
    qf = q.float()
    kf = k.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * D ** -0.5
    t = None
    if softcap > 0:
        t = torch.tanh(s / softcap)
        s = softcap * t
    mask = _mask(S, k.shape[1], causal=causal, window=window, kv_len=kv_len or S,
                 device=q.device)
    dead = lse <= 0.5 * NEG_INF
    lse_safe = torch.where(dead, torch.zeros_like(lse), lse)
    live = mask & ~dead[..., None]
    p = torch.where(live, torch.exp(s - lse_safe[..., None]), torch.zeros_like(s))
    return p, t, qf, kf


def _ds(p, t, do_f, v_f, delta):
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do_f, v_f) - delta[..., None])
    return ds * (1.0 - t * t) if t is not None else ds


def flash_attention_bwd_dq_ref(q, k, v, out, lse, do, *, causal: bool = True,
                               window: int = 0, softcap: float = 0.0, kv_len: int = 0,
                               round_ds: bool = False):
    """K4's function: (dq like q, delta = rowsum(dO * O) fp32 [B, Hq, S]).
    ``round_ds`` (off by default; for the tests) rounds ds to bf16 before the
    dS*K product, as the tensor-core kernel does; the sums stay fp32."""
    D = q.shape[-1]
    rep = q.shape[2] // k.shape[2]
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    p, t, _, kf = _recompute_p(q, k, lse, causal=causal, window=window,
                               softcap=softcap, kv_len=kv_len)
    ds = _ds(p, t, do.float(), v.float().repeat_interleave(rep, dim=2), delta)
    if round_ds:
        ds = ds.to(torch.bfloat16).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * D ** -0.5
    return dq.to(q.dtype), delta


def flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, *, causal: bool = True,
                                window: int = 0, softcap: float = 0.0, kv_len: int = 0):
    """K5's function: (dk, dv) like k and v, summed over each KV head's
    ``rep`` query heads; ``delta`` is K4's."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    p, t, qf, _ = _recompute_p(q, k, lse, causal=causal, window=window,
                               softcap=softcap, kv_len=kv_len)
    do_f = do.float()
    ds = _ds(p, t, do_f, v.float().repeat_interleave(rep, dim=2), delta)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * D ** -0.5
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do_f)
    group = lambda a: a.reshape(B, a.shape[1], Hkv, rep, D).sum(3)  # noqa: E731
    return group(dk).to(k.dtype), group(dv).to(v.dtype)


def adamw_ref(p, m, v, g, scalars, *, b1: float, b2: float, eps: float, wd: float):
    """K6's function, out of place: (p', m', v') in the dtypes of p, m, v.
    ``scalars`` = fp32 (lr, 1 - b1^t, 1 - b2^t, grad scale)."""
    lr, b1c, b2c, gscale = scalars.float().unbind()
    g = g.float() * gscale
    m32 = b1 * m.float() + (1 - b1) * g
    v32 = b2 * v.float() + (1 - b2) * g.square()
    mh = m32 / b1c
    vh = v32 / b2c
    p32 = p.float()
    p32 = p32 - lr * (mh / (torch.sqrt(vh) + eps) + wd * p32)
    return p32.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)


def paged_attention_ref(q, k_pool, v_pool, block_tables, context_lens, *,
                        window: int = 0, softcap: float = 0.0):
    """q: [R, Hq, D]; pools: [N, Hkv, bs, D]; block_tables: [R, max_blocks];
    context_lens: [R] live tokens (the query sits at ``ctx - 1``).  Gathers
    every table entry and masks past the context.  -> [R, Hq, D]."""
    R, Hq, D = q.shape
    _, Hkv, bs, _ = k_pool.shape
    rep = Hq // Hkv
    maxb = block_tables.shape[1]
    bt = block_tables.long()
    k = k_pool[bt].float().permute(0, 2, 1, 3, 4).reshape(R, Hkv, maxb * bs, D)
    v = v_pool[bt].float().permute(0, 2, 1, 3, 4).reshape(R, Hkv, maxb * bs, D)
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("rhd,rhkd->rhk", q.float() * D ** -0.5, k)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    pos = (context_lens.long() - 1)[:, None, None]
    k_pos = torch.arange(maxb * bs, device=q.device)[None, None, :]
    mask = k_pos <= pos
    if window > 0:
        mask = mask & (pos - k_pos < window)
    p, l, _ = _softmax_rows(s, mask)
    out = torch.einsum("rhk,rhkd->rhd", p, v) / torch.where(
        l == 0, torch.ones_like(l), l)[..., None]
    return out.to(q.dtype)


def paged_attention_split_ref(q, k_pool, v_pool, block_tables, context_lens, *,
                              keys_per_split: int, window: int = 0,
                              softcap: float = 0.0):
    """``paged_attention_ref``'s function computed as the K7 kernel does:
    the key range cut at multiples of ``keys_per_split``, each split's
    softmax state (max m, sum l, unnormalised output) taken alone, then the
    splits merged in order with weights exp(m_s - M).  -> [R, Hq, D]."""
    R, Hq, D = q.shape
    _, Hkv, bs, _ = k_pool.shape
    rep = Hq // Hkv
    maxb = block_tables.shape[1]
    n = -(-maxb * bs // keys_per_split)
    pad = n * keys_per_split - maxb * bs
    bt = block_tables.long()
    k = k_pool[bt].float().permute(0, 2, 1, 3, 4).reshape(R, Hkv, maxb * bs, D)
    v = v_pool[bt].float().permute(0, 2, 1, 3, 4).reshape(R, Hkv, maxb * bs, D)
    k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad)).repeat_interleave(rep, dim=1)
            .reshape(R, Hq, n, keys_per_split, D) for t in (k, v))
    s = torch.einsum("rhd,rhnkd->rhnk", q.float() * D ** -0.5, k)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    ctx = context_lens.long()[:, None, None, None]
    k_pos = torch.arange(n * keys_per_split, device=q.device).view(1, 1, n, keys_per_split)
    mask = (k_pos < ctx) & (k_pos < maxb * bs)
    if window > 0:
        mask = mask & (k_pos >= ctx - window)
    p, l, m = _softmax_rows(s, mask)      # per split; no live key: m NEG_INF, l 0
    acc = torch.einsum("rhnk,rhnkd->rhnd", p, v)
    w = torch.exp(m - m.amax(-1, keepdim=True))
    L = (w * l).sum(-1)
    out = (w[..., None] * acc).sum(2) / torch.where(L == 0, torch.ones_like(L), L)[..., None]
    return out.to(q.dtype)
