"""Plain PyTorch versions of the hand-written kernels.

Each follows the semantics of the TPU kernel it stands beside (not the
looser ``repro/kernels/ref.py`` oracles): q is scaled before the product,
masked logits take the finite ``NEG_INF``, a query row that sees no live key
gives out 0 and lse ``NEG_INF``, and a paged row with ``ctx == 0`` gives
zeros.  On the CPU the dispatch in ``ops.py`` runs these; on the card
``chip_smoke.py`` holds each kernel against them.
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


def _softmax_rows(s: torch.Tensor, mask: torch.Tensor):
    """Masked softmax pieces in fp32: (p, l, m) with rows that see no live
    key giving p = 0, l = 0 and m = NEG_INF."""
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    return p, p.sum(-1), m


def flash_attention_fwd_ref(q, k, v, *, causal: bool = True, window: int = 0,
                            softcap: float = 0.0, kv_len: int = 0):
    """q: [B, S, Hq, D]; k, v: [B, S, Hkv, D] -> (out [B, S, Hq, D] in q's
    dtype, lse [B, Hq, S] fp32).  ``kv_len`` (0 = S) masks key rows at and
    past it; ``window`` > 0 keeps keys with ``q - k < window``."""
    B, S, Hq, D = q.shape
    rep = Hq // k.shape[2]
    kv_len = kv_len or S
    qf = q.float() * D ** -0.5
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = kj < kv_len
    if causal:
        mask = mask & (qi >= kj)
    if window > 0:
        mask = mask & (qi - kj < window)
    p, l, m = _softmax_rows(s, mask)
    l = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf) / l.transpose(1, 2)[..., None]
    return out.to(q.dtype), m + torch.log(l)


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
