"""The forward pass, loss and gradients of a configuration file's model,
one sequence at a time, in fp32: its family's layers
(``bench/reference/families``) over the parts they share here (norms,
RoPE with a half split, causal attention over grouped KV heads, computed
in fp32), a final norm, an untied head and the mean next-token
cross-entropy.

``prec="fp8"`` is the control: every product's operands rounded to
float8 e4m3 with one scale per tensor (the step below the configuration's
bfloat16), everything else as in fp32.  The backward's products stay
fp32."""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from bench.reference import families

FP8_MAX = 448.0


def strict_fp32() -> None:
    """fp32 products stay fp32 (no TF32) on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _Q8(torch.autograd.Function):
    """Rounds to float8 e4m3 at one scale per tensor; the gradient passes."""

    @staticmethod
    def forward(ctx, x):
        s = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s

    @staticmethod
    def backward(ctx, g):
        return g


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp8":
        a, b = _Q8.apply(a), _Q8.apply(b)
    return a @ b


def norm(conf: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    eps = conf["norm_eps"]
    if conf["norm"] == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * p["scale"]


def rope_tables(conf: dict, s: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    hd = conf["head_dim"]
    freqs = 1.0 / (conf["rope_theta"] ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                                        device=device) / hd))
    ang = torch.arange(s, dtype=torch.float32, device=device)[:, None] * freqs
    return torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]      # [S, 1, hd/2]


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _block(h: int, s: int) -> int:
    """Query rows a block, so that a block's fp32 logits stay near 1 GiB."""
    b = 1 << max(6, int(math.log2(max(2 ** 28 // (h * s), 1))))
    return min(b, s)


class Attention(torch.autograd.Function):
    """Causal attention of one sequence, q [S, Hq, hd] against k, v [S,
    Hkv, hd], a block of queries at a time (exact softmax over every live
    key); the backward recomputes each block's probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, prec):
        S, H, hd = q.shape
        rep = H // k.shape[1]
        qh = q.transpose(0, 1)
        kh = k.repeat_interleave(rep, 1).transpose(0, 1)
        vh = v.repeat_interleave(rep, 1).transpose(0, 1)
        out = torch.empty_like(qh)
        lse = torch.empty(H, S, dtype=q.dtype, device=q.device)
        bq, scale = _block(H, S), hd ** -0.5
        for i0 in range(0, S, bq):
            i1 = min(S, i0 + bq)
            s = mm(qh[:, i0:i1], kh[:, :i1].transpose(1, 2), prec) * scale
            live = torch.arange(i1, device=q.device)[None, :] <= \
                torch.arange(i0, i1, device=q.device)[:, None]
            s = s.masked_fill(~live, float("-inf"))
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            l = p.sum(-1, keepdim=True)
            out[:, i0:i1] = mm(p / l, vh[:, :i1], prec)
            lse[:, i0:i1] = (m + torch.log(l))[..., 0]
        ctx.save_for_backward(qh, kh, vh, out, lse)
        ctx.rep = rep
        return out.transpose(0, 1)

    @staticmethod
    def backward(ctx, dout):
        qh, kh, vh, out, lse = ctx.saved_tensors
        H, S, hd = qh.shape
        do = dout.transpose(0, 1)
        delta = (do * out).sum(-1)
        dq, dk, dv = torch.zeros_like(qh), torch.zeros_like(kh), torch.zeros_like(vh)
        bq, scale = _block(H, S), hd ** -0.5
        for i0 in range(0, S, bq):
            i1 = min(S, i0 + bq)
            s = qh[:, i0:i1] @ kh[:, :i1].transpose(1, 2) * scale
            live = torch.arange(i1, device=qh.device)[None, :] <= \
                torch.arange(i0, i1, device=qh.device)[:, None]
            p = torch.exp(s.masked_fill(~live, float("-inf")) - lse[:, i0:i1, None])
            dv[:, :i1] += p.transpose(1, 2) @ do[:, i0:i1]
            ds = p * (do[:, i0:i1] @ vh[:, :i1].transpose(1, 2) - delta[:, i0:i1, None])
            dq[:, i0:i1] = ds @ kh[:, :i1] * scale
            dk[:, :i1] += ds.transpose(1, 2) @ qh[:, i0:i1] * scale
        hkv = H // ctx.rep

        def fold(t):   # the query heads of a KV group summed back onto it
            return t.view(hkv, ctx.rep, S, hd).sum(1).transpose(0, 1)
        return dq.transpose(0, 1), fold(dk), fold(dv), None


def layer(conf: dict, p: dict, x: torch.Tensor, cos, sin, prec: str,
          kv: list | None = None) -> torch.Tensor:
    """One layer of the configuration's family on x [S, D]
    (``bench/reference/families``); with ``kv``, its (k, v) appended."""
    return families.of(conf).layer(conf, p, x, cos, sin, prec, kv)


def logits(conf: dict, outer: dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    """fp32 logits [T, V] of final hidden states x [T, D] (before the final norm)."""
    return mm(norm(conf, outer["final_norm"], x), outer["head"].t(), prec)


def _nll(conf, outer, x, labels, prec):
    z = logits(conf, outer, x, prec)
    return (torch.logsumexp(z, -1) - z.gather(-1, labels.long()[:, None])[:, 0]).sum()


def sequence_nll(conf: dict, params: dict, tokens: torch.Tensor, labels: torch.Tensor,
                 prec: str, tables) -> torch.Tensor:
    """Summed next-token loss of one sequence (tokens, labels [S]); every
    layer and every block of 4096 positions of the head recomputed in the
    backward."""
    x = params["embed"][tokens.long()]
    cos, sin = tables
    for p in params["layers"]:
        x = checkpoint(layer, conf, p, x, cos, sin, prec, use_reentrant=False)
    total = x.new_zeros(())
    for i in range(0, x.shape[0], 4096):
        total = total + checkpoint(_nll, conf, params, x[i:i + 4096], labels[i:i + 4096],
                                   prec, use_reentrant=False)
    return total
