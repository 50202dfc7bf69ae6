"""The dense family's layer in fp32 (or the fp8 control): pre-norm
attention (RoPE, causal, grouped KV heads) and an MLP (plain tanh-GELU or
SwiGLU)."""
from __future__ import annotations

import torch.nn.functional as F

from bench.reference.model import Attention, mm, norm, rope


def layer(conf: dict, p: dict, x, cos, sin, prec: str, kv: list | None = None):
    """One layer on x [S, D].  With ``kv``, appends the layer's (k, v)
    [S, Hkv, hd], k after RoPE: what a KV cache holds."""
    S = x.shape[0]
    hq, hkv, hd = conf["num_attention_heads"], conf["num_key_value_heads"], conf["head_dim"]
    a = p["attn"]
    h = norm(conf, p["ln1"], x)
    q = rope(mm(h, a["wq"], prec).view(S, hq, hd), cos[:S], sin[:S])
    k = rope(mm(h, a["wk"], prec).view(S, hkv, hd), cos[:S], sin[:S])
    v = mm(h, a["wv"], prec).view(S, hkv, hd)
    if kv is not None:
        kv.append((k, v))
    x = x + mm(Attention.apply(q, k, v, prec).reshape(S, hq * hd), a["wo"], prec)
    h = norm(conf, p["ln2"], x)
    m = p["mlp"]
    if conf["mlp_gated"]:
        u = F.silu(mm(h, m["w_gate"], prec)) * mm(h, m["w_up"], prec)
    else:
        u = F.gelu(mm(h, m["w_up"], prec), approximate="tanh")
    return x + mm(u, m["w_down"], prec)
