"""The yardstick's arithmetic, frozen here: the chip's published peaks, the
model flops that ``mfu.*`` count, and the operations and bytes of one
attention call that the rooflines count.  Every count takes shapes only,
whatever kernel runs them.  Imports nothing of the port."""
from __future__ import annotations

from bench import families

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def product_params(conf: dict) -> int:
    """N: the parameters of every product a token passes through (every
    layer's matrices and the output head; not the embedding lookup, not
    the norms), as the configuration's family counts them."""
    return families.of(conf).product_params(conf)


def causal_pairs(s: int) -> int:
    """Live (query, key) pairs of one causal head of length ``s``."""
    return s * (s + 1) // 2


def train_step_flops(conf: dict, batch: int, seq: int) -> float:
    """Model flops of one training step: 6 N per token, plus causal
    attention at 6 S^2 Hq hd per sequence and layer (its forward's 2 S^2 Hq
    hd, the two products of S^2 / 2 pairs, times three).  Recomputation is
    not counted."""
    attn = 6 * seq * seq * conf["num_attention_heads"] * conf["head_dim"]
    return batch * (6 * product_params(conf) * seq + conf["num_hidden_layers"] * attn)


def prefill_flops(conf: dict, prompt: int) -> float:
    """Model flops of one request's prefill: 2 N per prompt token, plus
    causal attention at 2 S^2 Hq hd a layer."""
    attn = 2 * prompt * prompt * conf["num_attention_heads"] * conf["head_dim"]
    return 2 * product_params(conf) * prompt + conf["num_hidden_layers"] * attn


def decode_flops(conf: dict, context: int) -> float:
    """Model flops of one decoded token whose query sees ``context`` live
    positions: 2 N, plus 4 ctx Hq hd a layer (q.K and p.V)."""
    attn = 4 * context * conf["num_attention_heads"] * conf["head_dim"]
    return 2 * product_params(conf) + conf["num_hidden_layers"] * attn


def attention_fwd(b: int, sq: int, sk: int, hq: int, hkv: int, hd: int,
                  itemsize: int = 2) -> tuple[float, float]:
    """(flops, bytes) of one causal attention forward, q [b, sq, hq, hd]
    against k/v [b, sk, hkv, hd] (sq == sk): q.K and p.V over the live
    pairs; q, k, v read once, out written once, the fp32 row statistics
    written once."""
    flops = 4.0 * b * hq * hd * causal_pairs(sq)
    nbytes = itemsize * b * (sq * hq * hd * 2 + 2 * sk * hkv * hd) + 4 * b * hq * sq
    return flops, nbytes


def attention_bwd(b: int, sq: int, sk: int, hq: int, hkv: int, hd: int,
                  itemsize: int = 2) -> tuple[float, float]:
    """(flops, bytes) of its backward: q.K again, dO.V, and the dV, dQ and
    dK products (2.5 times the forward's); q, k, v, out, dO and the row
    statistics read once, dq, dk and dv written once."""
    flops = 10.0 * b * hq * hd * causal_pairs(sq)
    nbytes = (itemsize * b * (3 * sq * hq * hd + 2 * sk * hkv * hd)       # q, out, dO; k, v
              + 4 * b * hq * sq
              + itemsize * b * (sq * hq * hd + 2 * sk * hkv * hd))        # dq, dk, dv
    return flops, nbytes


def paged_decode_bytes(rows: int, hq: int, hkv: int, hd: int, live_tokens: int,
                       itemsize: int = 2) -> float:
    """Bytes one paged decode attention call must move: q read and the
    output written for ``rows`` slots, and K and V of the ``live_tokens``
    cached positions summed over the slots."""
    return itemsize * (2 * rows * hq * hd + 2 * live_tokens * hkv * hd)


def bound_s(flops: float, nbytes: float) -> float:
    """Least time the chip could take: the larger of the two roofs."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
