"""Everything a run is given, made from ``--seed`` alone: the weights (on
the device, one generator call per layer), the training batches and the
serving requests.  Both the port and ``bench/reference`` get these same
values; the reference makes them again from the seed rather than read the
port's copies.  Imports nothing of the port."""
from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from bench import families

# tags that keep the streams of one seed apart
_LAYER, _OUTER, _BATCH, _REQUESTS, _SAMPLE = 1, 2, 3, 4, 5


def generator(seed: int, *tags: int, device="cpu") -> torch.Generator:
    """A torch generator on ``device`` for the stream ``tags`` of ``seed``
    (any whole number, more than 32 bits too)."""
    state = np.random.SeedSequence([int(seed) % 2**64, *tags]).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return g


def numpy_rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, *tags]))


# ---------------------------------------------------------------------------
# Weights: the family's layout and the port's initialisation (matrices N(0, 1/fan_in),
# the embedding and the head N(0, 0.02^2), norms at one and zero)
# ---------------------------------------------------------------------------
def norm_params(conf: dict, device) -> dict:
    d = conf["hidden_size"]
    p = {"scale": torch.ones(d, dtype=torch.float32, device=device)}
    if conf["norm"] == "layernorm":
        p["bias"] = torch.zeros(d, dtype=torch.float32, device=device)
    return p


def layer_weights(conf: dict, seed: int, layer: int, device, dtype=torch.float32) -> dict:
    """Layer ``layer``'s parameters: matrices in ``dtype`` (the served or
    the master type), norms fp32.  One draw of every matrix element."""
    shapes = families.of(conf).matrix_shapes(conf)
    flat = torch.randn(sum(a * b for _, _, (a, b) in shapes), dtype=torch.float32,
                       device=device, generator=generator(seed, _LAYER, layer, device=device))
    out: dict = {"ln1": norm_params(conf, device), "ln2": norm_params(conf, device),
                 "attn": {}, "mlp": {}}
    off = 0
    for group, leaf, (a, b) in shapes:
        w = flat[off:off + a * b].view(a, b).mul_(1.0 / math.sqrt(a))
        out[group][leaf] = w if dtype == torch.float32 else w.to(dtype)
        off += a * b
    return out


def outer_weights(conf: dict, seed: int, device, dtype=torch.float32) -> dict:
    """The embedding and the head ([V, D] each) and the final norm."""
    v, d = conf["vocab_size"], conf["hidden_size"]
    flat = torch.randn(2 * v * d, dtype=torch.float32, device=device,
                       generator=generator(seed, _OUTER, device=device)).mul_(0.02)
    embed, head = flat.view(2, v, d).unbind(0)
    if dtype != torch.float32:
        embed, head = embed.to(dtype), head.to(dtype)
    return {"embed": embed, "head": head, "final_norm": norm_params(conf, device)}


# ---------------------------------------------------------------------------
# Training batches: uniform tokens, a fresh draw every step
# ---------------------------------------------------------------------------
def train_batch(traffic: dict, vocab: int, seed: int, step: int, device) -> dict:
    """Step ``step``'s batch, int32 ``[M, B/M, S]`` tokens, next-token
    labels and a full mask, drawn on ``device``."""
    B, S, M = traffic["global_batch"], traffic["seq_len"], traffic["n_microbatches"]
    x = torch.randint(0, vocab, (B, S + 1), device=device, dtype=torch.int64,
                      generator=generator(seed, _BATCH, step, device=device))
    tokens = x[:, :-1].reshape(M, B // M, S).to(torch.int32)
    labels = x[:, 1:].reshape(M, B // M, S).to(torch.int32)
    return {"tokens": tokens, "labels": labels, "mask": torch.ones_like(tokens)}


# ---------------------------------------------------------------------------
# Serving requests: an open loop on the wall clock
# ---------------------------------------------------------------------------
def _lognormal_quantiles(n: int, spec: dict) -> np.ndarray:
    """``n`` lengths at the midpoint quantiles of a clipped lognormal: every
    seed gets this same multiset, in its own order."""
    nd = statistics.NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    x = spec["median"] * np.exp(spec["sigma"] * z)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def requests(traffic: dict, vocab: int, seed: int, seconds: float,
             rate: float | None = None) -> list[dict]:
    """The requests due in a window of ``seconds``: ``rate * seconds`` of
    them (``traffic['rate_per_s']`` unless ``rate`` is given), Poisson gaps
    at the exponential's midpoint quantiles scaled to fill the window, and
    lognormal prompt and output lengths, in one order drawn once for every
    seed: the seed draws the prompt tokens (and the weights), never the
    work.  Each: ``{"due": s, "prompt": int32 array, "max_new": n}``, by due
    time."""
    rate = traffic["rate_per_s"] if rate is None else rate
    n = max(1, round(rate * seconds))
    order = numpy_rng(0, _REQUESTS)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps = order.permutation(gaps * (seconds / gaps.sum()))
    prompts = order.permutation(_lognormal_quantiles(n, traffic["prompt"]))
    outputs = order.permutation(_lognormal_quantiles(n, traffic["output"]))
    due = np.cumsum(gaps) - gaps[0]          # the first request is due at the start
    rng = numpy_rng(seed, _REQUESTS)
    return [{"due": float(due[i]), "max_new": int(outputs[i]),
             "prompt": rng.integers(0, vocab, int(prompts[i]), dtype=np.int64).astype(np.int32)}
            for i in range(n)]


def sample_indices(seed: int, lengths: list[int], served: list[int], min_served: int) -> list[int]:
    """Indices of a sample of requests, drawn from the seed: the longest by
    ``lengths``, then others in the seed's order until ``served`` counts at
    least ``min_served`` tokens (every request where there are fewer)."""
    if not lengths:
        return []
    order = [int(i) for i in numpy_rng(seed, _SAMPLE).permutation(len(lengths))]
    longest = int(np.argmax(lengths))
    order.remove(longest)
    out, total = [longest], served[longest]
    for i in order:
        if total >= min_served:
            break
        out.append(i)
        total += served[i]
    return sorted(out)
