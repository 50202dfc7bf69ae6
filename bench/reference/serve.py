"""The reference's reading of served tokens: one fp32 forward over each
sampled request's prompt and the tokens it was served (teacher-forced),
layer by layer over the whole sample with the layer's served-precision
weights drawn again from the seed; the logits at every position that
predicted a served token, and the K and V that the reference computes at
the positions decode steps wrote to the port's cache."""
from __future__ import annotations

import torch

from bench.harness import inputs
from bench.reference import model


def _rel(a: torch.Tensor, r: torch.Tensor) -> float:
    return float((a.float() - r).norm() / r.norm().clamp(min=1e-30))


def served_logits(conf: dict, seed: int, samples: list[tuple], device,
                  precs=("fp32",), rows: list | None = None) -> dict:
    """``samples``: (prompt int array, served token list) pairs; ``precs``
    starts with "fp32".  Returns {prec: [logits [n_served, V] fp32 for each
    sample]}: row i is the distribution the reference puts on served token
    i.  ``rows``, where given, are the K and V the port's cache held for
    each sample at its decoded positions (the prompt's length on, one fewer
    than it served), [n, layers, 2, Hkv, hd].  Then, and for every
    precision but fp32, ``out["kv"][name]`` is for each sample (gap, where):
    the widest relative gap, ||a - r|| / ||r|| over those positions, between
    its K or V of a layer and the fp32 reference's, over the layers."""
    model.strict_fp32()
    dt = getattr(torch, conf["dtype"])
    seqs = [torch.tensor(list(p) + list(g[:-1]), dtype=torch.long, device=device)
            for p, g in samples]
    cos, sin = model.rope_tables(conf, max(len(s) for s in seqs), device)
    outer = inputs.outer_weights(conf, seed, device, dtype=dt)
    outer = {"embed": outer["embed"].float(), "head": outer["head"].float(),
             "final_norm": outer["final_norm"]}
    names = [pr for pr in precs if pr != "fp32"] + (["program"] if rows is not None else [])
    kv = {n: [(0.0, "") for _ in samples] for n in names}
    out: dict = {}
    with torch.no_grad():
        xs = {pr: [outer["embed"][s] for s in seqs] for pr in precs}
        for l in range(conf["num_hidden_layers"]):
            w = inputs.layer_weights(conf, seed, l, device, dtype=dt)
            w = {g: {n: t.float() for n, t in sub.items()} for g, sub in w.items()}
            held = {pr: [] for pr in precs}
            for pr in precs:
                xs[pr] = [model.layer(conf, w, x, cos, sin, pr, held[pr]) for x in xs[pr]]
            del w
            for i, (p, _) in enumerate(samples):
                n0 = len(p)
                ref = held["fp32"][i]
                other = {pr: held[pr][i] for pr in precs if pr != "fp32"}
                if rows is not None:
                    other["program"] = (rows[i][:, l, 0], rows[i][:, l, 1])
                for name, pair in other.items():
                    for part, a, r in zip("kv", pair, ref):
                        a = a if name == "program" else a[n0:]
                        gap = _rel(a, r[n0:])
                        if not gap <= kv[name][i][0]:         # NaN counts as worst
                            kv[name][i] = (gap, f"layer {l} {part}")
        for pr in precs:
            out[pr] = [model.logits(conf, outer, x[len(p) - 1:], pr)
                       for x, (p, _) in zip(xs[pr], samples)]
    if names:
        out["kv"] = kv
    return out


def gaps(logits: list, tokens: list) -> list[float]:
    """For each sample, the widest gap by which one of ``tokens``' logits
    lies below the reference's best at its position."""
    out = []
    for z, tk in zip(logits, tokens):
        t = torch.tensor(list(tk), dtype=torch.long, device=z.device)
        out.append(float((z.amax(-1) - z.gather(-1, t[:, None])[:, 0]).max()))
    return out
