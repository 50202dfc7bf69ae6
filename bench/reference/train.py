"""The reference's first training steps: the cell's batches and weights
drawn again from the seed, the mean loss's gradients in fp32, the global
norm's clip and AdamW as the cell's optimizer settings state them.  What it
returns is what the harness reads from the port: each step's loss, each
leaf's norm of the first gradient as the optimizer takes it, and each
leaf's norm of the change of the weights over the steps."""
from __future__ import annotations

import math

import torch

from bench.harness import inputs
from bench.reference import model


def _leaves(params: dict):
    """(name, tensor) of every parameter, by the port's leaf names."""
    for k in ("embed", "head"):
        yield k, params[k]
    for n, t in params["final_norm"].items():
        yield f"final_norm.{n}", t
    for l, p in enumerate(params["layers"]):
        for g, sub in p.items():
            for n, t in sub.items():
                yield f"layers.{l}.{g}.{n}", t


def initial_params(conf: dict, seed: int, device) -> dict:
    outer = inputs.outer_weights(conf, seed, device)
    return dict(outer, layers=[inputs.layer_weights(conf, seed, l, device)
                               for l in range(conf["num_hidden_layers"])])


def lr_at(opt: dict, t: int) -> float:
    """The optimizer's schedule: linear warm-up, then cosine to
    ``min_lr_ratio`` of the peak, at step count ``t``, in fp32 as stated."""
    warm = min(t / max(opt["warmup_steps"], 1), 1.0)
    frac = min(max((t - opt["warmup_steps"]) / max(opt["decay_steps"], 1), 0.0), 1.0)
    cos = opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * 0.5 * (1 + math.cos(math.pi * frac))
    return float(torch.tensor(opt["lr"] * warm * cos, dtype=torch.float32))


def run(conf: dict, opt: dict, traffic: dict, seed: int, steps: int, device,
        prec: str = "fp32", rows: str = "all") -> dict:
    """``steps`` reference steps.  ``rows="half"`` is a fault: each step
    takes the first half of its rows, the mean over those."""
    model.strict_fp32()
    params = initial_params(conf, seed, device)
    named = list(_leaves(params))
    for _, t in named:
        t.requires_grad_()
    m = [torch.zeros_like(t) for _, t in named]
    v = [torch.zeros_like(t) for _, t in named]
    tables = model.rope_tables(conf, traffic["seq_len"], device)
    S, V = traffic["seq_len"], conf["vocab_size"]
    out = {"loss": []}
    for step in range(steps):
        batch = inputs.train_batch(traffic, V, seed, step, device)
        tokens, labels = batch["tokens"].reshape(-1, S), batch["labels"].reshape(-1, S)
        if rows == "half":
            tokens, labels = tokens[:len(tokens) // 2], labels[:len(labels) // 2]
        ntok = tokens.numel()
        total = 0.0
        for tk, lb in zip(tokens, labels):
            nll = model.sequence_nll(conf, params, tk, lb, prec, tables)
            (nll / ntok).backward()
            total += float(nll.detach())
        out["loss"].append(total / ntok)
        with torch.no_grad():
            grads = [t.grad for _, t in named]
            gnorm = torch.sqrt(sum(g.square().sum() for g in grads) + 1e-16)
            gscale = torch.clamp(opt["grad_clip"] / gnorm, max=1.0) if opt["grad_clip"] > 0 \
                else torch.ones_like(gnorm)
            t = step + 1
            lr, b1, b2 = lr_at(opt, t), opt["b1"], opt["b2"]
            b1c, b2c = 1 - b1 ** t, 1 - b2 ** t
            if step == 0:
                out["grad_norm"] = {n: float((g * gscale).norm()) for (n, _), g in zip(named, grads)}
            for (_, p), mi, vi, g in zip(named, m, v, grads):
                g = g * gscale
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                p.sub_(lr * (mi / b1c / (torch.sqrt(vi / b2c) + opt["eps"])
                             + opt["weight_decay"] * p))
                p.grad = None
    del m, v
    with torch.no_grad():
        start = initial_params(conf, seed, device)
        out["change"] = {n: float((t - t0).norm()) for (n, t), (_, t0)
                         in zip(named, _leaves(start))}
    return out
