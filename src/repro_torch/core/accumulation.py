"""Gradient-accumulation schedules: standard (batch-major) vs layered
(layer-major, the paper's §3), in one process (counterpart of
``repro/core/accumulation.py``).

Both schedules compute the same gradients; they differ in loop order, which
is what moves the ZeRO collectives once the state is partitioned across
processes (once per layer instead of once per layer and micro-batch):

  standard   for each micro-batch: gather every layer, forward (each layer
             recomputed in the backward), backward, accumulate
  layered    for each layer: gather it once, forward every micro-batch,
             keep the (layer, micro-batch) boundary activations; the head's
             loss and dx per micro-batch; then for each layer in reverse:
             gather it once, recompute and back-propagate every micro-batch,
             accumulate the layer's gradient in fp32

Parameters arrive in the storage layout of ``core/partition.py`` and are
gathered to ``cfg.dtype`` copies (every leaf, norm scales included, as the
JAX package's ``gather_layer`` casts them); their gradients come back in
``cfg.dtype`` and are added to fp32 accumulators in the storage layout.
The JAX ``AccumConfig`` fields for meshes, pods, MoE and wire dtypes have no
counterpart yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import tree
from repro_torch.core import partition as zp
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig, apply_norm


@dataclasses.dataclass(frozen=True)
class AccumConfig:
    method: str = "layered"        # "standard" | "layered"
    partitioned: bool = True       # the ZeRO chunk layout
    n_microbatches: int = 1
    remat: bool = True             # standard: recompute each layer in the backward


def outer_keys(storage: dict) -> list[str]:
    return [k for k in storage if k != "layers"]


def layer_view(tree_: dict, template: dict, l: int, partitioned: bool) -> dict:
    """Full-shape fp32 views of layer ``l`` of a storage-layout tree."""
    if partitioned:
        return tree.tree_map(lambda s, shp: zp.full_view(s[l], shp[1:]),
                             tree_["layers"], template["layers"])
    return tree.tree_map(lambda s: s[l], tree_["layers"])


def outer_view(tree_: dict, template: dict, partitioned: bool) -> dict:
    """Full-shape fp32 views of the outer leaves (embed, head, final norm)."""
    keys = outer_keys(tree_)
    if partitioned:
        return tree.tree_map(zp.full_view, {k: tree_[k] for k in keys},
                             {k: template[k] for k in keys})
    return {k: tree_[k] for k in keys}


def _gather(views: dict, dtype) -> dict:
    """Compute copies in ``dtype`` that autograd differentiates against."""
    return tree.tree_map(lambda t: t.to(dtype, copy=True).requires_grad_(), views)


def _accumulate(views, grads) -> None:
    """fp32 accumulators += gradients of the compute dtype."""
    for acc, g in zip(views, grads):
        acc.add_(g)


def make_grad_fn(cfg: ModelConfig, acc: AccumConfig, template: dict) -> Callable:
    """Returns ``grad_fn(storage, batch) -> (grads like storage, metrics)``.
    ``batch`` leaves are ``[M, mb, S]`` on the storage's device; ``template``
    is ``stepfn.full_template(cfg)``."""
    if cfg.block_kind != "attn" or cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: the port trains dense attention "
                                  f"stacks only so far")
    M, L, dt = acc.n_microbatches, cfg.num_layers, cfg.torch_dtype
    windows = cfg.layer_windows()
    part = acc.partitioned

    def setup(storage, batch):
        if batch["tokens"].shape[0] != M:
            raise ValueError(f"batch has {batch['tokens'].shape[0]} micro-batches, "
                             f"the schedule {M}")
        grads = tree.tree_map(torch.zeros_like, storage)
        mbs = [{k: v[m] for k, v in batch.items()} for m in range(M)]
        inv_n = 1.0 / batch["mask"].float().sum()
        return grads, mbs, inv_n

    # ------------------------------------------------------------------
    # standard (batch-major) gradient accumulation
    # ------------------------------------------------------------------
    def standard_grad(storage, batch):
        grads, mbs, inv_n = setup(storage, batch)
        acc_views = tree.leaves(outer_view(grads, template, part)) + [
            leaf for l in range(L) for leaf in tree.leaves(layer_view(grads, template, l, part))]
        nlls = []
        for mb in mbs:
            # gathered per micro-batch, as standard ZeRO does
            outer = _gather(outer_view(storage, template, part), dt)
            layers = [_gather(layer_view(storage, template, l, part), dt) for l in range(L)]
            with torch.enable_grad():
                params = dict(outer, layers=layers)
                x = T.forward(cfg, params, mb, remat=acc.remat)
                nll = T.head_loss(cfg, params, x, mb)
                loss = nll * inv_n
            wrt = tree.leaves(outer) + [leaf for lp in layers for leaf in tree.leaves(lp)]
            _accumulate(acc_views, torch.autograd.grad(loss, wrt))
            nlls.append(nll.detach())
        return grads, _metrics(nlls, batch)

    # ------------------------------------------------------------------
    # layered (layer-major) gradient accumulation — the paper's §3
    # ------------------------------------------------------------------
    def layered_grad(storage, batch):
        grads, mbs, inv_n = setup(storage, batch)
        outer = _gather(outer_view(storage, template, part), dt)   # once per step
        g_outer = outer_view(grads, template, part)

        # forward: embed each micro-batch, then layer-major, keeping the
        # (layer, micro-batch) boundary activations
        with torch.no_grad():
            embedded = [T.embed_inputs(cfg, outer, mb) for mb in mbs]
        pos = [p for _, p in embedded]
        xs = [x for x, _ in embedded]
        ckpt = []
        for l in range(L):
            lp = _gather(layer_view(storage, template, l, part), dt)
            ckpt.append(xs)
            with torch.no_grad():
                xs = [T.apply_layer(cfg, lp, x, positions=p, window=windows[l])
                      for x, p in zip(xs, pos)]

        # head: loss and dx per micro-batch
        fn_leaves = tree.leaves(outer["final_norm"])
        head_key = "embed" if cfg.tie_embeddings else "head"
        acc_views = tree.leaves(g_outer["final_norm"]) + [g_outer[head_key]]
        wrt = fn_leaves + [outer[head_key]]
        dxs, nlls = [], []
        for mb, x in zip(mbs, xs):
            x = x.requires_grad_()
            with torch.enable_grad():
                h = apply_norm(cfg, outer["final_norm"], x)
                nll = T.head_loss(cfg, outer, h, mb)
                loss = nll * inv_n
            dx, *g = torch.autograd.grad(loss, [x] + wrt)
            _accumulate(acc_views, g)
            dxs.append(dx.to(dt))
            nlls.append(nll.detach())
        del xs

        # backward: reverse layer-major, one gather per layer
        for l in reversed(range(L)):
            lp = _gather(layer_view(storage, template, l, part), dt)
            wrt = tree.leaves(lp)
            acc_views = tree.leaves(layer_view(grads, template, l, part))
            for m in range(M):
                x_in = ckpt[l][m].requires_grad_()
                with torch.enable_grad():
                    y = T.apply_layer(cfg, lp, x_in, positions=pos[m], window=windows[l])
                dx, *g = torch.autograd.grad(y, [x_in] + wrt, dxs[m])
                _accumulate(acc_views, g)
                dxs[m] = dx
            ckpt[l] = None

        # embed backward
        for mb, dx in zip(mbs, dxs):
            with torch.enable_grad():
                x, _ = T.embed_inputs(cfg, outer, mb)
            (de,) = torch.autograd.grad(x, [outer["embed"]], dx)
            g_outer["embed"].add_(de)
        return grads, _metrics(nlls, batch)

    def _metrics(nlls, batch):
        ntok = batch["mask"].float().sum()
        return {"loss": torch.stack(nlls).sum() / ntok, "ntok": ntok,
                "aux": torch.zeros((), device=ntok.device)}

    if acc.method not in ("layered", "standard"):
        raise ValueError(f"unknown accumulation method {acc.method!r}")
    return layered_grad if acc.method == "layered" else standard_grad
