"""The train step and the training-state construction (counterpart of
``repro/core/stepfn.py``), in one process: no mesh, no ``shard_map`` and no
``jit`` — ``build_train_step`` returns a plain function that runs eagerly
on the storage's device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import tree
from repro_torch.core import partition as zp
from repro_torch.core.accumulation import AccumConfig, layer_view, make_grad_fn
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adam import AdamConfig, adam_step


def full_template(cfg: ModelConfig) -> dict:
    """The shapes of the JAX parameter tree (layers stacked on a leading
    ``[L]`` dim) for a dense attention stack."""
    d, hd, f, L = cfg.d_model, cfg.head_dim, cfg.d_ff, cfg.num_layers
    norm = ({"scale": (d,), "bias": (d,)} if cfg.norm == "layernorm"
            else {"scale": (d,)})
    mlp = {"w_up": (d, f), "w_down": (f, d)}
    if cfg.glu:
        mlp["w_gate"] = (d, f)
    layer = {"ln1": norm, "ln2": norm, "mlp": mlp,
             "attn": {"wq": (d, cfg.num_heads * hd), "wk": (d, cfg.num_kv_heads * hd),
                      "wv": (d, cfg.num_kv_heads * hd), "wo": (cfg.num_heads * hd, d)}}
    out = {"embed": (cfg.vocab_size, d), "final_norm": dict(norm),
           "layers": tree.tree_map(lambda s: (L, *s), layer)}
    if not cfg.tie_embeddings:
        out["head"] = (cfg.vocab_size, d)
    return out


def storage_from_params(params: dict, *, partitioned: bool) -> dict:
    """A full fp32 parameter tree (layers stacked) -> the storage layout."""
    if not partitioned:
        return params
    out = {k: tree.tree_map(lambda t: zp.partition(t, stacked=False), v)
           for k, v in params.items() if k != "layers"}
    out["layers"] = tree.tree_map(lambda t: zp.partition(t, stacked=True),
                                  params["layers"])
    return out


def init_storage(cfg: ModelConfig, seed: int, *, partitioned: bool,
                 device="cuda") -> dict:
    """Random fp32 master weights from ``seed``, drawn on ``device`` one layer
    at a time into the stacked leaves, in the storage layout.  (The JAX and
    torch generators differ; tests that compare the packages convert the JAX
    tree with ``convert.storage_from_numpy`` instead.)"""
    fcfg = dataclasses.replace(cfg, dtype=cfg.param_dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    tmpl = full_template(cfg)
    layers = tree.tree_map(lambda s: torch.empty(s, dtype=torch.float32, device=device),
                           tmpl["layers"])
    outer = T.init_params(dataclasses.replace(fcfg, num_layers=0), gen, device)
    for l in range(cfg.num_layers):
        one = T.init_layer(fcfg, gen, device)
        tree.tree_map(lambda buf, t: buf[l].copy_(t), layers, one)
    params = dict({k: v for k, v in outer.items() if k != "layers"}, layers=layers)
    return storage_from_params(params, partitioned=partitioned)


def gather_params(cfg: ModelConfig, storage: dict, *, partitioned: bool) -> dict:
    """Storage -> the model's parameter dict (a list of layers, every leaf in
    ``cfg.dtype`` as the JAX package gathers it), for eval or serving."""
    tmpl = full_template(cfg)
    outer = {k: storage[k] for k in storage if k != "layers"}
    if partitioned:
        outer = tree.tree_map(lambda s, shp: zp.gather(s, shp, cfg.torch_dtype), outer,
                              {k: tmpl[k] for k in outer})
    else:
        outer = tree.tree_map(lambda s: s.to(cfg.torch_dtype, copy=True), outer)
    layers = [tree.tree_map(lambda t: t.to(cfg.torch_dtype, copy=True),
                            layer_view(storage, tmpl, l, partitioned))
              for l in range(cfg.num_layers)]
    return dict(outer, layers=layers)


def sq_reduce(grads: dict) -> torch.Tensor:
    """Sum of squares over a gradient tree in storage layout (the global
    norm's square; one process, so no collective)."""
    return sum(g.float().square().sum() for g in tree.leaves(grads))


def build_train_step(cfg: ModelConfig, acc: AccumConfig, opt_cfg: AdamConfig):
    """Returns ``step(storage, opt, batch) -> (storage, opt, metrics)``.
    ``batch`` leaves are ``[M, B/M, S]`` (on any device: they are moved to
    the storage's).  The storage and the optimizer state are updated in
    place.  The fused one-pass AdamW (K6 on the card) updates the flat fp32
    chunks of the partitioned layout; the full-leaf layout keeps the
    tree-map update, as the JAX package does."""
    grad_fn = make_grad_fn(cfg, acc, full_template(cfg))

    def step(storage, opt, batch):
        device = storage["embed"].device
        batch = {k: v.to(device) for k, v in batch.items()}
        grads, metrics = grad_fn(storage, batch)
        storage, opt, om = adam_step(opt_cfg, storage, opt, grads,
                                     sq_reduce=sq_reduce, fused=acc.partitioned)
        return storage, opt, dict(metrics, **om)

    return step
