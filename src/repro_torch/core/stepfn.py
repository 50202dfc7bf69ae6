"""The train steps and the training-state construction (counterpart of
``repro/core/stepfn.py``), for one rank of a (stage x) data x model grid of
processes (``core/dist.py``): no mesh, no ``shard_map`` and no ``jit`` — each
``build_*`` returns a plain function that runs eagerly on the storage's
device, on this rank's chunks and this rank's rows of the batch.  With
``axis=dist.LOCAL`` (the default) it is the one-process step.  The
``*pipeline*`` functions are the pipelined path's (``core/pipeline.py``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import tree
from repro_torch.core import partition as zp
from repro_torch.core import pipeline as pp
from repro_torch.core.accumulation import AccumConfig, make_grad_fn, outer_keys
from repro_torch.core.dist import LOCAL, AxisCtx, with_expert_group, with_seq_group
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.obs import trace as obs_trace
from repro_torch.optim.adam import AdamConfig, adam_update, global_norm, leaf_update, step_scalars


def _mlp_template(cfg: ModelConfig, d: int, f: int) -> dict:
    mlp = {"w_up": (d, f), "w_down": (f, d)}
    if cfg.glu:
        mlp["w_gate"] = (d, f)
    return mlp


def _layer_template(cfg: ModelConfig, norm: dict) -> dict:
    """One layer's shapes (unstacked)."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.block_kind == "rwkv":
        inner = cfg.rwkv_inner
        return {"rwkv": {"ln1": (d,), "ln2": (d,), "w_bias": (inner,),
                         "u_bonus": (cfg.rwkv_heads, cfg.ssm_head_dim), "mix": (5, d),
                         "w_time_out": (inner, d), "cm_mix": (2, d), "cm_k": (d, f),
                         "cm_v": (f, d), "cm_r": (d, d),
                         **{k: (d, inner) for k in ("w_r", "w_k", "w_v", "w_g", "w_w")}}}
    if cfg.block_kind == "mamba":
        heads, st = f // cfg.ssm_head_dim, cfg.ssm_state
        return {"ln1": norm, "mamba": {
            "w_x": (d, f), "w_z": (d, f), "w_B": (d, st), "w_C": (d, st),
            "w_dt": (d, heads), "dt_bias": (heads,), "A_log": (heads,),
            "D_skip": (heads,), "w_out": (f, d)}}
    return {"ln1": norm, "ln2": norm, "attn": _attn_template(cfg)}


def _attn_template(cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    return {"wq": (d, cfg.num_heads * hd), "wk": (d, cfg.num_kv_heads * hd),
            "wv": (d, cfg.num_kv_heads * hd), "wo": (cfg.num_heads * hd, d)}


def full_template(cfg: ModelConfig) -> dict:
    """The shapes of the JAX parameter tree (layers stacked on a leading
    ``[L]`` dim; a hybrid's ``shared`` block, whose empty subtree the other
    stacks drop)."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    norm = ({"scale": (d,), "bias": (d,)} if cfg.norm == "layernorm"
            else {"scale": (d,)})
    layer = _layer_template(cfg, norm)
    if cfg.is_moe:
        e = cfg.num_experts
        moe = {"router": (d, e), **{k: (e, *shp) for k, shp in _mlp_template(cfg, d, f).items()}}
        if cfg.moe_dense_residual:
            moe["dense"] = _mlp_template(cfg, d, cfg.moe_dense_ff or f)
        layer["moe"] = moe
    elif cfg.block_kind == "attn":
        layer["mlp"] = _mlp_template(cfg, d, f)
    out = {"embed": (cfg.vocab_size, d), "final_norm": dict(norm),
           "layers": tree.tree_map(lambda s: (L, *s), layer)}
    if cfg.hybrid_attn_period > 0:
        out["shared"] = {"ln1": dict(norm), "attn": _attn_template(cfg), "ln2": dict(norm),
                         "mlp": _mlp_template(cfg, d, f)}
    if not cfg.tie_embeddings:
        out["head"] = (cfg.vocab_size, d)
    return out


def storage_specs(cfg: ModelConfig, axis: AxisCtx, partitioned: bool, *,
                  expert_resident: bool = False, span_pods: bool = False) -> dict:
    """The storage layout's specs: the parameter tree's, or the chunks' (with
    the expert stacks' resident specs under ``expert_resident``; over
    ``("pod", "data")`` under ``span_pods`` on a grid with pods)."""
    full = T.param_specs(cfg, axis.tp)
    if not partitioned:
        return full
    return zp.partitioned_specs(full, expert_resident=expert_resident and cfg.is_moe,
                                tp=axis.tp,
                                span_pods=axis.zero_group(span_pods) == "part")


def storage_from_params(cfg: ModelConfig, params: dict, *, partitioned: bool,
                        axis: AxisCtx = LOCAL, expert_resident: bool = False,
                        span_pods: bool = False) -> dict:
    """A global fp32 parameter tree (layers stacked) -> this rank's storage:
    its model shard of every leaf, and of that its chunk when
    ``partitioned`` (chunk ``d`` of the data group, or ``p * ndata + d`` of
    the pod x data ranks under ``span_pods``; views where the rank holds a
    contiguous leaf whole); under ``expert_resident``, its block of each
    expert stack, whole."""
    group = axis.zero_group(span_pods)
    n, i = axis.zero_size(group), axis.zero_index(group)

    def conv(path, t, spec):
        if expert_resident and zp.is_expert_path(path):
            return zp.resident_shard(t, zp.expert_resident_spec(path, axis.tp), axis)
        local = zp.model_shard(t, spec, axis.tp, axis.model_index)
        if not partitioned:
            return local
        return zp.partition_local(local, n, i, stacked=path[0] == "layers")
    return tree.tree_map_with_path(conv, params, T.param_specs(cfg, axis.tp))


def init_storage(cfg: ModelConfig, seed: int, *, partitioned: bool, device="cuda",
                 axis: AxisCtx = LOCAL, expert_resident: bool = False,
                 span_pods: bool = False) -> dict:
    """Random fp32 master weights from ``seed``, drawn on ``device``, in this
    rank's storage layout.  Every rank draws the same full weights, one layer
    at a time, and keeps its share.  ``expert_resident`` (with
    ``partitioned``): the expert stacks in their resident layout, as
    expert parallelism trains them; ``span_pods``: the chunks cut over the
    pod x data ranks.  (The JAX and torch generators differ;
    tests that compare the packages convert the JAX tree with
    ``convert.storage_from_numpy`` instead.)"""
    if expert_resident and cfg.is_moe and not partitioned:
        raise ValueError("resident experts need the partitioned layout")
    ep = expert_resident and cfg.is_moe
    fcfg = dataclasses.replace(cfg, dtype=cfg.param_dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    outer = T.init_params(dataclasses.replace(fcfg, num_layers=0), gen, device)
    outer = storage_from_params(cfg, {k: v for k, v in outer.items() if k != "layers"},
                                partitioned=partitioned, axis=axis, span_pods=span_pods)
    layers = None
    for l in range(cfg.num_layers):
        one = storage_from_params(cfg, {"layers": tree.tree_map(
            lambda t: t[None], T.init_layer(fcfg, gen, device))}, partitioned=partitioned,
            axis=axis, expert_resident=ep, span_pods=span_pods)["layers"]
        if layers is None:
            layers = tree.tree_map(lambda t: torch.empty((cfg.num_layers, *t.shape[1:]),
                                                         dtype=torch.float32, device=device),
                                   one)
        tree.tree_map(lambda buf, t: buf[l].copy_(t[0]), layers, one)
    return dict(outer, layers=layers)


def gather_params(cfg: ModelConfig, storage: dict, *, partitioned: bool,
                  axis: AxisCtx = LOCAL) -> dict:
    """Storage -> the model's parameter dict (this rank's model shards, a
    list of layers, every leaf in ``cfg.dtype`` as the JAX package gathers
    it), for eval or serving."""
    specs = T.param_specs(cfg, axis.tp)
    shapes = tree.tree_map(lambda shp, sp: zp.local_shape(shp, sp, axis.tp),
                           full_template(cfg), specs)
    dt = cfg.torch_dtype

    def get(s, shp):
        if partitioned:
            return zp.gather_local(s, axis, shp, dt)
        return s.to(dt, copy=True)

    outer = {k: tree.tree_map(get, storage[k], shapes[k]) for k in outer_keys(storage)}
    lshapes = tree.tree_map(lambda s: s[1:], shapes["layers"])
    layers = [tree.tree_map(lambda s, shp: get(s[l], shp), storage["layers"], lshapes)
              for l in range(cfg.num_layers)]
    return dict(outer, layers=layers)


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------
def sq_reduce(grads: dict) -> torch.Tensor:
    """Sum of squares over a gradient tree on this rank (no collective)."""
    return sum(g.float().square().sum() for g in tree.leaves(grads))


def make_sq_reduce(cfg: ModelConfig, axis: AxisCtx, partitioned: bool, *,
                   expert_resident: bool = False, span_pods: bool = False):
    """The global norm's square over a gradient tree in this rank's storage
    layout: model-sharded leaves summed over the model group, then, when the
    state is partitioned, everything over the data group, and the pod group
    too when the partition spans the pods (a resident expert stack's share
    counted once: each data rank holds its own experts).  The
    JAX package's resident sum adds the experts' share over the data group
    twice, so its norm under expert parallelism is larger (ROADMAP.md §3)."""
    specs = T.param_specs(cfg, axis.tp)
    if expert_resident and cfg.is_moe:
        specs = tree.tree_map_with_path(
            lambda path, sp: (zp.expert_resident_spec(path, axis.tp)
                              if zp.is_expert_path(path) else sp), specs)

    def reduce(grads: dict) -> torch.Tensor:
        pairs = tree.leaves(tree.tree_map(lambda g, sp: (g, sp), grads,
                                          {k: specs[k] for k in grads}))
        repl = {i: g for i, (g, sp) in enumerate(pairs)
                if axis.model is None or zp.model_replicated(sp)}
        tot = sq_reduce(repl)
        shard = {i: g for i, (g, _) in enumerate(pairs) if i not in repl}
        if shard:
            s = sq_reduce(shard)
            axis.all_reduce(s, "model")
            tot = tot + s
        if partitioned and axis.data is not None:
            axis.all_reduce(tot, "data")
            if axis.zero_group(span_pods) == "part":
                axis.all_reduce(tot, "pod")
        return tot

    return reduce


def _on_device(storage: dict, batch: dict) -> dict:
    device = storage["embed"].device
    return {k: v.to(device) for k, v in batch.items()}


def _gated_update(c: AdamConfig, storage: dict, opt: dict, grads: dict, metrics: dict, *,
                  reduce, fused, gate):
    """The global norm, then ``gate(loss, grad_norm)`` (when given), then
    the update: a step the gate refuses writes nothing, neither the
    storage, nor the moments, nor the step count, and its metrics say
    ``skipped``.  The JAX package's functional step keeps the pre-step state
    instead; the port updates in place, so the gate sits before the first
    write.  The span ``step.update`` of the active tracer covers it."""
    with obs_trace.span("update", cat="step", device=opt["step"].device):
        gnorm, gscale = global_norm(c, grads, sq_reduce=reduce, device=opt["step"].device)
        if gate is not None and not gate(metrics["loss"], gnorm):
            lr, _, _ = step_scalars(c, opt["step"] + 1)
            return storage, opt, dict(metrics, lr=lr, grad_norm=gnorm, skipped=True)
        storage, opt, om = adam_update(c, storage, opt, grads, gscale, fused=fused)
    return storage, opt, dict(metrics, **om, grad_norm=gnorm)


def _step_parts(step, grad_fn, sq_reduce, fused):
    """``step`` with its parts as attributes, for a check that holds one
    part at a time: ``grad_fn(storage, batch) -> (grads, metrics)``, and
    the update's ``sq_reduce`` and ``fused`` (``optim.adam.global_norm``'s
    and ``adam_update``'s arguments); ``step`` is the one, then the other."""
    step.grad_fn, step.sq_reduce, step.fused = grad_fn, sq_reduce, fused
    return step


def build_train_step(cfg: ModelConfig, acc: AccumConfig, opt_cfg: AdamConfig, *,
                     axis: AxisCtx = LOCAL, gate=None):
    """Returns ``step(storage, opt, batch) -> (storage, opt, metrics)``.
    ``batch`` leaves are this rank's rows, ``[M, B/(M * dp), S]`` for ``dp``
    data ranks over the pods (``data.synthetic.local_rows``), on any device:
    they are moved to the storage's.  The storage (``init_storage`` with
    ``acc``'s ``span_pods``) and the optimizer state are updated in place.
    The fused one-pass AdamW (K6 on the card) updates the flat fp32 chunks of
    the partitioned layout; the full-leaf layout keeps the tree-map update,
    as the JAX package does.  ``gate(loss, grad_norm) -> bool``, when given,
    is asked after the global norm and before the update (the supervisor's
    anomaly gate, ``_gated_update``); without it the step makes no extra
    host sync.  The step's parts are its attributes (``_step_parts``)."""
    if acc.expert_parallel and cfg.is_moe:
        axis = with_expert_group(axis)
    grad_fn = make_grad_fn(cfg, acc, full_template(cfg), axis=axis)
    reduce = make_sq_reduce(cfg, axis, acc.partitioned,
                            expert_resident=acc.expert_parallel, span_pods=acc.span_pods)

    def step(storage, opt, batch):
        grads, metrics = grad_fn(storage, _on_device(storage, batch))
        return _gated_update(opt_cfg, storage, opt, grads, metrics, reduce=reduce,
                             fused=acc.partitioned, gate=gate)

    return _step_parts(step, grad_fn, reduce, acc.partitioned)


def build_fused_train_step(cfg: ModelConfig, acc: AccumConfig, opt_cfg: AdamConfig, *,
                           axis: AxisCtx = LOCAL):
    """Layered training with the paper's §C.3 fused per-layer update: each
    layer's AdamW (K6 on the card, on that layer's slice of every leaf) runs
    the moment its gradient is reduce-scattered inside the backward, so the
    stacked fp32 layer-gradient buffer is never allocated.  The global norm
    is known only after the last layer, so ``grad_clip`` clips each leaf
    (each layer's slice of it, on this rank) by its own norm, as the JAX
    package does; the metrics' grad_norm is 0.  Same interface as
    ``build_train_step``."""
    if acc.method != "layered":
        raise ValueError("the fused update requires the layered schedule")
    if acc.expert_parallel and cfg.is_moe:
        axis = with_expert_group(axis)
    tmpl = full_template(cfg)
    c = opt_cfg

    def step(storage, opt, batch):
        stp = opt["step"] + 1
        lr, b1c, b2c = step_scalars(c, stp)
        scalars = torch.stack([lr, b1c, b2c, torch.ones_like(lr)]).float()

        def upd(p, m, v, g):
            leaf_update(c, p, m, v, g, scalars)

        def layer_update(l, dw):
            for p, m, v, g in zip(tree.leaves(storage["layers"]),
                                  tree.leaves(opt["mu"]["layers"]),
                                  tree.leaves(opt["nu"]["layers"]), tree.leaves(dw)):
                upd(p[l], m[l], v[l], g)

        grad_fn = make_grad_fn(cfg, acc, tmpl, axis=axis, layer_update=layer_update)
        outer_grads, metrics = grad_fn(storage, _on_device(storage, batch))
        # the outer leaves (embed, head, final norm, a hybrid's shared block)
        # are updated after the step
        for k, g in outer_grads.items():
            for p, m, v, gg in zip(tree.leaves(storage[k]), tree.leaves(opt["mu"][k]),
                                   tree.leaves(opt["nu"][k]), tree.leaves(g)):
                upd(p, m, v, gg)
        metrics = dict(metrics, lr=lr, grad_norm=torch.zeros((), device=lr.device))
        return storage, dict(opt, step=stp), metrics

    return step


# ---------------------------------------------------------------------------
# The dense-cache serving steps
# ---------------------------------------------------------------------------
def serve_axis(cfg: ModelConfig, axis: AxisCtx = LOCAL, *, seq_shard: bool = False) -> AxisCtx:
    """The groups the serving steps run over: ``axis``, with the data group
    as the expert group for an MoE config that has more than one data rank
    (its experts spread over it, ``transformer.serve_param_specs``), and as
    the seq group under ``seq_shard`` (``dist.with_seq_group``; without a
    data group the cache is one shard).  As the JAX package's builders set
    ``expert`` and ``seq``."""
    if cfg.is_moe and axis.ndata > 1:
        axis = with_expert_group(axis)
    return with_seq_group(axis) if seq_shard else axis


def cache_specs(cfg: ModelConfig, axis: AxisCtx = LOCAL, *, seq_shard: bool = False) -> dict:
    """The dense cache's layout (the JAX package's placements), keys as
    ``transformer.init_cache``'s: rows over the data group, KV heads and
    recurrent heads over the model group; under ``seq_shard`` the KV slots'
    sequence dim over the data group instead and every row on every rank;
    the sliding-window rings split by rows only, never by sequence."""
    dp = "data" if axis.data is not None else None
    m = "model" if axis.tp > 1 else None
    rows = None if seq_shard else dp
    specs: dict = {"pos": ()}
    if cfg.num_attn_slots() > 0:
        kv = (None, None, m, dp, None) if seq_shard else (None, dp, m, None, None)
        specs.update(k=kv, v=kv)
        if cfg.has_window_cache:
            specs.update(kw=(None, rows, m, None, None), vw=(None, rows, m, None, None))
    if cfg.block_kind == "mamba":
        specs["ssm"] = (None, rows, m, None, None)
    elif cfg.block_kind == "rwkv":
        specs["ssm"] = {"S": (None, rows, m, None, None), "x_tm": (None, rows, None),
                        "x_cm": (None, rows, None)}
    return specs


def shard_cache(cfg: ModelConfig, cache: dict, axis: AxisCtx = LOCAL, *,
                seq_shard: bool = False) -> dict:
    """A whole cache (``transformer.init_cache`` of every row and position,
    one process) -> this rank's block of it by ``cache_specs``, for a
    serving run that starts from a filled cache.  A KV head replicated over
    the model group (fewer KV heads than model ranks) is this rank's copy
    of its GQA group's head."""
    specs = cache_specs(cfg, axis, seq_shard=seq_shard)
    rep = attn_mod.local_counts(cfg, axis.tp)[2] if cfg.num_attn_slots() else False

    def cut(path, t, sp):
        if rep and path[0] in ("k", "v", "kw", "vw"):
            kv = attn_mod.replicated_kv_head(cfg, axis)
            t, sp = t[:, :, kv:kv + 1], tuple(None if a == "model" else a for a in sp)
        return zp.block_of(t, sp, axis)

    out = tree.tree_map_with_path(cut, {k: v for k, v in cache.items() if k != "pos"},
                                  {k: v for k, v in specs.items() if k != "pos"})
    return dict(out, pos=cache["pos"])


def build_serve_step(cfg: ModelConfig, *, axis: AxisCtx = LOCAL, seq_shard: bool = False):
    """Returns ``serve(params, cache, tokens [B]) -> (logits [B, V], cache)``:
    one greedy-decode step against the dense cache (``transformer.decode_step``,
    the cache updated in place) on this rank's rows (every row under
    ``seq_shard``) and its block of the weights
    (``transformer.serve_param_specs``); the logits' vocabulary is whole on
    every rank.  The cache is ``transformer.init_cache(cfg, rows, max_seq,
    serve_axis(cfg, axis, seq_shard=seq_shard))``."""
    axis = serve_axis(cfg, axis, seq_shard=seq_shard)

    def serve(params, cache, tokens):
        return T.decode_step(cfg, params, cache, tokens, axis)

    return serve


def build_prefill_step(cfg: ModelConfig, *, axis: AxisCtx = LOCAL):
    """Returns ``prefill(params, cache, batch) -> (logits [B, V], cache)``
    (``transformer.prefill_step`` on this rank's rows: the KV cache written
    for positions [0, S), the recurrent states to their end state)."""
    axis = serve_axis(cfg, axis)

    def prefill(params, cache, batch):
        return T.prefill_step(cfg, params, cache, batch, axis)

    return prefill


# ---------------------------------------------------------------------------
# The pipelined path
# ---------------------------------------------------------------------------
def _stage_slot(spec, l: int) -> tuple[int, int]:
    """Global layer ``l`` -> (owning stage, slot in its ``[K]`` stack)."""
    S, k_c = spec.n_stages, spec.layers_per_chunk
    g = l // k_c
    return g % S, (g // S) * k_c + l % k_c


def init_pipeline_storage(cfg: ModelConfig, seed: int, spec, *, partitioned: bool,
                          device="cuda", axis: AxisCtx = LOCAL) -> dict:
    """Random fp32 master weights from ``seed`` in this rank's pipeline
    storage (``spec`` a ``schedules.PipeSpec``): its stage's layers as
    ``[K, chunk]`` ZeRO chunks when ``partitioned`` (its block ``[s, :, m,
    d, :]`` of ``partition.to_partitioned_stage_stack``), else ``[K, ...]``
    model shards; the outer leaves whole (model shards), never chunked.  The
    weights are ``init_storage``'s for the same seed: every rank draws every
    layer, in order, and keeps its own."""
    fcfg = dataclasses.replace(cfg, dtype=cfg.param_dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    specs = T.param_specs(cfg, axis.tp)
    outer = T.init_params(dataclasses.replace(fcfg, num_layers=0), gen, device)
    outer = tree.tree_map(lambda t, sp: zp.model_shard(t, sp, axis.tp, axis.model_index),
                          {k: v for k, v in outer.items() if k != "layers"},
                          {k: v for k, v in specs.items() if k != "layers"})
    lspecs = T.layer_specs(cfg, axis.tp)
    K = spec.layers_per_stage
    layers = None
    for l in range(cfg.num_layers):
        one = T.init_layer(fcfg, gen, device)
        stage, k = _stage_slot(spec, l)
        if stage != axis.stage_index:
            continue
        one = tree.tree_map(lambda t, sp: zp.model_shard(t, sp, axis.tp, axis.model_index),
                            one, lspecs)
        if partitioned:
            one = tree.tree_map(lambda t: zp.partition_local(
                t[None], axis.ndata, axis.data_index, stacked=True).reshape(-1), one)
        if layers is None:
            layers = tree.tree_map(lambda t: torch.empty((K, *t.shape), dtype=torch.float32,
                                                         device=device), one)
        tree.tree_map(lambda buf, t: buf[k].copy_(t), layers, one)
    return dict(outer, layers=layers)


def gather_pipeline_params(cfg: ModelConfig, storage: dict, spec, *, partitioned: bool,
                           axis: AxisCtx) -> dict:
    """Pipeline storage -> the model's parameter dict on every rank (its
    model shards, every layer in order, every leaf in ``cfg.dtype``), for
    eval or serving: each layer gathered over the data group on its stage,
    then broadcast over the stage group."""
    specs = T.param_specs(cfg, axis.tp)
    shapes = tree.tree_map(lambda shp, sp: zp.local_shape(shp, sp, axis.tp),
                           full_template(cfg), specs)
    lshapes = tree.tree_map(lambda s: s[1:], shapes["layers"])
    dt = cfg.torch_dtype
    outer = {k: tree.tree_map(lambda t: t.to(dt, copy=True), storage[k])
             for k in outer_keys(storage)}
    layers = []
    for l in range(cfg.num_layers):
        stage, k = _stage_slot(spec, l)

        def one(st, shp):
            if stage != axis.stage_index:
                x = torch.empty(shp, dtype=dt, device=st.device)
            elif partitioned:
                x = zp.gather_local(st[k], axis, shp, dt)
            else:
                x = st[k].to(dt, copy=True)
            axis.broadcast(x, "stage", axis.stage_ranks[stage])
            return x
        layers.append(tree.tree_map(one, storage["layers"], lshapes))
    return dict(outer, layers=layers)


def make_pipeline_sq_reduce(cfg: ModelConfig, axis: AxisCtx, partitioned: bool):
    """The global norm's square over a pipeline gradient tree: model-sharded
    leaves summed over the model group; the layer leaves' share summed over
    the data group (when partitioned) and the stage group; the outer leaves,
    which every stage holds whole and equal, counted once."""
    specs = T.param_specs(cfg, axis.tp)

    def split(grads: dict, specs: dict):
        shard = repl = torch.zeros((), device=tree.leaves(grads)[0].device)
        for g, sp in zip(tree.leaves(grads), tree.leaves(specs)):
            sq = g.float().square().sum()
            if axis.model is None or zp.model_replicated(sp):
                repl = repl + sq
            else:
                shard = shard + sq
        return shard, repl

    def reduce(grads: dict) -> torch.Tensor:
        o_shard, o_repl = split({k: v for k, v in grads.items() if k != "layers"},
                                {k: v for k, v in specs.items() if k != "layers"})
        l_shard, l_repl = split(grads["layers"], specs["layers"])
        shard = torch.stack([o_shard, l_shard])
        if axis.model is not None:
            axis.all_reduce(shard, "model")
        layers = shard[1] + l_repl
        if partitioned:
            axis.all_reduce(layers, "data")
        axis.all_reduce(layers, "stage")
        return shard[0] + o_repl + layers

    return reduce


def build_pipeline_train_step(cfg: ModelConfig, spec, opt_cfg: AdamConfig, *,
                              partitioned: bool, axis: AxisCtx, gate=None, table=None):
    """Returns ``step(storage, opt, batch) -> (storage, opt, metrics)`` of the
    pipelined path (the paper's full method when ``partitioned``) for this
    rank of a stage x data x model grid: any executable schedule, run by
    ``spec``'s tick table.  Storage from ``init_pipeline_storage``;
    ``batch`` leaves are this rank's rows, ``[M, B/(M * n_data), S]``, the
    same on every stage.  The one-pass AdamW (K6 on the card) updates the
    partitioned layer chunks; the outer leaves, and replicated layers, take
    the tree-map update, as in the JAX package.  ``gate`` as in
    ``build_train_step``; ``table``, the tick table to run (a plan's),
    ``spec.tick_table()`` when not given.  The step's parts are its
    attributes (``_step_parts``)."""
    grad_fn = pp.make_pipeline_grad_fn(cfg, spec, full_template(cfg), partitioned=partitioned,
                                       axis=axis, table=table)
    reduce = make_pipeline_sq_reduce(cfg, axis, partitioned)
    fused = (lambda path: path[0] == "layers") if partitioned else False

    def step(storage, opt, batch):
        grads, metrics = grad_fn(storage, _on_device(storage, batch))
        return _gated_update(opt_cfg, storage, opt, grads, metrics, reduce=reduce,
                             fused=fused, gate=gate)

    return _step_parts(step, grad_fn, reduce, fused)
