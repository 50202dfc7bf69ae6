"""JAX parameter pytree -> the port's parameters, through numpy.

The JAX tree (``repro.models.transformer.init_params``) stacks the layers on
a leading ``[L, ...]`` dim; pass it with numpy leaves (for example
``jax.tree.map(np.asarray, params)``).  ``params_from_numpy`` makes the
serving parameters (or a rank's block of them):
matrices in ``cfg.dtype``; norm parameters, an MoE router and the
recurrent blocks' vectors (``ssm.FP32_LEAVES``) fp32, as
``transformer.init_params`` makes them; a hybrid's ``shared`` block likewise.
``storage_from_numpy``
makes the fp32 training storage (MoE expert stacks ``[L, E, D, F]`` chunked,
or resident under expert parallelism), ``pipeline_storage_from_numpy`` a
pipeline stage's.
The tests use these to give both packages the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as ptree
from repro_torch.core import partition as zp
from repro_torch.core.dist import LOCAL, AxisCtx
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.models.ssm import FP32_LEAVES


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32)).to(device=device, dtype=dtype)


def _layer_dtype(path: tuple, dt: torch.dtype) -> torch.dtype:
    """A layer (or shared-block) leaf's serving dtype: fp32 for the norms,
    the router and the recurrent blocks' vectors."""
    fp32 = (path[0] in ("ln1", "ln2") or path[-1] == "router"
            or (path[0] in ("rwkv", "mamba") and path[-1] in FP32_LEAVES))
    return torch.float32 if fp32 else dt


def params_from_numpy(cfg: ModelConfig, tree: dict, device="cpu",
                      axis: AxisCtx = LOCAL) -> dict:
    """The JAX parameter tree -> the serving parameters; with a group
    ``axis``, this rank's block of every leaf by
    ``transformer.serve_param_specs`` (the vocabulary, heads and hidden dims
    over the model group; an MoE layer's experts over the data group too)."""
    dt = cfg.torch_dtype
    specs = T.serve_param_specs(cfg, axis.tp)

    def cut(a, spec, dtype):
        return zp.block_of(torch.tensor(np.asarray(a, np.float32)), spec,
                           axis).to(device=device, dtype=dtype)

    def layer(i):
        return ptree.tree_map_with_path(
            lambda path, a, sp: cut(a[i], sp[1:], _layer_dtype(path, dt)),
            tree["layers"], specs["layers"])

    params = {"embed": cut(tree["embed"], specs["embed"], dt),
              "layers": [layer(i) for i in range(cfg.num_layers)],
              "final_norm": ptree.tree_map(lambda a, sp: cut(a, sp, torch.float32),
                                           tree["final_norm"], specs["final_norm"])}
    if tree.get("shared"):
        params["shared"] = ptree.tree_map_with_path(
            lambda path, a, sp: cut(a, sp, _layer_dtype(path, dt)), tree["shared"],
            specs["shared"])
    if not cfg.tie_embeddings:
        params["head"] = cut(tree["head"], specs["head"], dt)
    return params


def storage_from_numpy(cfg: ModelConfig, tree: dict, *, partitioned: bool,
                       device="cpu", axis: AxisCtx = LOCAL,
                       expert_resident: bool = False, span_pods: bool = False) -> dict:
    """The JAX parameter tree -> this rank's fp32 training storage, so both
    packages start a step from the same weights: when ``partitioned``, the
    rank's chunks ``[L?, 1, 1, chunk]`` (block ``[..., m, d, :]`` of
    ``partition.host_partition_leaf``), else its model shard of each leaf;
    under ``expert_resident``, its block ``[L, E/D, D, F/M]`` of each expert
    stack (``partition.expert_resident_spec``).  The other stacks' empty
    ``shared`` subtree is dropped; a hybrid's is an outer leaf, chunked (or
    model-sharded) like the embedding.  Under ``span_pods`` the chunks are
    cut over the pod x data ranks (block ``[..., m, p * ndata + d, :]``)."""
    group = axis.zero_group(span_pods)
    n, d = axis.zero_size(group), axis.zero_index(group)

    def conv(path, a, spec):
        a = np.asarray(a, np.float32)
        if expert_resident and zp.is_expert_path(path):
            return zp.resident_shard(torch.tensor(a), zp.expert_resident_spec(
                path, axis.tp), axis).to(device)
        dim = zp.model_dim(spec)
        if not partitioned:
            local = a if dim is None else np.split(a, axis.tp, dim)[axis.model_index]
            return _tensor(local, torch.float32, device)
        chunks = zp.host_partition_leaf(a, axis.tp, n, stacked=path[0] == "layers",
                                        model_dim=dim)
        m = axis.model_index if chunks.shape[-3] > 1 else 0
        return _tensor(chunks[..., m:m + 1, d:d + 1, :], torch.float32, device)

    return ptree.tree_map_with_path(conv, {k: v for k, v in tree.items()
                                           if k != "shared" or v},
                                    T.param_specs(cfg, axis.tp))


def pipeline_storage_from_numpy(cfg: ModelConfig, tree: dict, spec, *, partitioned: bool,
                                axis: AxisCtx = LOCAL, device="cpu") -> dict:
    """The JAX parameter tree -> this rank's fp32 pipeline storage
    (``spec`` a ``core.schedules.PipeSpec``): the layers of its stage, as
    ``[K, chunk]`` block ``[s, :, m, d, :]`` of
    ``partition.to_partitioned_stage_stack`` when ``partitioned``, else its
    model shard of ``[s]`` of ``partition.to_stage_stack``, ``[K, ...]``; the
    outer leaves (a hybrid's ``shared`` block among them) in full (their
    model shards), never chunked, as the JAX package's
    ``partitioned_stage_param_specs`` keeps them."""
    specs = T.param_specs(cfg, axis.tp)
    lspecs = T.layer_specs(cfg, axis.tp)
    s, d = axis.stage_index, axis.data_index

    def shard(a, dim):
        return a if dim is None else np.split(a, axis.tp, dim)[axis.model_index]

    if partitioned:
        chunks = zp.to_partitioned_stage_stack(tree["layers"], spec, axis.ndata,
                                               lspecs=lspecs, tp=axis.tp)

        def layer(c):
            m = axis.model_index if c.shape[2] > 1 else 0
            return _tensor(c[s, :, m, d], torch.float32, device)
        layers = ptree.tree_map(layer, chunks)
    else:
        staged = zp.to_stage_stack(tree["layers"], spec)
        layers = ptree.tree_map(
            lambda a, sp: _tensor(shard(a[s], zp.model_dim(sp)), torch.float32, device),
            staged, specs["layers"])
    outer = {k: ptree.tree_map(lambda a, sp: _tensor(shard(np.asarray(a, np.float32),
                                                           zp.model_dim(sp)),
                                                     torch.float32, device), v, specs[k])
             for k, v in tree.items() if k != "layers" and (k != "shared" or v)}
    return dict(outer, layers=layers)
