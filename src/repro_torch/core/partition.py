"""The ZeRO-3 training-state layout over the data group (counterpart of
``repro/core/partition.py``).

Every parameter leaf is stored as flat fp32 chunks ``[L?, n_model, n_data,
chunk]``: stacked layer leaves keep their leading ``L`` dim, outer leaves are
``[n_model, n_data, chunk]``.  A rank holds its own block, ``[L?, 1, 1,
chunk]``: its model shard of the leaf (the model-local leaf), flattened,
padded and cut into ``n_data`` chunks, of which it keeps chunk ``d``.

The compute path restores a (16-bit) model-local leaf with one all-gather
over the data group, cast *before* the gather so that the wire carries 16
bits, and reduces its gradient with one reduce-scatter.  How often those
two run is what layered accumulation changes (once per layer instead of once
per layer and micro-batch).

A spec names the mesh axis of each dim of a leaf, as a ``PartitionSpec``
does in the JAX package: a tuple of ``"model"``, ``"data"`` or None.

Under expert parallelism an MoE layer's expert stacks are *resident* instead:
``[L, E/D, D, F/M]`` fp32 on each rank (``expert_resident_spec``: the expert
dim over the data group, the hidden dim over the model group), never chunked,
gathered or reduce-scattered; tokens travel to them instead.

``host_partition_leaf`` / ``host_unpartition_leaf`` are the numpy forms for
all ranks at once, bit-compatible with the JAX package's; the stage-stack
functions at the end are the pipeline's layouts built on them.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.core.dist import AxisCtx


def model_dim(spec: tuple) -> int | None:
    """The dim sharded over the model group (None: replicated)."""
    return spec.index("model") if "model" in spec else None


def model_replicated(spec: tuple) -> bool:
    return "model" not in spec


def local_shape(global_shape: tuple[int, ...], spec: tuple, tp: int,
                ndata: int = 1) -> tuple[int, ...]:
    """Model-local shape of a leaf under tensor parallelism (and, for a
    resident expert stack, data-local: its ``"data"`` dim over ``ndata``)."""
    dims = list(global_shape)
    for i, ax in enumerate(spec):
        n = {"model": tp, "data": ndata}.get(ax, 1)
        if dims[i] % n:
            raise ValueError(f"{ax} width {n} does not divide dim {i} "
                             f"(size {dims[i]}) of shape {tuple(global_shape)} "
                             f"(spec {spec})")
        dims[i] //= n
    return tuple(dims)


EXPERT_LEAVES = ("w_up", "w_gate", "w_down")


def is_expert_path(path: tuple) -> bool:
    """An MoE layer's expert stacks (the expert-parallel resident set; not
    the router, not arctic's dense residual FFN)."""
    return "moe" in path and path[-1] in EXPERT_LEAVES and "dense" not in path


def expert_resident_spec(path: tuple, tp: int) -> tuple:
    """The resident layout of a stacked expert leaf: ``[L, E, D, F]`` (up,
    gate) and ``[L, E, F, D]`` (down) with the expert dim over the data
    group and the hidden dim over the model group (replicated when tp = 1,
    as every spec is)."""
    m = "model" if tp > 1 else None
    return (None, "data", m, None) if path[-1] == "w_down" else (None, "data", None, m)


def block_of(full: torch.Tensor, spec: tuple, axis: AxisCtx) -> torch.Tensor:
    """A global leaf -> this rank's block, contiguous, in its dtype: its
    share of each ``"data"`` dim and of the ``"model"`` dim (the serving
    layout, ``transformer.serve_param_specs``; the resident experts)."""
    x = full
    for i, ax in enumerate(spec):
        n, j = {"data": (axis.ndata, axis.data_index),
                "model": (axis.tp, axis.model_index)}.get(ax, (1, 0))
        if n > 1:
            if x.shape[i] % n:
                raise ValueError(f"dim {i} of {tuple(full.shape)} does not split {n} ways")
            x = x.chunk(n, i)[j]
    return x.contiguous()


def resident_shard(full: torch.Tensor, spec: tuple, axis: AxisCtx) -> torch.Tensor:
    """A global resident leaf -> this rank's block, fp32: its share of the
    ``"data"`` dim (its experts) and of the ``"model"`` dim."""
    return block_of(full, spec, axis).float()


def chunk_size(local_numel: int, n_data: int) -> int:
    return math.ceil(local_numel / n_data)


def partitioned_specs(specs: dict, *, expert_resident: bool = False, tp: int = 1,
                      span_pods: bool = False) -> dict:
    """Specs of the partitioned storage: ``(None?, model?, "data", None)``,
    or ``("pod", "data")`` in place of ``"data"`` under ``span_pods``; with
    ``expert_resident``, the expert stacks' resident specs at model width
    ``tp``.  ``specs`` is the parameter tree's (stacked layer leaves already
    carry their leading None)."""
    part = ("pod", "data") if span_pods else "data"

    def conv(path, spec):
        if expert_resident and is_expert_path(path):
            return expert_resident_spec(path, tp)
        m = None if model_replicated(spec) else "model"
        return (None, m, part, None) if path[0] == "layers" else (m, part, None)

    return tree.tree_map_with_path(conv, specs)


# ---------------------------------------------------------------------------
# Layout conversion on one rank
# ---------------------------------------------------------------------------
def model_shard(full: torch.Tensor, spec: tuple, tp: int, model_index: int) -> torch.Tensor:
    """A global leaf -> this rank's model-local leaf (itself when replicated)."""
    dim = model_dim(spec)
    if tp == 1 or dim is None:
        return full
    return full.chunk(tp, dim)[model_index].contiguous()


def partition_local(leaf_local: torch.Tensor, n_data: int, data_index: int, *,
                    stacked: bool) -> torch.Tensor:
    """Model-local leaf -> this rank's fp32 chunk ``[L?, 1, 1, chunk]`` (a
    view when the leaf is a contiguous fp32 tensor held whole)."""
    x = leaf_local.float()
    lead = (x.shape[0],) if stacked else ()
    flat = x.reshape(*lead, -1)
    c = chunk_size(flat.shape[-1], n_data)
    if c * n_data != flat.shape[-1]:
        flat = F.pad(flat, (0, c * n_data - flat.shape[-1]))
    mine = flat[..., data_index * c:(data_index + 1) * c].contiguous()
    return mine.reshape(*lead, 1, 1, c)


def full_view(chunk: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """A chunk that holds a whole model-local leaf (``n_data == 1``), or one
    layer of a stacked one -> a view of it in the leaf's shape."""
    return chunk.reshape(-1)[:math.prod(shape)].view(shape)


def gather_local(chunk: torch.Tensor, axis: AxisCtx, shape: tuple[int, ...],
                 dtype, *, rows: int | None = None, group: str = "data") -> torch.Tensor:
    """This rank's chunk (``[1, 1, chunk]``: an outer leaf, or one layer of a
    stacked one) -> the model-local leaf in ``dtype``, all-gathered over the
    partition's ``group`` (``data``, or ``part`` when the partition spans
    the pods) after the cast.  With ``rows``, ``chunk`` holds that many
    stacked layers (``[rows, ..., chunk]``) and one all-gather brings back
    ``[rows, *shape]``.  Always a fresh tensor, so the optimizer's in-place
    update never aliases it."""
    k = 1 if rows is None else rows
    lead = () if rows is None else (rows,)
    x = chunk.reshape(k, -1)
    n = math.prod(shape)
    if getattr(axis, group) is None:
        return x[:, :n].to(dtype, copy=True).reshape(*lead, *shape)
    x = x.to(dtype)
    c, size = x.shape[1], axis.zero_size(group)
    out = torch.empty(size * k * c, dtype=dtype, device=x.device)
    axis.all_gather(out, x, group)
    # rank-major [size, k, c] -> layer-major [k, size * c]
    full = out.view(size, k, c).transpose(0, 1).reshape(k, -1)
    return full[:, :n].reshape(*lead, *shape)


def scatter_grad_local(grad: torch.Tensor, axis: AxisCtx, *,
                       reduce_dtype=torch.float32, model_partial: bool = False,
                       out: torch.Tensor | None = None,
                       rows: int | None = None, group: str = "data",
                       pod_sum: bool = False) -> torch.Tensor:
    """A model-local gradient (the leaf's shape, or flat and already padded
    to ``size * chunk``) -> this rank's reduced fp32 chunk, flat
    ``[chunk]``, written into ``out`` when given.  With ``rows``, ``grad``
    holds that many stacked layers and one reduce-scatter gives ``[rows,
    chunk]``.

    Cast to ``reduce_dtype`` (the wire dtype), summed over the model group
    first when ``model_partial`` (a leaf replicated over the model group
    whose per-rank gradients are partial), then over the pod group when
    ``pod_sum`` (pods that each hold the whole partition), then padded and
    reduce-scattered over the partition's ``group`` (as ``gather_local``).
    ``grad`` itself is not changed."""
    k = 1 if rows is None else rows
    g = grad.reshape(k, -1).to(reduce_dtype)
    for name, on in (("model", model_partial), ("pod", pod_sum)):
        if on and getattr(axis, name) is not None:
            if g.data_ptr() == grad.data_ptr():
                g = g.clone()
            axis.all_reduce(g, name)
    size = axis.zero_size(group)
    c = chunk_size(g.shape[1], size)
    if g.shape[1] < c * size:
        g = F.pad(g, (0, c * size - g.shape[1]))
    if getattr(axis, group) is None:
        res = g
    else:
        if k > 1:   # layer-major [k, size * c] -> rank-major [size, k, c]
            g = g.view(k, size, c).transpose(0, 1).contiguous()
        direct = out is not None and out.dtype == reduce_dtype
        res = out if direct else torch.empty(k * c, dtype=reduce_dtype, device=g.device)
        axis.reduce_scatter(res, g, group)
    if out is None:
        return res.float().reshape(*(() if rows is None else (rows,)), c)
    if res is not out:
        out.copy_(res.reshape(out.shape))
    return out


class GatherLocal(torch.autograd.Function):
    """``gather_local`` whose backward is ``scatter_grad_local`` into the
    fp32 chunk: the transpose the JAX package gets from ``all_gather``.  The
    standard schedule gathers through it, so every layer's reduce-scatter
    runs inside each micro-batch's backward."""

    @staticmethod
    def forward(ctx, chunk, axis, shape, dtype, reduce_dtype, model_partial, group="data",
                pod_sum=False):
        ctx.axis, ctx.chunk_shape = axis, chunk.shape
        ctx.reduce_dtype, ctx.model_partial = reduce_dtype, model_partial
        ctx.group, ctx.pod_sum = group, pod_sum
        return gather_local(chunk, axis, shape, dtype, group=group)

    @staticmethod
    def backward(ctx, g):
        out = scatter_grad_local(g, ctx.axis, reduce_dtype=ctx.reduce_dtype,
                                 model_partial=ctx.model_partial, group=ctx.group,
                                 pod_sum=ctx.pod_sum)
        return out.view(ctx.chunk_shape), None, None, None, None, None, None, None


# ---------------------------------------------------------------------------
# Host-side layout conversion (numpy)
# ---------------------------------------------------------------------------
def host_partition_leaf(full: np.ndarray, tp: int, n_data: int, *, stacked: bool,
                        model_dim: int | None = None) -> np.ndarray:
    """Global full leaf -> ALL ranks' fp32 chunks ``[L?, n_model, n_data,
    chunk]``.  ``model_dim`` is the dim sharded over the model axis (None:
    replicated).  Pure reshape/pad/moveaxis, so values move bit-identically."""
    x = np.asarray(full, dtype=np.float32)
    lead = (x.shape[0],) if stacked else ()
    if tp > 1 and model_dim is not None:
        if x.shape[model_dim] % tp:
            raise ValueError(f"tp={tp} does not divide dim {model_dim} of shape "
                             f"{x.shape}")
        x = x.reshape(*x.shape[:model_dim], tp, x.shape[model_dim] // tp,
                      *x.shape[model_dim + 1:])
        x = np.moveaxis(x, model_dim, len(lead))
        n_model = tp
    else:
        x = x.reshape(*lead, 1, *x.shape[len(lead):])
        n_model = 1
    flat = x.reshape(*lead, n_model, -1)
    c = chunk_size(flat.shape[-1], n_data)
    flat = np.pad(flat, [(0, 0)] * (flat.ndim - 1) + [(0, c * n_data - flat.shape[-1])])
    return flat.reshape(*lead, n_model, n_data, c)


def host_unpartition_leaf(chunks: np.ndarray, global_shape: tuple[int, ...], tp: int,
                          *, stacked: bool, model_dim: int | None = None) -> np.ndarray:
    """The exact inverse of ``host_partition_leaf`` (drops the chunk padding,
    keeps the chunks' dtype)."""
    x = np.asarray(chunks)
    lshape = list(global_shape)
    if tp > 1 and model_dim is not None:
        lshape[model_dim] //= tp
    lead = tuple(lshape[:1]) if stacked else ()
    body = tuple(lshape[1:]) if stacked else tuple(lshape)
    n_model = x.shape[1] if stacked else x.shape[0]
    flat = x.reshape(*lead, n_model, -1)[..., :math.prod(body)]
    loc = flat.reshape(*lead, n_model, *body)
    if n_model > 1 and model_dim is not None:
        return np.moveaxis(loc, len(lead), model_dim).reshape(global_shape)
    return loc.reshape(global_shape)


# ---------------------------------------------------------------------------
# Pipeline stage stacks (numpy; counterparts of the JAX package's
# ``core/pipeline.py`` layout functions)
# ---------------------------------------------------------------------------
def to_stage_stack(layers: dict, spec) -> dict:
    """Global ``[L, ...]`` layer stacks -> ``[S, K, ...]``: slot ``[s, v*k_c
    + j]`` holds global layer ``(v*S + s)*k_c + j``, the tick tables' chunk
    placement (the contiguous blocks for V = 1, round-robin columns for
    modular).  ``spec`` is a ``schedules.PipeSpec``."""
    S, K = spec.n_stages, spec.layers_per_stage
    V, k_c = spec.n_chunks, spec.layers_per_chunk

    def conv(x):
        x = np.asarray(x)
        rest = x.shape[1:]
        return x.reshape(V, S, k_c, *rest).swapaxes(0, 1).reshape(S, K, *rest)

    return tree.tree_map(conv, layers)


def from_stage_stack(stages: dict, spec) -> dict:
    """The inverse of ``to_stage_stack``."""
    S, K = spec.n_stages, spec.layers_per_stage
    V, k_c = spec.n_chunks, spec.layers_per_chunk

    def conv(x):
        x = np.asarray(x)
        rest = x.shape[2:]
        return x.reshape(S, V, k_c, *rest).swapaxes(0, 1).reshape(S * K, *rest)

    return tree.tree_map(conv, stages)


def _stage_model_dim(lspec) -> int | None:
    """The model dim of a stacked ``[N, ...]`` leaf from its one-layer spec."""
    dim = None if lspec is None else model_dim(lspec)
    return None if dim is None else dim + 1


def to_partitioned_stage_stack(layers: dict, spec, n_data: int, *,
                               lspecs: dict | None = None, tp: int = 1) -> dict:
    """Global ``[L, ...]`` layer stacks -> ``[S, K, n_model, n_data, chunk]``
    fp32 ZeRO chunks: slot ``[s, k, m, d, :]`` holds data chunk ``d`` of model
    shard ``m`` of the layer ``to_stage_stack`` puts at ``[s, k]``.
    ``lspecs`` (``transformer.layer_specs(cfg, tp)``) names each leaf's model
    dim; without it every leaf is replicated over the model group."""
    S, K = spec.n_stages, spec.layers_per_stage
    staged = to_stage_stack(layers, spec)

    def conv(x, lspec):
        flat = host_partition_leaf(x.reshape(S * K, *x.shape[2:]), tp, n_data,
                                   stacked=True, model_dim=_stage_model_dim(lspec))
        return flat.reshape(S, K, *flat.shape[1:])

    if lspecs is None:
        return tree.tree_map(lambda x: conv(x, None), staged)
    return tree.tree_map(conv, staged, lspecs)


def from_partitioned_stage_stack(chunks: dict, spec, layer_shapes: dict, *,
                                 lspecs: dict | None = None, tp: int = 1) -> dict:
    """The exact inverse of ``to_partitioned_stage_stack`` (drops the chunk
    padding).  ``layer_shapes`` holds one layer's global shape per leaf."""
    S, K = spec.n_stages, spec.layers_per_stage

    def conv(c, shape, lspec):
        c = np.asarray(c)
        x = host_unpartition_leaf(c.reshape(S * K, *c.shape[2:]), (S * K, *shape), tp,
                                  stacked=True, model_dim=_stage_model_dim(lspec))
        return x.reshape(S, K, *shape)

    if lspecs is None:
        staged = tree.tree_map(lambda c, shp: conv(c, shp, None), chunks, layer_shapes)
    else:
        staged = tree.tree_map(conv, chunks, layer_shapes, lspecs)
    return from_stage_stack(staged, spec)
