"""Gradient-accumulation schedules: standard (batch-major) vs layered
(layer-major, the paper's §3), over the data and model process groups of an
``AxisCtx`` (counterpart of ``repro/core/accumulation.py``).

Both schedules compute the same gradients; they differ in loop order and so
in where the ZeRO collectives of the data group land:

  standard   for each micro-batch: gather the outer leaves and every layer,
             forward (each layer recomputed, and re-gathered, in the
             backward), backward with one reduce-scatter per layer leaf
             -> 3 * L * M data-group collectives per layer leaf and step
  layered    for each layer: gather it once, forward every micro-batch,
             keep the (layer, micro-batch) boundary activations; the head's
             loss and dx per micro-batch; then for each layer in reverse:
             gather it once, recompute and back-propagate every micro-batch,
             reduce-scatter its gradient once
             -> 3 * L per layer leaf (the paper's fig. 2); the outer leaves
             are gathered once and scattered once per step

With replicated storage the same loop inversion spreads the gradient sum
(one all-reduce per leaf at the end of the standard schedule) over the
backward, one all-reduce per layer leaf as its layer ends (fig. 1).

Parameters arrive in the storage layout of ``core/partition.py`` (this
rank's chunks) and are gathered to ``cfg.dtype`` model-local copies (every
leaf, norm scales included, as the JAX package's ``gather_layer`` casts
them); the batch arrives as this rank's rows, ``[M, mb_local, S]``.
Without groups (``dist.LOCAL``) a gather is a cast and a reduction hands
back the fp32 accumulators in the storage layout.  Under expert parallelism
(``AccumConfig.expert_parallel``) an MoE layer's expert stacks are resident:
a gather is a cast and the gradient stays on the rank, no collective at all.

A hybrid's ``shared`` block (one parameter set applied after several layers)
is an outer leaf: gathered with the embedding, handed to every layer whose
flag is set, its gradient summed over those layers and the micro-batches in
one fp32 accumulator and reduced once with the other outer leaves (the JAX
package's ``dshared_acc`` carry).  In the standard schedule autograd sums its
uses across the checkpointed layers; in the layered one each flagged layer's
recompute takes it as an input of its backward.

Each phase of either schedule is a span of the thread's active tracer
(``obs.trace.active``; nothing without one), timed on the card too:
``accum.gather`` (the outer leaves once, each layer once a pass),
``accum.forward``, ``accum.head``, ``accum.backward`` (a layer's recompute
and back-propagation of every micro-batch), ``accum.add`` (a micro-batch's
gradients into the fp32 accumulators; the first of a layer also makes them),
``accum.reduce`` (a layer's, then the outer leaves') and
``accum.embed_grad``.  The standard schedule has them per micro-batch; its
gathers of partitioned leaves run inside its forward and backward.

An MoE layer also returns the router's load-balance loss.  It enters the
loss as ``router_aux_weight * aux / (M * L * D)`` a layer and micro-batch
(D data ranks), as in the JAX package: the standard schedule adds it to each
micro-batch's loss, the layered one gives each layer's backward that
cotangent beside ``dx``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.core import partition as zp
from repro_torch.core.dist import LOCAL, AxisCtx
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig, apply_norm
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass(frozen=True)
class AccumConfig:
    method: str = "layered"        # "standard" | "layered"
    partitioned: bool = True       # ZeRO-3 partition over the data group
    n_microbatches: int = 1
    remat: bool = True             # standard: recompute each layer in the backward
    reduce_dtype: str = "float32"  # the reduce-scatter's wire dtype
    # MoE expert stacks resident in their compute layout (the expert dim over
    # the data group, tokens sent to them by all-to-all) instead of ZeRO chunks
    expert_parallel: bool = False
    # partition the state over (pod, data) instead of data alone: the paper's
    # slow-interconnect scenario (§8.3); without it the pods each hold the
    # whole partition and the gradients are summed over the pod group first
    span_pods: bool = False


# ROADMAP.md §3, known reference failures
EP_PODS_REFUSAL = ("expert parallelism with pods is not ported: the JAX package's "
                   "expert-parallel step does not trace on a pod mesh (its out_specs need a "
                   "replication it cannot infer), so there is no reference to hold it to")


def outer_keys(storage: dict) -> list[str]:
    return [k for k in storage if k != "layers"]


# ---------------------------------------------------------------------------
# Gather / reduce adapters (partitioned vs replicated storage)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Adapters:
    """How the storage layout turns into compute copies and gradients go
    back into it.  ``outer_shapes`` / ``layer_shapes`` are model-local
    shapes (a layer's without its stacking dim); ``partial`` names the
    layer leaves whose per-rank gradients are partial over the model
    group; ``resident``, whether the expert stacks are resident (expert
    parallelism: no gather, no reduction); ``group``, the partition's group
    (``data``, or ``part`` when it spans the pods); ``pod_sum``, whether a
    gradient is summed over the pod group before its reduce-scatter (pods
    that each hold the whole partition)."""

    cfg: ModelConfig
    axis: AxisCtx
    partitioned: bool
    reduce_dtype: torch.dtype
    outer_shapes: dict
    layer_shapes: dict
    partial: frozenset
    resident: bool = False
    group: str = "data"
    pod_sum: bool = False

    def _chunk(self, leaf: torch.Tensor, shape, dtype, path=()) -> torch.Tensor:
        if self.partitioned and not (self.resident and zp.is_expert_path(path)):
            return zp.gather_local(leaf, self.axis, shape, dtype, group=self.group)
        return leaf.to(dtype, copy=True)

    def gather_outer(self, storage: dict) -> dict:
        """Compute copies of the outer leaves, requiring grad."""
        return {k: tree.tree_map(lambda s, shp: self._chunk(s, shp, self.cfg.torch_dtype)
                                 .requires_grad_(), storage[k], self.outer_shapes[k])
                for k in outer_keys(storage)}

    def gather_layer(self, storage: dict, l: int) -> dict:
        """Compute copies of layer ``l``, requiring grad: one all-gather per
        leaf when partitioned (a cast of a resident expert stack)."""
        return tree.tree_map_with_path(
            lambda path, s, shp: self._chunk(s[l], shp, self.cfg.torch_dtype, path)
            .requires_grad_(), storage["layers"], self.layer_shapes)

    def gather_ad(self, chunks: dict, shapes: dict, layer: bool) -> dict:
        """Differentiable compute copies of partitioned ``chunks`` (which
        require grad): a gather whose backward is the reduce-scatter into
        the fp32 chunk; a resident expert stack's is a cast."""
        dt, rdt = self.cfg.torch_dtype, self.reduce_dtype

        def one(path, s, shp):
            if layer and self.resident and zp.is_expert_path(path):
                return s.to(dt)
            return zp.GatherLocal.apply(s, self.axis, shp, dt, rdt,
                                        layer and path in self.partial, self.group,
                                        self.pod_sum)
        return tree.tree_map_with_path(one, chunks, shapes)

    def accumulators(self, shapes: dict, device) -> dict:
        """fp32 zeros in the model-local ``shapes``, that the gradients of
        the micro-batches are summed into."""
        return tree.tree_map(lambda shp: torch.zeros(shp, dtype=torch.float32, device=device),
                             shapes)

    def reduce(self, accs: dict, layer: bool, out: dict | None = None) -> dict:
        """The accumulated gradients summed over the groups, in the storage
        layout: this rank's fp32 chunks ``[1, 1, chunk]`` (one reduce-scatter
        over the partition's group per leaf), or replicated leaves (``accs``
        all-reduced in place over the data group, then the pod group).
        Written into ``out`` when given; without groups, and replicated,
        ``accs`` themselves otherwise."""
        def one(path, a, o):
            partial = layer and path in self.partial
            if layer and self.resident and zp.is_expert_path(path):
                return a if o is None else o.copy_(a)    # the rank's own experts
            if self.partitioned:
                g = zp.scatter_grad_local(a, self.axis, reduce_dtype=self.reduce_dtype,
                                          model_partial=partial,
                                          out=None if o is None else o.view(-1),
                                          group=self.group, pod_sum=self.pod_sum)
                return g.view(1, 1, -1) if o is None else o
            if partial and self.axis.model is not None:
                self.axis.all_reduce(a, "model")
            self.axis.all_reduce_dp(a)
            return a if o is None else o.copy_(a)

        if out is None:
            return tree.tree_map_with_path(lambda path, a: one(path, a, None), accs)
        return tree.tree_map_with_path(one, accs, out)


def make_adapters(cfg: ModelConfig, axis: AxisCtx, acc: AccumConfig,
                  template: dict) -> Adapters:
    resident = acc.expert_parallel and cfg.is_moe
    specs = T.param_specs(cfg, axis.tp)

    def local(path, shp, sp):
        if resident and zp.is_expert_path(path):
            return zp.local_shape(shp, zp.expert_resident_spec(path, axis.tp), axis.tp,
                                  axis.ndata)
        return zp.local_shape(shp, sp, axis.tp)

    local = tree.tree_map_with_path(local, template, specs)
    group = axis.zero_group(acc.span_pods)
    return Adapters(cfg=cfg, axis=axis, partitioned=acc.partitioned,
                    reduce_dtype=getattr(torch, acc.reduce_dtype),
                    outer_shapes={k: v for k, v in local.items() if k != "layers"},
                    layer_shapes=tree.tree_map(lambda s: s[1:], local["layers"]),
                    partial=T.model_partial_leaves(cfg, axis.tp), resident=resident,
                    group=group, pod_sum=group == "data" and axis.pod is not None)


def _phase(name: str, device: torch.device, **args):
    """The span ``accum.<name>`` of the active tracer, timed on ``device``."""
    return obs_trace.span(name, cat="accum", device=device, **args)


def _accumulate(accs, grads) -> None:
    """fp32 accumulators += gradients (of any dtype; None: an unused leaf)."""
    for a, g in zip(accs, grads):
        if g is not None:
            a.add_(g)


# ---------------------------------------------------------------------------
# The gradient functions
# ---------------------------------------------------------------------------
def make_grad_fn(cfg: ModelConfig, acc: AccumConfig, template: dict, *,
                 axis: AxisCtx = LOCAL, layer_update: Callable | None = None) -> Callable:
    """Returns ``grad_fn(storage, batch) -> (grads like storage, metrics)``.
    ``batch`` leaves are this rank's ``[M, mb_local, S]`` on the storage's
    device; ``template`` is ``stepfn.full_template(cfg)``.

    ``layer_update`` (layered only): the paper's §C.3 "update the weights as
    soon as possible", called as ``layer_update(l, dw)`` right after layer
    ``l``'s gradient is reduced, with ``dw`` this rank's fp32 gradient of
    the layer in the storage layout (``storage["layers"]`` leaves at ``[l]``).
    The stacked layer-gradient buffer is then never allocated, and the
    returned grads hold the outer leaves only."""
    if acc.expert_parallel and cfg.is_moe and not acc.partitioned:
        raise ValueError("expert parallelism needs the partitioned layout: replicated "
                         "storage sums every leaf's gradient over the data group, "
                         "whose ranks hold different experts")
    if acc.expert_parallel and cfg.is_moe and axis.pods:
        raise ValueError(EP_PODS_REFUSAL)
    if acc.method not in ("layered", "standard"):
        raise ValueError(f"unknown accumulation method {acc.method!r}")
    if layer_update is not None and acc.method != "layered":
        raise ValueError("the per-layer update needs the layered schedule")
    ad = make_adapters(cfg, axis, acc, template)
    M, L = acc.n_microbatches, cfg.num_layers
    windows, flags = cfg.layer_windows(), cfg.attn_layer_flags()
    part = acc.partitioned
    head_key = "embed" if cfg.tie_embeddings else "head"
    # each layer's and micro-batch's aux, weighted into the loss (JAX's
    # aux_w * aux_scale: the mean over micro-batches, layers and the
    # (pod, data) ranks)
    aux_ct = cfg.router_aux_weight / (M * L * axis.dp)

    def setup(batch):
        if batch["labels"].shape[0] != M:
            raise ValueError(f"batch has {batch['labels'].shape[0]} micro-batches, "
                             f"the schedule {M}")
        ntok = batch["mask"].float().sum()
        axis.all_reduce_dp(ntok)                   # the global token count
        return [{k: v[m] for k, v in batch.items()} for m in range(M)], 1.0 / ntok

    def layer_dest(grads_l, l):
        return tree.tree_map(lambda g: g[l], grads_l)

    def metrics(nlls, aux, batch):
        """``aux``: this rank's (None: no router), the JAX package's mean
        over the (pod, data) ranks reported."""
        nll = torch.stack(nlls).sum()
        t = torch.stack([nll, batch["mask"].float().sum(),
                         torch.zeros_like(nll) if aux is None else aux])
        axis.all_reduce_dp(t)
        return {"loss": t[0] / t[1], "ntok": t[1], "aux": t[2] / axis.dp}

    def add_aux(total, a):
        if a is None:
            return total
        return a.detach() if total is None else total + a.detach()

    # ------------------------------------------------------------------
    # standard (batch-major) gradient accumulation
    # ------------------------------------------------------------------
    def standard_grad(storage, batch):
        mbs, inv_n = setup(batch)
        device = storage["embed"].device
        grads = None
        okeys = outer_keys(storage)

        def leaf(s):
            """What autograd differentiates against: the fp32 chunk itself
            (gathered inside the graph), or a cast copy of a replicated leaf."""
            if part:
                return s.detach().requires_grad_()
            return s.to(cfg.torch_dtype, copy=True).requires_grad_()

        def layer_fn(lp_in, shared, x, pos, w, fl):
            lp = ad.gather_ad(lp_in, ad.layer_shapes, layer=True) if part else lp_in
            return T.apply_layer(cfg, lp, x, positions=pos, window=w, axis=axis,
                                 shared=shared, shared_flag=fl)

        nlls, auxs = [], None
        for m, mb in enumerate(mbs):
            # gathered per micro-batch, as standard ZeRO does; the layers
            # inside the (recomputed) layer function
            with _phase("gather", device, microbatch=m):
                outer_in = {k: tree.tree_map(leaf, storage[k]) for k in okeys}
                layers_in = [tree.tree_map(lambda s: leaf(s[l]), storage["layers"])
                             for l in range(L)]
            with _phase("forward", device, microbatch=m), torch.enable_grad():
                outer = (ad.gather_ad(outer_in, ad.outer_shapes, layer=False) if part
                         else outer_in)
                x, pos = T.embed_inputs(cfg, outer, mb, axis)
                shared = outer.get("shared")
                aux = None
                for l in range(L):
                    args = (layers_in[l], shared, x, pos, windows[l], flags[l])
                    if acc.remat:
                        x, a = checkpoint(layer_fn, *args, use_reentrant=False)
                    else:
                        x, a = layer_fn(*args)
                    aux = a if aux is None else aux + a
                x = apply_norm(cfg, outer["final_norm"], x)
                nll = T.head_loss(cfg, outer, x, mb, axis)
                loss = nll * inv_n
                if aux is not None:
                    loss = loss + aux * aux_ct
            wrt = tree.leaves(outer_in) + [t for lp in layers_in for t in tree.leaves(lp)]
            with _phase("backward", device, microbatch=m):
                # frame embeddings leave the embedding unused: its gradient stays 0
                g = torch.autograd.grad(loss, wrt, allow_unused=True)
            with _phase("add", device, microbatch=m):
                if grads is None:
                    grads = tree.tree_map(torch.zeros_like, storage)
                dests = tree.leaves({k: grads[k] for k in okeys}) + [
                    t for l in range(L) for t in tree.leaves(layer_dest(grads["layers"], l))]
                _accumulate(dests, g)
            del g
            nlls.append(nll.detach())
            auxs = add_aux(auxs, aux)
        if not part:   # one sum per leaf over the data group, at the end
            with _phase("reduce", device, layer="outer"):
                g_outer = ad.reduce({k: grads[k] for k in okeys}, layer=False)
            with _phase("reduce", device, layer="layers"):
                grads = dict(g_outer, layers=ad.reduce(grads["layers"], layer=True))
        # the JAX package's aux metric here: the micro-batches' mean of the
        # layers' sum
        return grads, metrics(nlls, None if auxs is None else auxs / M, batch)

    # ------------------------------------------------------------------
    # layered (layer-major) gradient accumulation — the paper's §3
    # ------------------------------------------------------------------
    def shard_ckpt(S: int) -> bool:
        """Keep each (layer, micro-batch) checkpoint sharded over the model
        group along the sequence, all-gathered back in the backward."""
        return axis.model is not None and axis.tp > 1 and S % axis.tp == 0

    def ckpt_slice(x):
        """Keep this rank's share of the sequence of a checkpoint, a copy:
        with one row the share is a contiguous view, which would keep the
        whole activation alive."""
        if not shard_ckpt(x.shape[-2]):
            return x
        c = x.shape[-2] // axis.tp
        return x[..., axis.model_index * c:(axis.model_index + 1) * c, :].clone(
            memory_format=torch.contiguous_format)

    def ckpt_restore(ck, S):
        """The whole sequence back, all-gathered over the model group."""
        if not shard_ckpt(S):
            return ck
        out = torch.empty((axis.tp, *ck.shape), dtype=ck.dtype, device=ck.device)
        axis.all_gather(out, ck, "model")
        return out.movedim(0, -3).reshape(*ck.shape[:-2], S, ck.shape[-1])

    def layered_grad(storage, batch):
        mbs, inv_n = setup(batch)
        device = storage["embed"].device
        with _phase("gather", device, layer="outer"):
            outer = ad.gather_outer(storage)        # gathered once per step
        shared = outer.get("shared")
        a_outer = ad.accumulators(ad.outer_shapes, device)
        # the stacked layer gradients (none with the per-layer update), each
        # element written by a layer's reduction
        grads_l = (None if layer_update is not None
                   else tree.tree_map(torch.empty_like, storage["layers"]))

        # forward: embed each micro-batch, then layer-major, keeping the
        # (layer, micro-batch) boundary activations
        with torch.no_grad():
            embedded = [T.embed_inputs(cfg, outer, mb, axis) for mb in mbs]
        pos = [p for _, p in embedded]
        xs = [x for x, _ in embedded]
        del embedded          # the inputs live on in ckpt[0] only
        S = xs[0].shape[-2]
        ckpt = []
        aux_total = None
        for l in range(L):
            with _phase("gather", device, layer=l, phase="forward"):
                lp = ad.gather_layer(storage, l)    # one gather per layer
            with _phase("forward", device, layer=l), torch.no_grad():
                ckpt.append([ckpt_slice(x) for x in xs])
                for m in range(M):
                    xs[m], a = T.apply_layer(cfg, lp, xs[m], positions=pos[m],
                                             window=windows[l], axis=axis, shared=shared,
                                             shared_flag=flags[l])
                    aux_total = add_aux(aux_total, a)
            del lp

        # head: loss and dx per micro-batch
        wrt = tree.leaves(outer["final_norm"]) + [outer[head_key]]
        accs = tree.leaves(a_outer["final_norm"]) + [a_outer[head_key]]
        dxs, nlls = [], []
        with _phase("head", device):
            for mb, x in zip(mbs, xs):
                x = x.requires_grad_()
                with torch.enable_grad():
                    h = apply_norm(cfg, outer["final_norm"], x)
                    nll = T.head_loss(cfg, outer, h, mb, axis)
                    loss = nll * inv_n
                dx, *g = torch.autograd.grad(loss, [x] + wrt)
                _accumulate(accs, g)
                dxs.append(dx.to(cfg.torch_dtype))
                nlls.append(nll.detach())
        del xs

        # backward: reverse layer-major, one gather and one reduction per layer
        for l in reversed(range(L)):
            with _phase("gather", device, layer=l, phase="backward"):
                x_in = [ckpt_restore(c, S) for c in ckpt[l]]
                ckpt[l] = None
                lp = ad.gather_layer(storage, l)
            wrt = tree.leaves(lp)
            if flags[l]:     # the shared block's gradient, over every layer it follows
                wrt = wrt + tree.leaves(shared)
            a_layer = None
            with _phase("backward", device, layer=l):
                for m in range(M):
                    xm = x_in[m].requires_grad_()
                    with torch.enable_grad():
                        y, a = T.apply_layer(cfg, lp, xm, positions=pos[m],
                                             window=windows[l], axis=axis, shared=shared,
                                             shared_flag=flags[l])
                    outs, cots = [y], [dxs[m]]
                    if a is not None:               # the router's aux cotangent
                        outs.append(a)
                        cots.append(torch.full_like(a, aux_ct))
                    dx, *g = torch.autograd.grad(outs, [xm] + wrt, cots)
                    with _phase("add", device, layer=l, microbatch=m):
                        if a_layer is None:
                            a_layer = ad.accumulators(ad.layer_shapes, device)
                            accs = tree.leaves(a_layer)
                            if flags[l]:
                                accs = accs + tree.leaves(a_outer["shared"])
                        _accumulate(accs, g)
                    dxs[m] = dx
            del lp, x_in, accs, g
            with _phase("reduce", device, layer=l):
                dest = ad.reduce(a_layer, layer=True,
                                 out=None if grads_l is None else layer_dest(grads_l, l))
            del a_layer
            if layer_update is not None:
                layer_update(l, dest)
            del dest

        # embed backward
        with _phase("embed_grad", device):
            for mb, dx in zip(mbs, dxs):
                de = T.embed_grad(cfg, outer, mb, dx, axis)
                if de is not None:
                    a_outer["embed"].add_(de)
        with _phase("reduce", device, layer="outer"):
            g_outer = ad.reduce(a_outer, layer=False)
        del a_outer
        grads = g_outer if grads_l is None else dict(g_outer, layers=grads_l)
        # the JAX package's aux metric here: the layers' mean of the
        # micro-batches' sum
        return grads, metrics(nlls, None if aux_total is None else aux_total / L, batch)

    return layered_grad if acc.method == "layered" else standard_grad
