"""The tick-table pipeline executor, one process per (stage, data, model)
position (counterpart of ``repro/core/pipeline.py``, the paper's §4).

A schedule is data: a ``planner.simulator.TickTable`` gives every stage at
most one (kind, chunk, micro-batch) unit a tick.  Stage s's local chunk v is
global chunk g = v*S + s, layers [g*k_c, (g+1)*k_c).  The JAX package runs
the table as one SPMD ``lax.scan`` in which every stage computes every tick
(bubble ticks on masked garbage) and makes three ring permutes a tick; here
a stage runs only the unit its row names and transfers only what the
table's receive rows mark valid, both ends deriving the same set:

  F    the chunk's layers under ``no_grad`` from ``act[v, mb]`` (stage 0's
       chunk 0 reads the embedding, computed on stage 0 alone); the output
       goes to the next stage on the forward ring
  B    the chunk recomputed with grad from ``act[v, mb]``, one
       ``autograd.grad`` against ``cot[v, mb]``: the weight gradient is
       added into chunk v's fp32 accumulator, dx goes to the previous stage
       on the backward ring (chunk 0's dx is the embedding's cotangent)
  Bd   the same with ``inputs=[x]`` only; ``(x, dy)`` is parked in the
       table's residual slot
  Bw   the chunk recomputed from that slot, ``inputs=`` the weights only

Within a tick the forward and backward rings are posted together and
waited for; then stage 0 runs the head (final norm, loss and its VJP) on a
final arrival; then the loss ring takes the head's cotangent to stage S-1.
The loss ring depends on the forward ring within the tick, so it is a
second exchange.

ZeRO-partitioned storage (this rank's ``[K, chunk]`` fp32 per layer leaf)
gathers the chunks the table's ``gather_segments`` name at each boundary:
one data-group all-gather per leaf and chunk a pass, in ``cfg.dtype``.  A
chunk's gradient is reduce-scattered over the data group, one call per leaf,
right after the stage's last B or Bw unit of that chunk; its accumulator and
weights are freed then.  The counts are the JAX executor's
(``TickTable.predicted_collectives``).  Replicated storage (``[K, ...]``)
all-reduces each layer leaf over the data group at the end of the pass.  The
outer leaves (embedding, head, final norm, a hybrid's ``shared`` block) are
held whole on every stage and never chunked; stage 0, which runs the
embedding and the head, makes their compute copies, and every stage makes
one of ``shared``, which runs after each flagged layer of its chunks.  Their
gradients are summed over the stage group and then the data group: the
shared block's in one fp32 accumulator a stage over every flagged layer its
B and Bw units take (a Bd unit takes ``x`` only), as the JAX executor's
``dsh`` carry; each flagged layer's use comes back apart and is added in
fp32, as the layered schedule adds it (the JAX executor sums a chunk's uses
in ``cfg.dtype`` inside its ``jax.vjp``).

Every family runs: an MoE layer's router aux loss is dropped, as the JAX
executor drops it (``x2, _aux = T.apply_layer(...)``), so the pipelined loss
is the token loss alone; the expert stacks are ZeRO-chunked like any layer
leaf (the pipeline has no expert group).  Each input mode runs: the
activation's length is the labels' (a vlm batch's vision prefix and text),
and the embedding's gradient is ``transformer.embed_grad``'s (none from
frame embeddings).
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.core import partition as zp
from repro_torch.core.dist import AxisCtx
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig, apply_norm
from repro_torch.planner import simulator as simlib


def _last_weight_ticks(table, s: int) -> dict:
    """Chunk v -> the last tick at which stage ``s`` adds to its weight
    gradient (its last B or Bw unit), after which the chunk is done."""
    last = {}
    for t in range(table.n_ticks):
        if table.kind[t][s] in (simlib.TICK_B, simlib.TICK_BWGRAD):
            last[table.unit_v[t][s]] = t
    return last


def make_pipeline_grad_fn(cfg: ModelConfig, spec, template: dict, *, partitioned: bool,
                          axis: AxisCtx, recorder=None, table=None):
    """Returns ``grad_fn(storage, batch) -> (grads like storage, metrics)``
    for this rank of an ``nstage x ndata x tp`` grid (``axis`` from
    ``dist.make_axis``).  ``storage`` is this rank's pipeline storage
    (``stepfn.init_pipeline_storage``); ``batch`` leaves are its rows,
    ``[M, mb_local, S]``, the same on every stage; ``template`` is
    ``stepfn.full_template(cfg)``.  ``table`` is the tick table to run
    (a plan's), ``spec.tick_table()`` when not given.  ``recorder`` (an
    ``obs.trace.TickRecorder``) times this stage's unit of each tick, its
    compute only (the tick profiler, ``obs.trace.measure_tick_timeline``);
    without one the pass records nothing and adds no sync."""
    if axis.stage is None or axis.data is None:
        raise ValueError("the pipeline runs on the stage and data groups of "
                         "dist.make_axis")
    table = spec.tick_table() if table is None else table
    table.validate_executable()
    S, M = spec.n_stages, spec.n_microbatches
    V, k_c = table.n_chunks, table.layers_per_chunk
    if axis.nstage != S:
        raise ValueError(f"{S} stages on a stage group of {axis.nstage}")
    if spec.num_layers != cfg.num_layers:
        raise ValueError(f"{spec.num_layers} pipeline layers, the model has "
                         f"{cfg.num_layers}")
    s = axis.stage_index
    res_slot, _ = table.residual_slots()
    last_w = _last_weight_ticks(table, s)
    segments = table.gather_segments()
    windows, flags, _ = T.layer_tables(cfg)
    dt = cfg.torch_dtype
    head_key = "embed" if cfg.tie_embeddings else "head"
    specs = T.param_specs(cfg, axis.tp)
    local = tree.tree_map(lambda shp, sp: zp.local_shape(shp, sp, axis.tp), template, specs)
    lshapes = tree.tree_map(lambda shp: shp[1:], local["layers"])
    paths = [p for p, _ in tree.leaves_with_path(lshapes)]
    partial = T.model_partial_leaves(cfg, axis.tp)
    nxt, prv = axis.stage_peer(1), axis.stage_peer(-1)

    # the first point-to-point call on a NCCL group must involve every rank
    # of it, and tick 0 does not: one collective on the stage group first
    backend = torch.distributed.get_backend(axis.stage)
    axis.all_reduce(torch.zeros(1, device="cuda" if backend == "nccl" else "cpu"), "stage")

    def leaf_at(t: dict, path):
        for k in path:
            t = t[k]
        return t

    def unflatten(flat: list) -> dict:
        out = tree.tree_map(lambda _: None, lshapes)
        for path, x in zip(paths, flat):
            d = out
            for k in path[:-1]:
                d = d[k]
            d[path[-1]] = x
        return out

    def gather_chunk(storage: dict, v: int) -> list:
        """Chunk v's k_c layers as parameter dicts in ``cfg.dtype``, each
        leaf a fresh tensor requiring grad: one all-gather over the data
        group per leaf when partitioned, a cast otherwise."""
        per_leaf = []
        for path in paths:
            rows = leaf_at(storage["layers"], path)[v * k_c:(v + 1) * k_c]
            if partitioned:
                full = zp.gather_local(rows, axis, leaf_at(lshapes, path), dt, rows=k_c)
            else:
                full = rows.to(dt, copy=True)
            per_leaf.append([full[j].detach().requires_grad_() for j in range(k_c)])
        return [unflatten([leaf[j] for leaf in per_leaf]) for j in range(k_c)]

    def reduce_chunk(acc: list, grads_l: dict, v: int) -> None:
        """Chunk v's accumulated fp32 gradient -> this rank's reduced chunk
        rows ``[v*k_c, (v+1)*k_c)``: one reduce-scatter over the data group
        a leaf, after the model-group sum of a partial leaf."""
        for path, a in zip(paths, acc):
            dest = leaf_at(grads_l, path)[v * k_c:(v + 1) * k_c]
            zp.scatter_grad_local(a, axis, model_partial=path in partial, out=dest.view(-1),
                                  rows=k_c)

    def grad_fn(storage: dict, batch: dict):
        device = storage["embed"].device
        if batch["labels"].shape[0] != M:
            raise ValueError(f"batch has {batch['labels'].shape[0]} micro-batches, "
                             f"the schedule {M}")
        mbs = [{k: b[m] for k, b in batch.items()} for m in range(M)]
        ntok = batch["mask"].float().sum()
        axis.all_reduce(ntok, "data")                 # the global token count
        inv_n = 1.0 / ntok
        okeys = [k for k in storage if k != "layers"]
        # only stage 0 runs the embedding and the head; every stage, the
        # shared block
        outer = {k: tree.tree_map(lambda t: t.to(dt, copy=True).requires_grad_(), storage[k])
                 for k in okeys if s == 0 or k == "shared"}
        shared = outer.get("shared")
        a_outer = {k: tree.tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                                          device=device), storage[k])
                   for k in okeys}
        # the activation's length: a vlm batch's vision prefix and its text
        B_, Sq = batch["labels"].shape[1:]
        act_shape = (B_, Sq, cfg.d_model)
        pos = torch.arange(Sq, dtype=torch.int32, device=device).expand(B_, Sq)
        act, cot, res, dX0 = {}, {}, {}, {}
        if s == 0:
            with torch.no_grad():
                for m, mb in enumerate(mbs):
                    act[0, m] = T.embed_inputs(cfg, outer, mb, axis)[0]
        if partitioned:
            grads_l = tree.tree_map(torch.empty_like, storage["layers"])
        else:
            grads_l = tree.tree_map(lambda t: torch.zeros_like(t, dtype=torch.float32),
                                    storage["layers"])
        wbuf, accs, nlls = {}, {}, {}

        def run_chunk(v: int, x: torch.Tensor, sh: list | None = None) -> torch.Tensor:
            """Chunk v's layers (``sh``: the shared block each runs, when
            not ``shared``); an MoE layer's aux loss is dropped."""
            g = v * S + s
            for j, lp in enumerate(wbuf[v]):
                x, _ = T.apply_layer(cfg, lp, x, positions=pos, window=windows[g * k_c + j],
                                     axis=axis, shared=shared if sh is None else sh[j],
                                     shared_flag=flags[g * k_c + j])
            return x

        def weights(v: int) -> list:
            return [w for lp in wbuf[v] for w in tree.leaves(lp)]

        def shared_uses(v: int) -> list | None:
            """One alias of the shared block (its storage, a leaf of its
            own) per layer of chunk v that runs it, so that each use's
            gradient comes back apart and is added in fp32, as the layered
            schedule adds each layer's; None when no layer does."""
            g = v * S + s
            if shared is None or not any(flags[g * k_c:(g + 1) * k_c]):
                return None
            return [tree.tree_map(lambda t: t.detach().requires_grad_(), shared)
                    if flags[g * k_c + j] else None for j in range(k_c)]

        def weight_grads(v: int, x: torch.Tensor, dy: torch.Tensor, *, dgrad: bool):
            """The B (``dgrad``) / Bw unit: chunk v recomputed from ``x``
            and its backward; the weight gradients into the chunk's
            accumulator, each shared-block use's into ``a_outer``.  Returns
            dx under ``dgrad``."""
            sh = shared_uses(v)
            uses = [u for u in sh or () if u is not None]
            with torch.enable_grad():
                y = run_chunk(v, x, sh)
            wrt = weights(v)
            gs = torch.autograd.grad(y, ([x] if dgrad else []) + wrt
                                     + [t for u in uses for t in tree.leaves(u)], dy)
            del y
            dx, gs = (gs[0], gs[1:]) if dgrad else (None, gs)
            add_weight_grads(v, gs[:len(wrt)])
            sh_acc = tree.leaves(a_outer["shared"]) if uses else []
            for i, gg in enumerate(gs[len(wrt):]):
                sh_acc[i % len(sh_acc)].add_(gg)
            return dx

        def add_weight_grads(v: int, gw) -> None:
            """Layer-major grads (k_c layers of the leaves in ``paths``
            order) into chunk v's fp32 accumulator."""
            n = len(paths)
            if partitioned:
                acc = accs.get(v)
                if acc is None:
                    acc = accs[v] = [torch.zeros((k_c, *leaf_at(lshapes, p)),
                                                 dtype=torch.float32, device=device)
                                     for p in paths]
                for j in range(k_c):
                    for a, gg in zip(acc, gw[j * n:(j + 1) * n]):
                        a[j].add_(gg)
            else:
                for j in range(k_c):
                    for p, gg in zip(paths, gw[j * n:(j + 1) * n]):
                        leaf_at(grads_l, p)[v * k_c + j].add_(gg)

        seg = {t0: chunks for t0, _, chunks in segments}
        for t in range(table.n_ticks):
            for v in seg.get(t, ()):
                wbuf[v] = gather_chunk(storage, v)
            kind, v, mb = table.kind[t][s], table.unit_v[t][s], table.unit_mb[t][s]
            g = v * S + s
            sends, recvs = [], []
            timed = recorder is not None and kind != simlib.TICK_IDLE
            if timed:
                recorder.begin(kind, v, mb)
            if kind == simlib.TICK_F:
                with torch.no_grad():
                    y = run_chunk(v, act[v, mb])
                sends.append((y, nxt))
            elif kind in (simlib.TICK_B, simlib.TICK_BDGRAD):
                x = act.pop((v, mb)).detach().requires_grad_()
                dy = cot.pop((v, mb))
                if kind == simlib.TICK_B:
                    dx = weight_grads(v, x, dy, dgrad=True)
                else:
                    with torch.enable_grad():
                        y = run_chunk(v, x)
                    (dx,) = torch.autograd.grad(y, [x], dy)
                    del y
                    res[res_slot[t][s]] = (x.detach(), dy)
                if g == 0:
                    dX0[mb] = dx
                else:
                    sends.append((dx.contiguous(), prv))
            elif kind == simlib.TICK_BWGRAD:
                x, dy = res.pop(res_slot[t][s])
                weight_grads(v, x, dy, dgrad=False)
            if timed:
                recorder.end()
            if last_w.get(v) == t:
                if partitioned:
                    reduce_chunk(accs.pop(v), grads_l, v)
                del wbuf[v]

            # the forward and backward rings, together
            r1 = r3 = None
            if table.frecv_valid[t][s]:
                r1 = torch.empty(act_shape, dtype=dt, device=device)
                recvs.append((r1, prv))
            if table.brecv_valid[t][s]:
                r3 = torch.empty(act_shape, dtype=dt, device=device)
                recvs.append((r3, nxt))
            if sends or recvs:
                axis.p2p(sends, recvs)
            del sends
            if r3 is not None:
                cot[table.brecv_v[t][s], table.brecv_mb[t][s]] = r3
            fin = r1 is not None and table.frecv_final[t][s]
            if r1 is not None and not fin:
                act[table.frecv_v[t][s], table.frecv_mb[t][s]] = r1

            # the head on a final arrival (stage 0), then the loss ring
            sends, recvs = [], []
            if fin:
                m = table.frecv_mb[t][s]
                xh = r1.requires_grad_()
                wrt = tree.leaves(outer["final_norm"]) + [outer[head_key]]
                with torch.enable_grad():
                    h = apply_norm(cfg, outer["final_norm"], xh)
                    nll = T.head_loss(cfg, outer, h, mbs[m], axis)
                    loss = nll * inv_n
                dxh, *gh = torch.autograd.grad(loss, [xh] + wrt)
                for a, gg in zip(tree.leaves(a_outer["final_norm"]) + [a_outer[head_key]], gh):
                    a.add_(gg)
                nlls[m] = nll.detach()
                sends.append((dxh.to(dt).contiguous(), prv))
            rh = None
            if table.hrecv_valid[t][s]:
                rh = torch.empty(act_shape, dtype=dt, device=device)
                recvs.append((rh, nxt))
            if sends or recvs:
                axis.p2p(sends, recvs)
            if rh is not None:
                cot[V - 1, table.hrecv_mb[t][s]] = rh
        if act or cot or res or wbuf or accs:
            raise RuntimeError(f"stage {s}: the tick table left work behind "
                               f"({len(act)} activations, {len(cot)} cotangents, "
                               f"{len(res)} residuals, {len(wbuf)} chunks)")

        # the embedding's backward (stage 0), then the reductions
        for m, dx in sorted(dX0.items()):
            de = T.embed_grad(cfg, outer, mbs[m], dx, axis)
            if de is not None:
                a_outer["embed"].add_(de)
        for a in tree.leaves(a_outer):
            axis.all_reduce(a, "stage")
            axis.all_reduce(a, "data")
        if not partitioned:
            for path in paths:
                a = leaf_at(grads_l, path)
                if path in partial:
                    axis.all_reduce(a, "model")
                axis.all_reduce(a, "data")
        nll = (torch.stack([nlls[m] for m in range(M)]).sum() if s == 0
               else torch.zeros((), device=device))
        axis.all_reduce(nll, "stage")
        axis.all_reduce(nll, "data")
        return dict(a_outer, layers=grads_l), {"loss": nll / ntok, "ntok": ntok}

    return grad_fn
