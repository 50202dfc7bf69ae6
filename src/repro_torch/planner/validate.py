"""The planner's cost model held against the port's own work (counterpart of
``repro/planner/validate.py``).

The planner predicts a step's compute and collective composition from
counts (units, gathers, reductions, ring transfers) times per-unit costs.
Here the same composition is measured on the port's real grad fns, and both
are returned side by side; the tests hold each term within 20%, the JAX
package's tolerance.

The predicted side is the JAX package's arithmetic, with the constants
passed in (the H100's by default).  The measured side is the port's:

  * dot flops: ``core/roofline.py``'s counter over one call of the grad fn
    (the kernels opaque, as a ``pallas_call`` is to the JAX walk);
  * collective bytes: the calls and bytes ``core/dist.py`` counts per
    (group, op), times the roofline's wire factors.  The JAX package reads
    both from a lowered jaxpr; the port measures them on its process groups
    (gloo on the CPU).

Per-unit costs come from ``traced_layer_costs``: the counter over one
``apply_layer`` and one head on ``meta`` tensors (nothing allocated, so any
width), counting what the JAX walk counts — the flash attention's dots left
out while the reference runs its kernel (``roofline.attention_seen``).

Backward multipliers, from how the port computes its gradients:
  * layered and standard accumulation (``core/accumulation.py``): every
    layer runs forward, then again in the backward with its two transposed
    dots: 4x the forward flops a layer and micro-batch; the head 3x.
  * the pipeline (``core/pipeline.py``): a stage runs only the units its
    row of the tick table names — F once, B recomputed with its transposes
    (3x), the head on the loss stage once per micro-batch (3x) — and sends
    only the valid ring entries.  That is what the event simulator prices
    (``simulator.simulate``'s per-stage busy time and sends), not
    ``predict_spmd_composition``, which prices the JAX package's lock-step
    executor (every tick a masked chunk VJP, a head VJP and three permutes
    on every stage); both are returned.  (A split table's Bd and Bw each
    recompute the chunk, 4x the forward in all, where the simulator prices
    the split at the unsplit 3x.)
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import tree
from repro_torch.core import roofline, stepfn
from repro_torch.core.accumulation import AccumConfig, make_grad_fn
from repro_torch.core.dist import AxisCtx
from repro_torch.core.pipeline import make_pipeline_grad_fn
from repro_torch.data.synthetic import DataConfig, local_rows, make_batch
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig, apply_norm
from repro_torch.planner import simulator as simlib


@dataclasses.dataclass(frozen=True)
class TracedCosts:
    """Per-unit costs counted from the real model code (per device)."""
    flops_fwd_layer: float        # one layer, one micro-batch, forward
    flops_head: float             # final-norm + LM head, one micro-batch
    act_bytes: float              # boundary activation bytes, one micro-batch
    layer_bytes: float            # one layer's parameter bytes (storage dtype)
    outer_bytes: float            # embed/head/norm parameter bytes


def _itemsize(dtype: str) -> int:
    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


def traced_layer_costs(cfg: ModelConfig, mb: int, seq: int) -> TracedCosts:
    """One layer's and one head's forward dot flops at micro-batch ``mb``
    and length ``seq``, counted on ``meta`` tensors; the parameter bytes in
    ``cfg.param_dtype``, as the JAX package's storage holds them."""
    tmpl = stepfn.full_template(cfg)
    dt = cfg.torch_dtype

    def meta(shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device="meta")

    lshapes = tree.tree_map(lambda s: s[1:], tmpl["layers"])
    outer_shapes = {k: v for k, v in tmpl.items() if k not in ("layers", "shared")}
    x = meta((mb, seq, cfg.d_model))
    pos = meta((mb, seq), torch.int32)
    f_layer = roofline.count_dots(
        T.apply_layer, cfg, tree.tree_map(meta, lshapes), x, positions=pos,
        window=cfg.layer_windows()[0], see=roofline.attention_seen(cfg, seq))
    batch = {"labels": meta((mb, seq), torch.int32), "mask": meta((mb, seq), torch.int32)}

    def head(outer, x, batch):
        h = apply_norm(cfg, outer["final_norm"], x)
        return T.head_loss(cfg, outer, h, batch)

    f_head = roofline.count_dots(head, tree.tree_map(meta, outer_shapes), x, batch)

    def nbytes(shapes):
        return sum(math.prod(s) for s in tree.leaves(shapes)) * _itemsize(cfg.param_dtype)

    return TracedCosts(
        flops_fwd_layer=f_layer,
        flops_head=f_head,
        act_bytes=mb * seq * cfg.d_model * x.element_size(),
        layer_bytes=nbytes(lshapes),
        outer_bytes=nbytes(outer_shapes),
    )


def _agreement(pred: float, meas: float) -> float:
    return pred / meas if meas > 0 else float("inf")


def _measured(flops: float, axis: AxisCtx, peak_flops: float, link_bw: float) -> dict:
    coll = roofline.wire_bytes(axis.counts, {"data": axis.ndata, "model": axis.tp,
                                             "stage": axis.nstage})
    return {"compute_s": flops / peak_flops,
            "collective_s": sum(coll.values()) / link_bw,
            "dot_flops": flops, "coll_bytes": coll}


def _batch(cfg: ModelConfig, n_microbatches: int, mb: int, seq: int, axis: AxisCtx) -> dict:
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=n_microbatches * mb, n_microbatches=n_microbatches)
    return local_rows(make_batch(data, 0), axis)


# ---------------------------------------------------------------------------
# Pipeline grad step: predicted vs measured composition
# ---------------------------------------------------------------------------
def predict_pipeline_composition(spec, cost: simlib.CostModel, *, stage: int,
                                 head_flops: float = 0.0,
                                 extra_coll_bytes: float = 0.0) -> dict:
    """Predicted cost composition of stage ``stage`` of the port's executor:
    the event simulator's busy time and sends for it, the head's 3x on the
    loss stage (stage 0) once per micro-batch, and ``extra_coll_bytes`` (the
    outer leaves' gradient sum over the stage group)."""
    res = simlib.simulate(spec.sim_config(), cost)
    flops = (res.busy_per_stage[stage] * cost.flops_rate
             + (3.0 * spec.n_microbatches * head_flops if stage == 0 else 0.0))
    p2p = (res.counts["fwd_sends"][stage] + res.counts["bwd_sends"][stage]) * cost.act_bytes
    coll = p2p + extra_coll_bytes
    return {"dot_flops": flops, "p2p_bytes": p2p,
            "compute_s": flops / cost.flops_rate,
            "collective_s": coll / cost.p2p_bw if cost.p2p_bw > 0 else 0.0}


def pipeline_composition(cfg: ModelConfig, spec, n_microbatches: int, mb: int, seq: int, *,
                         axis: AxisCtx, peak_flops: float = roofline.PEAK_FLOPS,
                         link_bw: float = roofline.LINK_BW, seed: int = 0) -> dict:
    """This rank's measured composition of one pipelined grad pass (random
    weights from ``seed``, replicated storage over a data group of one)
    against the prediction for its stage.  ``mb`` is a micro-batch's rows."""
    M = n_microbatches
    tc = traced_layer_costs(cfg, mb, seq)
    storage = stepfn.init_pipeline_storage(cfg, seed, spec, partitioned=False, device="cpu",
                                           axis=axis)
    grad_fn = make_pipeline_grad_fn(cfg, spec, stepfn.full_template(cfg), partitioned=False,
                                    axis=axis)
    batch = _batch(cfg, M, mb, seq, axis)
    axis.reset_counts()
    meas = _measured(roofline.count_dots(grad_fn, storage, batch), axis, peak_flops, link_bw)

    cost = simlib.CostModel(
        flops_fwd_layer=tc.flops_fwd_layer,
        flops_bwd_layer=3.0 * tc.flops_fwd_layer,
        act_bytes=tc.act_bytes,
        layer_param_bytes=0.0, layer_grad_bytes=0.0,
        flops_rate=peak_flops, p2p_bw=link_bw, coll_bw=link_bw)
    # the outer leaves' fp32 gradients are summed over the stage group once a
    # step (every stage holds them whole)
    S = spec.n_stages
    outer_psum = 2.0 * (S - 1) / S * tc.outer_bytes
    pred = predict_pipeline_composition(spec, cost, stage=axis.stage_index,
                                        head_flops=tc.flops_head,
                                        extra_coll_bytes=outer_psum)
    spmd = simlib.predict_spmd_composition(spec, cost, head_flops=tc.flops_head,
                                           extra_coll_bytes=outer_psum)
    return {
        "config": {"schedule": spec.schedule, "S": S, "K": spec.layers_per_stage, "M": M,
                   "stage": axis.stage_index},
        "predicted": pred,
        "predicted_spmd": spmd,
        "measured": meas,
        "agreement": {
            "compute": _agreement(pred["compute_s"], meas["compute_s"]),
            "collective": _agreement(pred["collective_s"], meas["collective_s"]),
        },
    }


# ---------------------------------------------------------------------------
# Accumulation grad step (data group): predicted vs measured composition
# ---------------------------------------------------------------------------
def predict_accum_composition(cfg: ModelConfig, tc: TracedCosts, *,
                              method: str, partitioned: bool,
                              n_microbatches: int, n_data: int,
                              peak_flops: float = roofline.PEAK_FLOPS,
                              link_bw: float = roofline.LINK_BW) -> dict:
    """Planner prediction of the accumulation grad fn's per-device costs.

    Collective placement mirrors core/accumulation.py: layered gathers each
    layer twice (fwd + bwd pass) and reduces once; standard gathers per
    (layer, micro-batch) — with the remat'd forward re-gathering during AD —
    and reduce-scatters per micro-batch.  Non-partitioned methods psum once
    per layer (layered, spread) or once per step (standard).
    """
    L, M, n = cfg.num_layers, n_microbatches, n_data
    flops = (L * M * tc.flops_fwd_layer * 4.0      # fwd + recompute + 2x dots
             + M * tc.flops_head * 3.0)
    ring = (n - 1) / n if n > 1 else 0.0
    if n <= 1:
        coll = 0.0
    elif partitioned:
        if method == "layered":
            per_layer = ring * tc.layer_bytes * 3.0        # 2 gathers + scatter
            coll = L * per_layer + ring * tc.outer_bytes * 3.0
        else:
            # per (layer, mb): fwd gather + remat re-gather + scatter
            coll = (L * M * ring * tc.layer_bytes * 3.0
                    + M * ring * tc.outer_bytes * 3.0)
    else:
        psum = 2.0 * ring * (L * tc.layer_bytes + tc.outer_bytes)
        coll = psum            # same wire bytes either placement
    return {"dot_flops": flops, "coll_bytes": coll,
            "compute_s": flops / peak_flops,
            "collective_s": coll / link_bw}


def accum_composition(cfg: ModelConfig, axis: AxisCtx, *, method: str, partitioned: bool,
                      n_microbatches: int, mb: int, seq: int,
                      peak_flops: float = roofline.PEAK_FLOPS,
                      link_bw: float = roofline.LINK_BW, seed: int = 0) -> dict:
    """This rank's measured composition of ``make_grad_fn`` over its data
    group (random weights from ``seed``) against the prediction.  ``mb`` is
    a micro-batch's global rows, split over the data group."""
    M = n_microbatches
    if mb % axis.ndata:
        raise ValueError(f"a micro-batch of {mb} rows does not split over "
                         f"{axis.ndata} data ranks")
    # the micro-batch is split over the data group: per-device costs see
    # the local micro-batch
    tc = traced_layer_costs(cfg, mb // axis.ndata, seq)
    acc = AccumConfig(method=method, partitioned=partitioned, n_microbatches=M)
    storage = stepfn.init_storage(cfg, seed, partitioned=partitioned, device="cpu", axis=axis)
    grad_fn = make_grad_fn(cfg, acc, stepfn.full_template(cfg), axis=axis)
    batch = _batch(cfg, M, mb, seq, axis)
    axis.reset_counts()
    meas = _measured(roofline.count_dots(grad_fn, storage, batch), axis, peak_flops, link_bw)
    pred = predict_accum_composition(cfg, tc, method=method, partitioned=partitioned,
                                     n_microbatches=M, n_data=axis.ndata,
                                     peak_flops=peak_flops, link_bw=link_bw)
    return {
        "config": {"method": method, "partitioned": partitioned, "M": M,
                   "n_data": axis.ndata},
        "predicted": pred,
        "measured": meas,
        "agreement": {
            "compute": _agreement(pred["compute_s"], meas["compute_s"]),
            "collective": _agreement(pred["collective_s"], meas["collective_s"]),
        },
    }
