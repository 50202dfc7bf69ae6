"""Checkpoint layouts and resharding (counterpart of
``repro/resilience/reshard.py``, §8.3), and the step between one rank's
blocks and the global checkpoint bundle.

A checkpoint holds the global storage of the layout the run trained in, in
the JAX package's shapes, so that either package reads the other's files:

  * pipelined + partitioned:  layer leaves ``[S, K, n_model, n_data, chunk]``
    fp32 ZeRO chunks, outer leaves whole in fp32;
  * pipelined + replicated:   layer leaves ``[S, K, ...]`` stage stacks;
  * flat + partitioned:       every leaf ``[L?, n_model, n_data, chunk]``;
  * flat + replicated:        the full parameter tree.

``to_full_state`` / ``from_full_state`` move between a layout's storage and
the full parameter tree on the host (numpy), through the same
``core/partition.py`` functions the trainer's layouts are built on, so a
reshard is pure data movement, bit for bit; sub-fp32 leaves (bf16 moments,
carried on the host as CPU ``torch.bfloat16`` tensors) widen exactly and are
cast back.  The trees may be partial (any subset of the leaves).

The port runs one process per rank, each holding its blocks, so two
functions cross between ranks and the global bundle.  ``global_leaves``
yields the global leaves on rank 0, one at a time, each gathered from every
rank's block over the default group: the §8.2 streaming unit, which never
holds a second copy of the state, only one leaf.  ``restore_bundle`` has
rank 0 pick the newest checkpoint that verifies and broadcast its step; then
every rank reads that directory (the ranks share one filesystem) and copies
its own block of each leaf, through ``convert.storage_from_numpy`` /
``pipeline_storage_from_numpy``, into the tensors it already holds.  Both
run on the grid's world group (``AxisCtx.world``), which after a
failure-shrink holds the survivors only.

``drain_bundle`` is the failure-shrink's move: the ranks of the last data
row hand their ZeRO chunks to the survivors before they leave, leaf by leaf
over the old data groups, and each survivor keeps its chunk of the
``data - 1`` layout.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch import convert
from repro_torch import tree as ptree
from repro_torch.checkpointing import store
from repro_torch.core import partition as zp
from repro_torch.core import stepfn
from repro_torch.core.dist import LOCAL, AxisCtx
from repro_torch.core.schedules import PipeSpec
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig

PyTree = Any
PARTS = ("params", "mu", "nu")


class ReshardError(RuntimeError):
    """A layout conversion is infeasible (indivisible shapes, bad meta)."""


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A template leaf: what ``store.load_state`` needs of one."""
    shape: tuple
    dtype: Any


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """The mesh + storage layout a training state is chunked for.

    ``schedule``/``n_microbatches`` matter only when ``stages > 1``: the
    tick-table chunk placement (global chunk g = v*S + s) depends on the
    schedule's chunk count V."""
    stages: int = 1
    data: int = 1
    model: int = 1
    partitioned: bool = True
    schedule: str = "modular"
    n_microbatches: int = 1

    def __post_init__(self):
        for f in ("stages", "data", "model"):
            if getattr(self, f) < 1:
                raise ReshardError(f"MeshLayout.{f} must be >= 1, got {getattr(self, f)}")

    @property
    def devices(self) -> int:
        return self.stages * self.data * self.model

    def to_meta(self) -> dict:
        return {"stages": self.stages, "data": self.data, "model": self.model,
                "partitioned": self.partitioned, "schedule": self.schedule,
                "n_microbatches": self.n_microbatches}

    @classmethod
    def from_meta(cls, meta: dict) -> "MeshLayout":
        try:
            return cls(**{k: meta[k] for k in ("stages", "data", "model", "partitioned",
                                               "schedule", "n_microbatches")})
        except KeyError as e:
            raise ReshardError(f"checkpoint layout meta is missing key {e.args[0]!r}: "
                               f"{meta}") from e

    def pipe_spec(self, cfg: ModelConfig) -> PipeSpec:
        if cfg.num_layers % self.stages:
            raise ReshardError(f"stages={self.stages} does not divide "
                               f"num_layers={cfg.num_layers} for {cfg.name}")
        try:
            return PipeSpec(n_stages=self.stages, layers_per_stage=cfg.num_layers // self.stages,
                            n_microbatches=self.n_microbatches, schedule=self.schedule)
        except AssertionError as e:
            raise ReshardError(f"infeasible pipeline shape for layout {self}: {e}") from e


def layout_of(axis: AxisCtx, *, partitioned: bool, schedule: str = "modular",
              n_microbatches: int = 1) -> MeshLayout:
    """The layout of this rank's grid."""
    return MeshLayout(stages=axis.nstage, data=axis.ndata, model=axis.tp,
                      partitioned=partitioned, schedule=schedule,
                      n_microbatches=n_microbatches)


# ---------------------------------------------------------------------------
# Templates: the global shapes of a layout's storage (host-only, cheap)
# ---------------------------------------------------------------------------
def _full_template(cfg: ModelConfig) -> PyTree:
    dt = np.dtype(cfg.param_dtype)
    return ptree.tree_map(lambda s: Leaf(tuple(s), dt), stepfn.full_template(cfg))


def _chunked(local: tuple, n_model: int, n_data: int, lead: tuple) -> Leaf:
    return Leaf((*lead, n_model, n_data, zp.chunk_size(math.prod(local), n_data)),
                np.dtype(np.float32))


def storage_template(cfg: ModelConfig, layout: MeshLayout) -> PyTree:
    """``Leaf`` tree of the global training-state storage for ``layout``:
    the ``like`` argument of ``store.load_state`` on that layout."""
    full = _full_template(cfg)
    tp = layout.model
    specs = T.param_specs(cfg, tp)

    def n_model(sp) -> int:
        return 1 if zp.model_replicated(sp) else tp

    if layout.stages > 1:
        spec = layout.pipe_spec(cfg)
        S, K = spec.n_stages, spec.layers_per_stage
        outer = {k: v for k, v in full.items() if k != "layers"}
        if layout.partitioned:
            outer = ptree.tree_map(lambda l: Leaf(l.shape, np.dtype(np.float32)), outer)
            layers = ptree.tree_map(
                lambda l, sp: _chunked(zp.local_shape(l.shape, sp, tp)[1:], n_model(sp),
                                       layout.data, (S, K)),
                full["layers"], specs["layers"])
        else:
            layers = ptree.tree_map(lambda l: Leaf((S, K, *l.shape[1:]), l.dtype),
                                    full["layers"])
        return dict(outer, layers=layers)
    if layout.partitioned:
        def conv(path, l, sp):
            local = zp.local_shape(l.shape, sp, tp)
            if path[0] == "layers":
                return _chunked(local[1:], n_model(sp), layout.data, local[:1])
            return _chunked(local, n_model(sp), layout.data, ())
        return ptree.tree_map_with_path(conv, full, specs)
    return full


def bundle_template(cfg: ModelConfig, layout: MeshLayout, *,
                    moment_dtype="float32") -> PyTree:
    """Template of the checkpoint bundle: parameters AND optimizer state, so
    a resumed trajectory is exact."""
    st = storage_template(cfg, layout)
    mom = ptree.tree_map(lambda l: Leaf(l.shape, moment_dtype), st)
    return {"params": st, "mu": mom, "nu": mom, "opt_step": Leaf((), np.dtype(np.int32))}


# ---------------------------------------------------------------------------
# Layout <-> full-layout tree (pure host)
# ---------------------------------------------------------------------------
def _np(x) -> np.ndarray:
    """A host leaf as numpy; bf16 widened to fp32 (exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    if store.is_bf16(np.asarray(x).dtype):
        return np.asarray(x, np.float32)
    return np.asarray(x)


def _layer_shapes(cfg: ModelConfig) -> dict:
    return ptree.tree_map(lambda s: tuple(s[1:]), stepfn.full_template(cfg)["layers"])


def to_full_state(storage: PyTree, cfg: ModelConfig, layout: MeshLayout) -> PyTree:
    """Storage in ``layout`` -> the full-layout tree (host numpy arrays).
    Partitioned layouts come back as fp32; replicated ones keep their
    dtypes (bf16 widened to fp32).  Pure data movement."""
    storage = ptree.tree_map(_np, storage)
    tp = layout.model
    if layout.stages > 1:
        spec = layout.pipe_spec(cfg)
        outer = {k: v for k, v in storage.items() if k != "layers"}
        if layout.partitioned:
            layers = zp.from_partitioned_stage_stack(
                storage.get("layers", {}), spec, _layer_shapes(cfg),
                lspecs=T.layer_specs(cfg, tp), tp=tp)
        else:
            layers = zp.from_stage_stack(storage.get("layers", {}), spec)
        return dict(outer, layers=layers) if "layers" in storage else outer
    if not layout.partitioned:
        return storage
    full = stepfn.full_template(cfg)

    def conv(path, chunks, shape, sp):
        return zp.host_unpartition_leaf(chunks, tuple(shape), tp, stacked=path[0] == "layers",
                                        model_dim=zp.model_dim(sp))

    return ptree.tree_map_with_path(conv, storage, full, T.param_specs(cfg, tp))


def from_full_state(full: PyTree, cfg: ModelConfig, layout: MeshLayout) -> PyTree:
    """Full-layout tree -> storage in ``layout`` (host numpy arrays).
    Partitioned layouts widen to fp32 (exact); replicated layouts cast to
    the template dtype."""
    # the other stacks' empty ``shared`` subtree (the JAX tree's) is dropped
    full = {k: v for k, v in ptree.tree_map(_np, full).items() if k != "shared" or v}
    tmpl = _full_template(cfg)
    tp = layout.model
    if layout.stages > 1:
        spec = layout.pipe_spec(cfg)
        outer = {k: v for k, v in full.items() if k != "layers"}
        if layout.partitioned:
            outer = ptree.tree_map(lambda x: np.asarray(x, np.float32), outer)
            layers = zp.to_partitioned_stage_stack(full.get("layers", {}), spec, layout.data,
                                                   lspecs=T.layer_specs(cfg, tp), tp=tp)
        else:
            outer = ptree.tree_map(lambda x, t: np.asarray(x, t.dtype), outer,
                                   {k: tmpl[k] for k in outer})
            layers = zp.to_stage_stack(ptree.tree_map(lambda x, t: np.asarray(x, t.dtype),
                                                      full.get("layers", {}), tmpl["layers"]),
                                       spec)
        return dict(outer, layers=layers) if "layers" in full else outer
    if not layout.partitioned:
        return ptree.tree_map(lambda x, t: np.asarray(x, t.dtype), full, tmpl)

    def conv(path, x, sp):
        return zp.host_partition_leaf(x, tp, layout.data, stacked=path[0] == "layers",
                                      model_dim=zp.model_dim(sp))

    return ptree.tree_map_with_path(conv, full, T.param_specs(cfg, tp))


def _dtype_like(out: np.ndarray, src):
    """``out`` in the dtype of the leaf it was resharded from."""
    if isinstance(src, torch.Tensor):
        return torch.from_numpy(np.require(out, requirements="C")).to(src.dtype)
    src = np.asarray(src)
    return out if out.dtype == src.dtype else np.asarray(out, src.dtype)


def reshard_state(storage: PyTree, cfg: ModelConfig, src: MeshLayout,
                  dst: MeshLayout) -> PyTree:
    """Storage saved on ``src`` -> storage for ``dst`` (host, bit-exact for
    fp32 state; sub-fp32 leaves keep their dtype)."""
    if src == dst:
        return storage
    out = from_full_state(to_full_state(storage, cfg, src), cfg, dst)
    paths = lambda t: [p for p, _ in ptree.leaves_with_path(t)]  # noqa: E731
    if paths(out) == paths(storage):
        out = ptree.tree_map(_dtype_like, out, storage)
    return out


def reshard_bundle(bundle: PyTree, cfg: ModelConfig, src: MeshLayout,
                   dst: MeshLayout) -> PyTree:
    """Reshard a params + moments bundle; moments share the parameter
    layout, the step scalar passes through."""
    out = {k: reshard_state(bundle[k], cfg, src, dst) for k in PARTS}
    out["opt_step"] = np.asarray(bundle["opt_step"])
    return out


def moment_dtype_of(bundle: PyTree) -> str:
    return store.dtype_name(ptree.leaves(bundle["mu"])[0].dtype)


# ---------------------------------------------------------------------------
# This rank's blocks <-> the global bundle
# ---------------------------------------------------------------------------
def _world(axis: AxisCtx) -> tuple[int, int]:
    """(size, rank) of the grid's world group: the default group, or the
    survivors' group after a failure-shrink (1, 0 without groups)."""
    if axis is LOCAL or not tdist.is_initialized():
        return 1, 0
    return tdist.get_world_size(axis.world), tdist.get_rank(axis.world)


def _root(axis: AxisCtx) -> int:
    """The global rank of the world group's rank 0."""
    return axis.ranks[0] if axis.ranks else 0


def _storage_path(path: tuple) -> tuple | None:
    """A bundle path -> the storage path of its leaf (None: the step)."""
    if path[0] == "opt_step":
        return None
    return path[1:] if path[0] in PARTS else path


def _spec_at(cfg: ModelConfig, tp: int, spath: tuple):
    sp = T.param_specs(cfg, tp)
    for k in spath:
        sp = sp[k]
    return sp


def _assemble(blocks: list, spath: tuple, cfg: ModelConfig, layout: MeshLayout):
    """Every rank's block of one storage leaf (CPU tensors in rank order
    ``(s*D + d)*M + m``) -> the global leaf."""
    S, D, M = layout.stages, layout.data, layout.model
    at = lambda s, d, m: blocks[(s * D + d) * M + m]  # noqa: E731
    dim = zp.model_dim(_spec_at(cfg, M, spath))
    ms = range(M) if dim is not None else (0,)
    layer = spath[0] == "layers"
    if layout.stages > 1 and layer:
        if layout.partitioned:     # [K, chunk] blocks -> [S, K, n_model, n_data, chunk]
            return torch.stack([torch.stack([torch.stack([at(s, d, m) for d in range(D)], 1)
                                             for m in ms], 1) for s in range(S)])
        return torch.stack([torch.cat([at(s, 0, m) for m in ms], dim) for s in range(S)])
    if layout.partitioned and layout.stages == 1:   # [L?, 1, 1, c] -> [L?, n_model, n_data, c]
        return torch.cat([torch.cat([at(0, d, m) for d in range(D)], -2) for m in ms], -3)
    return torch.cat([at(0, 0, m) for m in ms], dim) if dim is not None else at(0, 0, 0)


def global_leaves(local: PyTree, cfg: ModelConfig, layout: MeshLayout,
                  axis: AxisCtx = LOCAL) -> Iterator[tuple[tuple, Any]]:
    """``(key path, global leaf)`` of a bundle or storage tree whose leaves
    are this rank's blocks in ``layout``, in the tree's sorted order, one
    leaf at a time: each gathered to rank 0 over the default group and
    assembled there as a CPU tensor.  Every rank must iterate it to the end
    (the gathers are collective, over the grid's world group); other ranks
    get ``(path, None)``."""
    world, rank = _world(axis)
    if world != layout.devices:
        raise ReshardError(f"layout {layout} has {layout.devices} ranks, the group {world}")
    for path, t in ptree.leaves_with_path(local):
        spath = _storage_path(path)
        if world == 1:
            yield path, t
            continue
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(world)] if rank == 0 else None
        tdist.gather(t, out, dst=_root(axis), group=axis.world)
        if rank != 0:
            yield path, None
        elif spath is None:
            yield path, out[0].cpu()
        else:
            yield path, _assemble([b.cpu() for b in out], spath, cfg, layout)


def save_bundle(root: str, local: PyTree, cfg: ModelConfig, layout: MeshLayout,
                axis: AxisCtx = LOCAL, *, step: int, meta: dict,
                keep: int | None = None) -> str | None:
    """Every rank calls this: rank 0 writes the global checkpoint of this
    rank grid's blocks (``global_leaves`` into ``store.save_checkpoint``),
    then every rank waits at a barrier, so that no rank goes on to read a
    directory whose manifest is not written yet.  Returns the directory on
    rank 0."""
    world, rank = _world(axis)
    leaves = global_leaves(local, cfg, layout, axis)
    d = None
    if rank == 0:
        d = store.save_checkpoint(root, leaves, step=step, meta=meta, keep=keep)
    else:
        for _ in leaves:
            pass
    if world > 1:
        tdist.barrier(group=axis.world)
    return d


def _nest(path: tuple, value) -> dict:
    out = value
    for k in reversed(path):
        out = {k: out}
    return out


def _leaf_at(t, path: tuple):
    for k in path:
        t = t[k]
    return t


def _local_block(arr, spath: tuple, cfg: ModelConfig, saved: MeshLayout,
                 live: MeshLayout, axis: AxisCtx) -> torch.Tensor:
    """One global storage leaf in ``saved`` -> this rank's block of it in
    ``live``, through the full-layout leaf and the trainer's own
    conversions."""
    full = to_full_state(_nest(spath, arr), cfg, saved)
    if live.stages > 1:
        full = dict(full, layers=full.get("layers", {}))
        local = convert.pipeline_storage_from_numpy(cfg, full, live.pipe_spec(cfg),
                                                    partitioned=live.partitioned, axis=axis)
    else:
        local = convert.storage_from_numpy(cfg, full, partitioned=live.partitioned, axis=axis)
    return _leaf_at(local, spath)


def load_blocks(root: str, manifest: dict, like: PyTree, targets: PyTree,
                cfg: ModelConfig, saved: MeshLayout, live: MeshLayout,
                axis: AxisCtx = LOCAL) -> None:
    """Copy this rank's block of every leaf of the checkpoint at ``root``
    (global leaves of ``like``, in layout ``saved``) into ``targets``, the
    tensors it holds in layout ``live`` (same tree structure), one leaf at a
    time: no second copy of the state on the device."""
    world, _ = _world(axis)
    for path, arr in store.iter_state(root, like, manifest):
        dest = _leaf_at(targets, path)
        spath = _storage_path(path)
        src = torch.as_tensor(arr) if not isinstance(arr, torch.Tensor) else arr
        if spath is not None and not (saved == live and world == 1):
            src = _local_block(arr, spath, cfg, saved, live, axis)
        if src.numel() != dest.numel():
            raise store.CheckpointError(f"{root}: leaf {store._leaf_name(path)} gives this "
                                        f"rank {tuple(src.shape)}, it holds "
                                        f"{tuple(dest.shape)}")
        with torch.no_grad():
            dest.copy_(src.reshape(dest.shape))


def saved_layout(manifest: dict, live: MeshLayout) -> MeshLayout:
    meta = manifest.get("meta", {})
    return MeshLayout.from_meta(meta["layout"]) if "layout" in meta else live


def restore_bundle(root: str, targets: PyTree, cfg: ModelConfig, live: MeshLayout,
                   axis: AxisCtx = LOCAL, *, moment_dtype: str = "float32",
                   max_rollback: int | None = None,
                   on_reject: Callable[[str, str], None] | None = None) -> int | None:
    """Restore the newest valid checkpoint under ``root`` into ``targets``
    (``{"params", "mu", "nu", "opt_step"}``, this rank's tensors in layout
    ``live``), resharding when the saved layout differs.  Rank 0 walks the
    step dirs newest first and rejects (``on_reject(dir, error)``) any that
    fails its checksums or does not fit its own recorded layout's template;
    the chosen step goes to every rank, which then reads that directory.
    Returns the step, or None when nothing is restorable."""
    world, rank = _world(axis)
    choice = [None]
    if rank == 0:
        for step, d, manifest, bad in store.candidates(root, max_rollback=max_rollback):
            try:
                if bad:
                    raise store.CheckpointError(f"{d}: {bad}")
                saved = saved_layout(manifest, live)
                like = bundle_template(cfg, saved, moment_dtype=manifest.get("meta", {}).get(
                    "moment_dtype", moment_dtype))
                store.check_like(d, manifest, like)
            except store.CheckpointError as e:
                if on_reject is not None:
                    on_reject(d, str(e))
                continue
            choice = [(step, d)]
            break
    if world > 1:
        tdist.broadcast_object_list(choice, src=_root(axis), group=axis.world)
    if choice[0] is None:
        return None
    step, d = choice[0]
    manifest = store.load_manifest(d)
    saved = saved_layout(manifest, live)
    like = bundle_template(cfg, saved, moment_dtype=manifest.get("meta", {}).get(
        "moment_dtype", moment_dtype))
    load_blocks(d, manifest, like, targets, cfg, saved, live, axis)
    return step


# ---------------------------------------------------------------------------
# Failure-shrink: drain the last data row's chunks to the survivors
# ---------------------------------------------------------------------------
def survivors(axis: AxisCtx, ndata: int) -> list[int]:
    """The global ranks that stay when the grid keeps its first ``ndata``
    data rows (every stage and model rank at a data index below ``ndata``),
    in mesh order."""
    return [r for k, r in enumerate(axis.ranks) if (k // axis.tp) % axis.ndata < ndata]


def _local_numels(cfg: ModelConfig, layout: MeshLayout) -> dict:
    """Storage path -> the model-local numel of one layer of a layer leaf,
    or of an outer leaf."""
    tp = layout.model

    def numel(path, shape, sp):
        local = zp.local_shape(tuple(shape), sp, tp)
        return math.prod(local[1:] if path[0] == "layers" else local)

    return dict(ptree.leaves_with_path(ptree.tree_map_with_path(
        numel, stepfn.full_template(cfg), T.param_specs(cfg, tp))))


def drain_bundle(local: PyTree, cfg: ModelConfig, old: MeshLayout, new: MeshLayout,
                 axis: AxisCtx, keep: bool) -> int:
    """Every rank of the old grid ``axis`` calls this, the leaving ones (the
    data rows from ``new.data`` on, ``keep`` False) included: ``local``
    (this rank's bundle or storage tree in ``old``) goes to ``new`` (``old``
    with as many data rows or fewer) in place, leaf by leaf.  A partitioned
    layer leaf, or a flat layout's outer leaf, is all-gathered over the old
    data group in its own dtype (the model-local leaf, whole on this rank
    for as long as that leaf takes), and a survivor replaces its chunk by
    its chunk ``d`` of ``new.data`` (``partition.partition_local``, as the
    storage is first built, cast back to the leaf's dtype); leaves held whole over the data group (the
    pipeline's outer leaves, the replicated layouts, the step) stay as they
    are.  Returns the bytes the all-gathers brought back to this rank
    (counted in ``axis.counts``)."""
    if (old.stages, old.model, old.partitioned) != (new.stages, new.model, new.partitioned) \
            or not 1 <= new.data <= old.data:
        raise ReshardError(f"a drain keeps {old}'s first data rows, it cannot go to {new}")
    if not old.partitioned:
        return 0
    numels = _local_numels(cfg, old)
    D = axis.ndata
    moved = 0
    for path, t in ptree.leaves_with_path(local):
        spath = _storage_path(path)
        if spath is None or (old.stages > 1 and spath[0] != "layers"):
            continue
        k = t.shape[0] if spath[0] == "layers" else 1
        c = t.numel() // k
        out = torch.empty(D * k * c, dtype=t.dtype, device=t.device)
        axis.all_gather(out, t.reshape(k, c), "data")
        moved += out.numel() * out.element_size()
        if keep:
            # rank-major [D, k, c] -> layer-major [k, D * c], the padding cut
            full = out.view(D, k, c).transpose(0, 1).reshape(k, D * c)[:, :numels[spath]]
            # partition_local widens to fp32: the chunk goes back in the leaf's
            # dtype (bf16 moments stay bf16; exact)
            block = zp.partition_local(full, new.data, axis.data_index,
                                       stacked=True).to(t.dtype)
            lead = (k,) if spath[0] == "layers" else ()
            parent = _leaf_at(local, path[:-1])
            parent[path[-1]] = block.reshape(*lead, *t.shape[len(lead):-1], -1)
        del out
    return moved
