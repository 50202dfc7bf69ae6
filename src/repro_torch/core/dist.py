"""Process groups for data and tensor parallelism (counterpart of the JAX
package's ``AxisCtx`` in ``repro/models/common.py``, ``axis_ctx`` in
``repro/core/stepfn.py`` and ``make_train_mesh`` in ``repro/launch/mesh.py``).

The JAX package runs one program over a ``(data, model)`` device mesh under
``shard_map``; the port runs one process per mesh position.  Rank order is
the mesh's, ``rank = d * tp + m``, so chunk ``[..., m, d, :]`` of
``partition.host_partition_leaf`` belongs to rank ``d * tp + m``.  Each rank
belongs to one data group (the ranks of its model column: the ZeRO partition
and the gradient sum) and one model group (the ranks of its data row: the
Megatron shards).

``AxisCtx()``, with no groups, is the one-process path: no collective is
issued and every "gather" is a cast.  A group of size 1 still issues every
collective, so the process-group path runs on one card as it would on many.

Every collective goes through the wrappers below, which count calls and
bytes per (group, op) in ``AxisCtx.counts``.  Bytes are those of the full
buffer: the gathered output, the reduce-scatter's input, the all-reduced
tensor.  They call ``all_gather_into_tensor`` and ``reduce_scatter_tensor``,
which every supported torch has (2.11 has no ``*_single`` forms; 2.13 has
both, and warns that these are deprecated), on flat buffers, as gloo wants.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class AxisCtx:
    """The data and model process groups visible to layer code (None: the
    axis is absent), their sizes and this rank's coordinates."""

    data: dist.ProcessGroup | None = None    # ZeRO partition / gradient sum
    model: dist.ProcessGroup | None = None   # tensor parallel (Megatron)
    tp: int = 1                              # size of the model group
    ndata: int = 1                           # size of the data group
    data_index: int = 0                      # d
    model_index: int = 0                     # m
    # (group name, op) -> [calls, bytes]
    counts: dict = dataclasses.field(default_factory=dict)

    def _count(self, group: str, op: str, t: torch.Tensor) -> None:
        c = self.counts.setdefault((group, op), [0, 0])
        c[0] += 1
        c[1] += t.numel() * t.element_size()

    def all_gather(self, out: torch.Tensor, inp: torch.Tensor, group: str) -> None:
        """``out`` (contiguous, ``size * inp.numel()`` elements) <- every
        rank's ``inp`` of the group, in rank order."""
        dist.all_gather_into_tensor(out.view(-1), inp.reshape(-1), group=getattr(self, group))
        self._count(group, "all_gather", out)

    def reduce_scatter(self, out: torch.Tensor, inp: torch.Tensor, group: str) -> None:
        """``out`` (contiguous) <- this rank's block of the sum over the
        group of ``inp``, flat."""
        dist.reduce_scatter_tensor(out.view(-1), inp.reshape(-1), group=getattr(self, group))
        self._count(group, "reduce_scatter", inp)

    def all_reduce(self, t: torch.Tensor, group: str, op: str = "sum") -> None:
        """In place; ``op`` is "sum" or "max"."""
        red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
        dist.all_reduce(t, op=red, group=getattr(self, group))
        self._count(group, "all_reduce", t)

    def reset_counts(self) -> None:
        self.counts.clear()


LOCAL = AxisCtx()   # one process, no groups: issues no collective


def make_axis(ndata: int, tp: int) -> AxisCtx:
    """This rank's ``AxisCtx`` over an initialised default group of
    ``ndata * tp`` ranks.  Every rank creates every group, in one order, as
    ``dist.new_group`` requires."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != ndata * tp:
        raise ValueError(f"a {ndata}x{tp} (data x model) mesh needs {ndata * tp} "
                         f"processes, the group has {world}")
    d, m = divmod(rank, tp)
    data = model = None
    for mm in range(tp):
        g = dist.new_group([dd * tp + mm for dd in range(ndata)])
        data = g if mm == m else data
    for dd in range(ndata):
        g = dist.new_group([dd * tp + mm for mm in range(tp)])
        model = g if dd == d else model
    return AxisCtx(data=data, model=model, tp=tp, ndata=ndata, data_index=d,
                   model_index=m)


def under_launcher() -> bool:
    """True inside ``python -m torch.distributed.run`` (it sets WORLD_SIZE)."""
    return "WORLD_SIZE" in os.environ


def from_env(ndata: int, tp: int, device: torch.device) -> AxisCtx:
    """Join the group ``torch.distributed.run`` describes in the environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL on the
    card, each rank on card LOCAL_RANK, gloo on the CPU.  The caller ends it
    with ``dist.destroy_process_group()``."""
    world = int(os.environ["WORLD_SIZE"])
    if world != ndata * tp:
        raise ValueError(f"--mesh {ndata}x{tp} needs {ndata * tp} processes, "
                         f"WORLD_SIZE is {world}")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, rank=int(os.environ["RANK"]), world_size=world)
    return make_axis(ndata, tp)
