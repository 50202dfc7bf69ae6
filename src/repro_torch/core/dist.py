"""Process groups for pipeline, data and tensor parallelism (counterpart of
the JAX package's ``AxisCtx`` in ``repro/models/common.py``, ``axis_ctx`` in
``repro/core/stepfn.py`` and ``make_train_mesh`` in ``repro/launch/mesh.py``).

The JAX package runs one program over a ``(stage, data, model)`` device mesh
under ``shard_map``; the port runs one process per mesh position.  Rank order
is the mesh's, ``rank = (s * D + d) * M + m`` for D data and M model ranks
(``d * tp + m`` without stages), so chunk ``[..., m, d, :]`` of
``partition.host_partition_leaf`` belongs to rank ``d * tp + m`` of its
stage.  Each rank belongs to one data group (the ranks of its stage and model
column: the ZeRO partition and the gradient sum), one model group (the ranks
of its stage and data row: the Megatron shards) and one stage group (the
ranks at its data and model position in every stage: the pipeline's rings).
Under expert parallelism the data group also holds the MoE experts: its
``expert`` group is the data group, and tokens reach their experts through
all-to-alls over it.  Serving a sequence-sharded dense cache splits the
cache's sequence dim over the data group: its ``seq`` group is the data
group, and the decode softmax reduces over it.

``AxisCtx()``, with no groups, is the one-process path: no collective is
issued and every "gather" is a cast.  A group of size 1 still issues every
collective, so the process-group path runs on one card as it would on many.

Every collective goes through the wrappers below, which count calls and
bytes per (group, op) in ``AxisCtx.counts``.  Bytes are those of the full
buffer: the gathered output, the reduce-scatter's input, the all-reduced
tensor, the all-to-all's input.  They call ``all_gather_into_tensor``,
``reduce_scatter_tensor`` and ``all_to_all_single``, which every supported
torch has (2.11 has no ``*_single`` forms of the first two; 2.13 has both,
and warns that these are deprecated), on flat buffers, as gloo wants.
Point-to-point transfers on the stage group (``p2p``) count each send and
each receive, with its bytes.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class AxisCtx:
    """The stage, data and model process groups visible to layer code (None:
    the axis is absent), their sizes and this rank's coordinates."""

    data: dist.ProcessGroup | None = None    # ZeRO partition / gradient sum
    model: dist.ProcessGroup | None = None   # tensor parallel (Megatron)
    stage: dist.ProcessGroup | None = None   # pipeline stages (the rings)
    expert: dist.ProcessGroup | None = None  # MoE experts: the data group under
                                             # expert parallelism, else None
    seq: dist.ProcessGroup | None = None     # the dense cache's sequence dim: the
                                             # data group under seq_shard, else None
    tp: int = 1                              # size of the model group
    ndata: int = 1                           # size of the data group
    nstage: int = 1                          # size of the stage group
    data_index: int = 0                      # d
    model_index: int = 0                     # m
    stage_index: int = 0                     # s
    nseq: int = 1                            # size of the seq group
    seq_index: int = 0                       # this rank's shard of the sequence
    stage_ranks: tuple = ()                  # global ranks of the stage group, by s
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

    def gather_last(self, x: torch.Tensor, group: str) -> torch.Tensor:
        """``[..., n]`` blocks of the group's ranks -> ``[..., size * n]``,
        concatenated on the last dim in rank order (vocab-sharded logits
        made whole).  The gather stacks the blocks on a new leading dim, so
        the result is that dim moved next to the last, then merged."""
        size = dist.get_world_size(getattr(self, group))
        out = torch.empty((size, *x.shape), dtype=x.dtype, device=x.device)
        self.all_gather(out, x.contiguous(), group)
        return out.movedim(0, -2).reshape(*x.shape[:-1], size * x.shape[-1])

    def all_to_all(self, out: torch.Tensor, inp: torch.Tensor, group: str) -> None:
        """``out`` (contiguous) <- block ``i`` of every rank ``i``'s ``inp``,
        in rank order: ``inp`` is ``size`` equal blocks along dim 0, block
        ``j`` sent to rank ``j`` of the group."""
        dist.all_to_all_single(out, inp.contiguous(), group=getattr(self, group))
        self._count(group, "all_to_all", inp)

    def broadcast(self, t: torch.Tensor, group: str, src: int) -> None:
        """In place, from global rank ``src`` of the group."""
        dist.broadcast(t, src=src, group=getattr(self, group))
        self._count(group, "broadcast", t)

    def stage_peer(self, offset: int) -> int:
        """The global rank of stage ``(s + offset) % nstage`` in this rank's
        stage group (peers are passed as global ranks: the card's torch has
        no ``group_peer``)."""
        return self.stage_ranks[(self.stage_index + offset) % self.nstage]

    def p2p(self, sends: list, recvs: list) -> None:
        """One exchange on the stage group: ``sends`` and ``recvs`` are
        ``(tensor, global peer rank)`` pairs, posted in one
        ``batch_isend_irecv`` and waited for before returning.  Between two
        ranks the k-th send meets the k-th receive.  gloo cannot pair a rank
        with itself, so there a transfer to self (a ring of one stage) is a
        copy into the k-th receive from self; it is counted all the same."""
        me = dist.get_rank()
        local = dist.get_backend(self.stage) == "gloo"
        to_self = [t for t, p in sends if p == me] if local else []
        from_self = [t for t, p in recvs if p == me] if local else []
        ops = [dist.P2POp(dist.isend, t, p, self.stage) for t, p in sends
               if not (local and p == me)]
        ops += [dist.P2POp(dist.irecv, t, p, self.stage) for t, p in recvs
                if not (local and p == me)]
        if len(to_self) != len(from_self):
            raise ValueError(f"{len(to_self)} sends to self against {len(from_self)} "
                             f"receives from self")
        works = dist.batch_isend_irecv(ops) if ops else []
        for src, dst in zip(to_self, from_self):
            dst.copy_(src)
        for w in works:
            w.wait()
        for t, _ in sends:
            self._count("stage", "send", t)
        for t, _ in recvs:
            self._count("stage", "recv", t)

    def reset_counts(self) -> None:
        self.counts.clear()


LOCAL = AxisCtx()   # one process, no groups: issues no collective


class AllToAll(torch.autograd.Function):
    """``AxisCtx.all_to_all`` over ``group``, differentiable: with equal
    blocks the exchange is its own transpose, so the backward sends each
    block of the cotangent back where it came from."""

    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        axis.all_to_all(out, x, group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g, memory_format=torch.contiguous_format)
        ctx.axis.all_to_all(out, g, ctx.group)
        return out, None, None


def with_expert_group(axis: AxisCtx) -> AxisCtx:
    """``axis`` with its data group as the expert group (expert
    parallelism over the data group; the JAX package's ``expert="data"``)."""
    return dataclasses.replace(axis, expert=axis.data)


def with_seq_group(axis: AxisCtx) -> AxisCtx:
    """``axis`` with its data group as the seq group (a sequence-sharded
    dense cache; the JAX package's ``seq="data"``).  Without a data group
    the cache is one shard, and ``axis`` is returned as it is."""
    if axis.data is None:
        return axis
    return dataclasses.replace(axis, seq=axis.data, nseq=axis.ndata, seq_index=axis.data_index)


def make_axis(ndata: int, tp: int, nstage: int = 1) -> AxisCtx:
    """This rank's ``AxisCtx`` over an initialised default group of
    ``nstage * ndata * tp`` ranks.  Every rank creates every group, in one
    order, as ``dist.new_group`` requires."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != nstage * ndata * tp:
        raise ValueError(f"a {nstage}x{ndata}x{tp} (stage x data x model) mesh needs "
                         f"{nstage * ndata * tp} processes, the group has {world}")
    s, rest = divmod(rank, ndata * tp)
    d, m = divmod(rest, tp)
    at = lambda ss, dd, mm: (ss * ndata + dd) * tp + mm  # noqa: E731
    data = model = stage = None
    for ss in range(nstage):
        for mm in range(tp):
            g = dist.new_group([at(ss, dd, mm) for dd in range(ndata)])
            data = g if (ss, mm) == (s, m) else data
    for ss in range(nstage):
        for dd in range(ndata):
            g = dist.new_group([at(ss, dd, mm) for mm in range(tp)])
            model = g if (ss, dd) == (s, d) else model
    for dd in range(ndata):
        for mm in range(tp):
            g = dist.new_group([at(ss, dd, mm) for ss in range(nstage)])
            stage = g if (dd, mm) == (d, m) else stage
    return AxisCtx(data=data, model=model, stage=stage, tp=tp, ndata=ndata, nstage=nstage,
                   data_index=d, model_index=m, stage_index=s,
                   stage_ranks=tuple(at(ss, d, m) for ss in range(nstage)))


def under_launcher() -> bool:
    """True inside ``python -m torch.distributed.run`` (it sets WORLD_SIZE)."""
    return "WORLD_SIZE" in os.environ


def from_env(ndata: int, tp: int, device: torch.device, nstage: int = 1) -> AxisCtx:
    """Join the group ``torch.distributed.run`` describes in the environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL on the
    card, each rank on card LOCAL_RANK, gloo on the CPU.  The caller ends it
    with ``dist.destroy_process_group()``."""
    world = int(os.environ["WORLD_SIZE"])
    if world != nstage * ndata * tp:
        raise ValueError(f"{nstage} stages of --mesh {ndata}x{tp} need "
                         f"{nstage * ndata * tp} processes, WORLD_SIZE is {world}")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, rank=int(os.environ["RANK"]), world_size=world)
    return make_axis(ndata, tp, nstage)
