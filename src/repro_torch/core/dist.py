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

Pods (the JAX package's ``pod`` mesh axis, ``AccumConfig.span_pods``) are a
second, slow data-parallel dim in front of the data one: rank order
``rank = (p * D + d) * M + m``, the mesh ``("pod", "data", "model")``.  Each
rank's ``pod`` group holds the ranks at its data and model position in every
pod, and its ``part`` group the ``npod * ndata`` ranks of its model column
across pods: the ZeRO partition under ``span_pods``, in which rank ``(p, d)``
holds chunk ``p * ndata + d``.  The global batch splits over ``(pod, data)``,
pod major.  Pods and pipeline stages do not mix (the JAX package's pipeline
has no pod axis).

A dry run (``launch/dryrun.py``) builds one rank's grid in one process:
``fake_grid`` makes this process rank 0 of a default group of torch's
``fake`` backend, whose collectives issue nothing (they are still counted),
and ``production_grid`` is the JAX package's ``make_production_mesh``:
16 x 16 ranks, or 2 x 16 x 16 with pods.

A grid may also live on a subset of the default group's ranks (``ranks``):
the survivors of a failure-shrink.  Its ``world`` group then holds those
ranks, and every collective of the grid runs on its own groups, never on
the default group, which still counts the ranks that left.

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

import contextlib
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
    pod: dist.ProcessGroup | None = None     # the slow data-parallel dim (pods)
    part: dist.ProcessGroup | None = None    # pod x data: the ZeRO partition under span_pods
    world: dist.ProcessGroup | None = None   # every rank of the grid (None: the default group)
    npod: int = 1                            # size of the pod group
    pod_index: int = 0                       # p
    ranks: tuple = ()                        # global ranks of the grid, in mesh order
    # (group name, op) -> [calls, bytes]
    counts: dict = dataclasses.field(default_factory=dict)

    @property
    def dp(self) -> int:
        """The data-parallel width: ``npod * ndata`` (the batch's split)."""
        return self.npod * self.ndata

    @property
    def dp_index(self) -> int:
        """This rank's place on the ``(pod, data)`` dims, pod major."""
        return self.pod_index * self.ndata + self.data_index

    def zero_size(self, group: str) -> int:
        """The ranks of a ZeRO partition's group (``zero_group``'s)."""
        return self.dp if group == "part" else self.ndata

    def zero_index(self, group: str) -> int:
        """This rank's chunk of a ZeRO partition over ``group``."""
        return self.dp_index if group == "part" else self.data_index

    @property
    def pods(self) -> bool:
        """Whether the grid has a pod dim (a pod group, if only of one)."""
        return self.pod is not None or self.npod > 1

    def zero_group(self, span_pods: bool) -> str:
        """The group the ZeRO chunks are cut over: ``part`` (pod x data)
        under ``span_pods`` on a grid with pods, else ``data``."""
        return "part" if span_pods and self.pods else "data"

    def all_reduce_dp(self, t: torch.Tensor) -> None:
        """In place: the sum over the data group, then over the pod group
        (the JAX package's psum over ``data`` and ``pod``)."""
        if self.data is not None:
            self.all_reduce(t, "data")
        if self.pod is not None:
            self.all_reduce(t, "pod")

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


def make_axis(ndata: int, tp: int, nstage: int = 1, *, npod: int | None = None,
              ranks=None) -> AxisCtx | None:
    """This rank's ``AxisCtx`` over an ``nstage`` (or ``npod``) x ``ndata`` x
    ``tp`` grid of the initialised default group's ranks: all of them, or
    the global ``ranks`` given, in mesh order.  ``npod`` (None: no pod dim)
    gives the grid a pod dim of that size, 1 included, as a JAX mesh may
    have a ``pod`` axis of one device.  Every running rank of the
    default group calls it, in one order, as ``dist.new_group`` requires
    (torch names a group by a per-process count of the groups made, so
    ranks that will share a group must have made the same groups before);
    a rank outside ``ranks`` gets None.  A rank that has left the run (a
    failure-shrink's) need not: making a group issues no collective on the
    default group."""
    pods = npod is not None
    if pods and nstage > 1:
        raise ValueError(f"{npod} pods with {nstage} pipeline stages: the JAX package's "
                         f"pipeline and tick profiler have no pod axis")
    world = dist.get_world_size()
    ranks = tuple(range(world)) if ranks is None else tuple(ranks)
    nlead = nstage * (npod or 1)
    if len(ranks) != nlead * ndata * tp:
        what = "pod" if pods else "stage"
        raise ValueError(f"a {nlead}x{ndata}x{tp} ({what} x data x model) mesh needs "
                         f"{nlead * ndata * tp} processes, it was given {len(ranks)}")
    me = dist.get_rank()
    pos = ranks.index(me) if me in ranks else None
    q, rest = divmod(pos, ndata * tp) if pos is not None else (-1, 0)
    d, m = divmod(rest, tp) if pos is not None else (-1, -1)
    at = lambda qq, dd, mm: ranks[(qq * ndata + dd) * tp + mm]  # noqa: E731
    data = model = stage = pod = part = None
    for qq in range(nlead):
        for mm in range(tp):
            g = dist.new_group([at(qq, dd, mm) for dd in range(ndata)])
            data = g if (qq, mm) == (q, m) else data
    for qq in range(nlead):
        for dd in range(ndata):
            g = dist.new_group([at(qq, dd, mm) for mm in range(tp)])
            model = g if (qq, dd) == (q, d) else model
    for dd in range(ndata):
        for mm in range(tp):
            g = dist.new_group([at(qq, dd, mm) for qq in range(nlead)])
            if (dd, mm) == (d, m):
                pod, stage = (g, None) if pods else (None, g)
    if pods:
        for mm in range(tp):
            g = dist.new_group([at(qq, dd, mm) for qq in range(npod) for dd in range(ndata)])
            part = g if mm == m else part
    grid = dist.new_group(list(ranks)) if len(ranks) < world else None
    if pos is None:
        return None
    s, p = (0, q) if pods else (q, 0)
    return AxisCtx(data=data, model=model, stage=stage, pod=pod, part=part, world=grid,
                   tp=tp, ndata=ndata, nstage=nstage, npod=npod or 1, data_index=d,
                   model_index=m, stage_index=s, pod_index=p, ranks=ranks,
                   stage_ranks=(me,) if pods else tuple(at(ss, d, m) for ss in range(nstage)))


def under_launcher() -> bool:
    """True inside ``python -m torch.distributed.run`` (it sets WORLD_SIZE)."""
    return "WORLD_SIZE" in os.environ


def from_env(ndata: int, tp: int, device: torch.device, nstage: int = 1, *,
             npod: int | None = None) -> AxisCtx:
    """Join the group ``torch.distributed.run`` describes in the environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL on the
    card, each rank on card LOCAL_RANK, gloo on the CPU.  The caller ends it
    with ``dist.destroy_process_group()``."""
    world = int(os.environ["WORLD_SIZE"])
    n = nstage * (npod or 1) * ndata * tp
    if world != n:
        lead = f"{npod} pods" if npod is not None else f"{nstage} stages"
        raise ValueError(f"{lead} of --mesh {ndata}x{tp} need {n} processes, WORLD_SIZE "
                         f"is {world}")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, rank=int(os.environ["RANK"]), world_size=world)
    return make_axis(ndata, tp, nstage, npod=npod)


@contextlib.contextmanager
def fake_grid(ndata: int, tp: int, *, npod: int | None = None):
    """This process as rank 0 of a ``(npod x) ndata x tp`` grid over a
    default group of torch's ``fake`` backend: every group is made, every
    collective is counted and none is issued, so a step runs on ``meta``
    tensors as rank 0 would run it.  Yields rank 0's ``AxisCtx`` and
    destroys the group on leaving.  Refuses to start beside a group that
    already exists, so a dry run never joins a real run."""
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists: a dry run makes its "
                           "own fake group and never joins a real one")
    # importing the module registers the backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = (npod or 1) * ndata * tp
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield make_axis(ndata, tp, npod=npod)
    finally:
        dist.destroy_process_group()


def production_grid(*, multi_pod: bool = False, mesh_shape: str | None = None):
    """The production grid of a dry run (the JAX package's
    ``make_production_mesh``): ``fake_grid`` of 16 x 16 ranks, of 2 pods x
    16 x 16 under ``multi_pod``, or ``mesh_shape`` ("DxM") when given, a
    data x model split of the same 256 ranks."""
    if mesh_shape:
        d, m = (int(v) for v in mesh_shape.split("x"))
        if d * m != 256:
            raise ValueError(f"--mesh-shape {mesh_shape} is not a split of 256 ranks")
        return fake_grid(d, m)
    return fake_grid(16, 16, npod=2 if multi_pod else None)
