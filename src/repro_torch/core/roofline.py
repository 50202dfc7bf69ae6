"""Roofline constants, the collectives' wire factors, and the port's
counterparts of the JAX walk: a counter of dot flops and ``analyze``, one
rank's costs and peak memory of a step (counterpart of
``repro/core/roofline.py``).

The JAX package counts a step's costs by walking its jaxpr
(``walk_jaxpr``): every ``dot_general``, times the trip counts of the scans
around it.  The walk never enters a ``pallas_call``, so a kernel's own dots
(the flash attention's QKᵀ and PV) are left out of its counts; with the
kernels off the model runs a plain attention, whose dots are counted in
full, S×S.  The port has no jaxpr: a dispatch mode takes the walk's place.
It sees every aten op torch runs while it is active, loops unrolled (no
trip count is needed), on real tensors or on ``meta`` tensors (shapes only,
nothing allocated: a full-width step costs nothing to count).
``kernels/ops.py`` marks every kernel's work, on the card its launch and on
the CPU or ``meta`` its plain version, and the modes see it as one opaque
call, as the walk sees a ``pallas_call``; ``see=("flash_attention",)``
makes them count the attention's plain dots, as the walk does with the
kernels off.  ``DotCounter`` counts dot flops alone.

Constants: the NVIDIA H100 SXM 80GB's data-sheet figures at its 700 W power
limit (the JAX package's are a TPU's: 197e12, 819e9 and 50e9).

  compute    = dot_flops / PEAK_FLOPS        (dense bf16, tensor cores)
  memory     = hbm_bytes / HBM_BW
  collective = wire_bytes / LINK_BW           (one NVLink direction a GPU;
                                               the pod axis at POD_BW)

Wire bytes, as in the JAX package (bandwidth-optimal rings, the paper's
appendix C.4): ``COLLECTIVES[op](n)`` times the full buffer (the gathered
output, the reduce-scatter's input, the all-reduced tensor, the sent one):
the bytes ``core/dist.py`` counts per (group, op).

``analyze`` runs a step once, on ``meta`` tensors (over a fake process
group for a production grid, ``core/dist.py:fake_grid``), and returns one
rank's ``Costs``.  It counts, as the walk does:

  dot_flops   every matrix product (``DotCounter``'s rule), a marked
              kernel's left out unless ``see`` names it;
  hbm_bytes   a traffic model, not a measurement: the inputs and outputs
              of every counted matrix product and of every collective (from
              ``AxisCtx.counts``: an all-gather reads 1/n of what it
              writes, a reduce-scatter writes 1/n of what it reads), the
              output of a gather or index op, the update operand of a write
              into part of a buffer; in place of the walk's scan xs ("the
              stacked leaves a scan reads"), a layer's slice of each stacked
              leaf of the arguments each time the step selects it (once a
              pass); nothing for a marked kernel's own traffic, as the walk
              never enters a ``pallas_call``;
  coll_bytes  wire bytes by the JAX package's mesh axis: ``data``,
              ``model``, ``pod``, ``stage``; the expert and seq groups are
              the data group, and a collective over ``part`` (pod x data)
              counts on each axis at that axis's size, as the walk counts a
              collective over ``("pod", "data")``.

A ``cond`` has no counterpart: the walk weighs a cond's branches
(``cond_weight``); the port counts the branch that ran.

Beside the costs, ``analyze`` tracks the storages live while the step runs
(the counterpart of ``compiled.memory_analysis()``): ``Costs.memory``.  A
marked kernel's work counts as its outputs and what it saves, never its
plain version's temporaries (the plain flash attention's ``[B, H, S, S]``
scores, the plain AdamW's fp32 copies), which the kernels on the card do
not form.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import ops as kops

# --- NVIDIA H100 SXM 80GB, data sheet, at its 700 W power limit --------------
PEAK_FLOPS = 989e12        # dense bf16 tensor-core flops/s (H100 SXM, 700 W)
HBM_BW = 3.35e12           # HBM3 bytes/s (H100 SXM 80GB, 700 W)
LINK_BW = 450e9            # NVLink 4 bytes/s, one direction of a GPU's 900 GB/s
                           # (H100 SXM, 700 W): the ring collectives' link
POD_BW = 50e9              # bytes/s a GPU between pods: one 400 Gb/s NDR
                           # InfiniBand port per GPU (DGX H100 data sheet:
                           # 8 ConnectX-7 ports for 8 GPUs)

# Wire bytes of a group of n over the full buffer, by ``core/dist.py`` op:
# the JAX package's factors for all_gather, psum_scatter, psum and ppermute.
# A receive is the other end of a counted send, no wire of its own.
COLLECTIVES = {
    "all_gather": lambda n: (n - 1) / n,
    "reduce_scatter": lambda n: (n - 1) / n,
    "all_reduce": lambda n: 2 * (n - 1) / n,
    "all_to_all": lambda n: (n - 1) / n,
    "send": lambda n: 1.0,
}

# The sequence length past which the JAX model leaves its flash kernel for a
# query-chunked plain attention (``repro/models/attention.py``): the
# counter follows the reference's path, whose dots it counts there
CHUNKED_THRESHOLD = 8192

_aten = torch.ops.aten
_DOTS = {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm, _aten.mv, _aten.addmv,
         _aten.dot}
_BIASED = {_aten.addmm, _aten.baddbmm, _aten.addmv}     # (bias, a, b)


def _dot_flops(op, args, out) -> float:
    a = args[1] if op in _BIASED else args[0]
    return 2.0 * out.numel() * a.shape[-1]


class DotCounter(TorchDispatchMode):
    """Counts the dot flops (2 x output elements x contraction length of
    every matrix product) torch runs while active.  The work of a kernel
    ``kernels/ops.py`` marks is not counted, unless ``see`` names it."""

    def __init__(self, see=()):
        super().__init__()
        self.see = frozenset(see)
        self.flops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        op = func.overloadpacket
        if op in _DOTS:
            k = kops.current_kernel()
            if k is None or k in self.see:
                self.flops += _dot_flops(op, args, out)
        return out


def count_dots(fn, *args, see=(), **kwargs) -> float:
    """Dot flops of ``fn(*args, **kwargs)`` (see ``DotCounter``)."""
    with DotCounter(see) as c:
        fn(*args, **kwargs)
    return c.flops


def attention_seen(cfg, seq: int) -> tuple:
    """The kernels ``count_dots`` should look into for the JAX model's path
    at ``seq``: its plain attention runs with the kernels off, and past
    ``CHUNKED_THRESHOLD`` whatever they say; its flash kernel otherwise.
    (Past the threshold the reference pads the queries of a ragged sequence
    to a multiple of 512; the counter counts the S×S of the unpadded ones.)"""
    return () if cfg.kernels and seq <= CHUNKED_THRESHOLD else ("flash_attention",)


def wire_bytes(counts: dict, sizes: dict) -> dict:
    """``core/dist.py``'s per (group, op) ``[calls, bytes]`` -> wire bytes a
    group, at ``COLLECTIVES``' factors for the group's size in ``sizes``.
    A group of one moves nothing over a wire, as in the JAX walk."""
    out: dict = {}
    for (group, op), (_, nbytes) in counts.items():
        n = sizes.get(group, 1)
        if op == "recv" or n <= 1:
            continue
        out[group] = out.get(group, 0.0) + COLLECTIVES[op](n) * nbytes
    return out


# ---------------------------------------------------------------------------
# One rank's costs and memory of a step: ``analyze``
# ---------------------------------------------------------------------------
# The JAX package's mesh axes each ``AxisCtx`` group spans
GROUP_AXES = {"data": ("data",), "model": ("model",), "stage": ("stage",), "pod": ("pod",),
              "part": ("pod", "data"), "expert": ("data",), "seq": ("data",)}

# HBM bytes a collective moves on a rank, in and out, over the full buffer of
# ``core/dist.py``'s count, for a group of n
_COLL_HBM = {
    "all_gather": lambda n: 1 + 1 / n,
    "reduce_scatter": lambda n: 1 + 1 / n,
    "all_reduce": lambda n: 2.0,
    "all_to_all": lambda n: 2.0,
    "broadcast": lambda n: 2.0,
    "send": lambda n: 1.0,
    "recv": lambda n: 1.0,
}


@dataclasses.dataclass
class Costs:
    """One rank's cost accounting (the JAX package's ``Costs``; ``summary``
    has its keys): wire bytes by axis (``coll_bytes``) and by (axis, op)
    (``coll_op_bytes``), calls by (axis, op); and ``memory``, the peak
    memory of the step that ``analyze`` ran: ``argument_bytes``,
    ``temp_bytes``, ``output_bytes`` and ``device_bytes``."""
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    coll_counts: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    notes: list = dataclasses.field(default_factory=list)
    memory: dict = dataclasses.field(default_factory=dict)
    coll_op_bytes: dict = dataclasses.field(default_factory=lambda: defaultdict(float))

    # -- roofline terms ----------------------------------------------------
    def compute_s(self) -> float:
        return self.dot_flops / PEAK_FLOPS

    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    def collective_s(self) -> float:
        return sum(b / (POD_BW if ax == "pod" else LINK_BW)
                   for ax, b in self.coll_bytes.items())

    def dominant(self) -> str:
        terms = {"compute": self.compute_s(), "memory": self.memory_s(),
                 "collective": self.collective_s()}
        return max(terms, key=terms.get)

    def summary(self) -> dict:
        return {
            "dot_flops": self.dot_flops,
            "hbm_bytes": self.hbm_bytes,
            "coll_bytes": dict(self.coll_bytes),
            "compute_s": self.compute_s(),
            "memory_s": self.memory_s(),
            "collective_s": self.collective_s(),
            "dominant": self.dominant(),
        }


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor):
    return t.untyped_storage()._cdata


def _tensors_with_path(tree, path: tuple = ()):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors_with_path(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensors_with_path(v, path + (i,))


_GATHERS = {_aten.index_select, _aten.embedding, _aten.gather, _aten.index}
# a write into part of a buffer -> the position of its update operand
_WRITES = {_aten.index_put: 2, _aten.index_put_: 2, _aten.scatter: 3, _aten.scatter_: 3,
           _aten.scatter_add: 3, _aten.scatter_add_: 3, _aten.index_copy: 3,
           _aten.index_copy_: 3, _aten.index_add: 3, _aten.index_add_: 3,
           _aten.slice_scatter: 1, _aten.select_scatter: 1}


class _Analyzer(TorchDispatchMode):
    """``analyze``'s dispatch mode: the flops and bytes of every op (see
    the module docstring), and the live storages.  A storage is counted
    from the op that makes it until a weakref says it is gone; one a
    marked kernel's work makes waits until the work ends
    (``kops.exit_hooks``), and counts only if it is still alive then
    (an output, or saved for the backward)."""

    def __init__(self, see, args_keys: dict, stacked: set):
        super().__init__()
        self.see = frozenset(see)
        self.args_keys = args_keys          # storages of the arguments -> bytes
        self.stacked = stacked              # storages of the stacked layer leaves
        self.costs = Costs()
        self.live: dict = {}
        self.pending: dict = {}
        self.finalizers: dict = {}
        self.cur = self.peak = 0

    def _free(self, key) -> None:
        self.finalizers.pop(key, None)
        nb = self.live.pop(key, None)
        if nb is not None:
            self.cur -= nb
        else:
            self.pending.pop(key, None)

    def _add(self, key, nb: int) -> None:
        self.live[key] = nb
        self.cur += nb
        self.peak = max(self.peak, self.cur)

    def settle(self) -> None:
        """A marked kernel's work has ended: what it made and still lives
        counts from now."""
        pending, self.pending = self.pending, {}
        for key, nb in pending.items():
            self._add(key, nb)

    def _track(self, out, in_kernel: bool) -> None:
        for t in pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.args_keys or key in self.live or key in self.pending:
                continue
            self.finalizers[key] = weakref.finalize(st, self._free, key)
            if in_kernel:
                self.pending[key] = st.nbytes()
            else:
                self._add(key, st.nbytes())

    def __enter__(self):
        kops.exit_hooks().append(self.settle)
        return super().__enter__()

    def __exit__(self, *exc):
        kops.exit_hooks().remove(self.settle)
        self.settle()
        for f in self.finalizers.values():
            f.detach()
        self.finalizers.clear()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        k = kops.current_kernel()
        self._track(out, k is not None)
        if k is not None and k not in self.see:
            return out
        op, c = func.overloadpacket, self.costs
        if op in _DOTS:
            c.dot_flops += _dot_flops(op, args, out)
            c.hbm_bytes += sum(_nbytes(a) for a in args if isinstance(a, torch.Tensor))
            c.hbm_bytes += _nbytes(out)
        elif op in _GATHERS:
            c.hbm_bytes += _nbytes(out)
        elif op in _WRITES:
            upd = args[_WRITES[op]] if len(args) > _WRITES[op] else None
            if isinstance(upd, torch.Tensor):
                c.hbm_bytes += _nbytes(upd)
        elif op is _aten.copy_:
            dst = args[0]
            if _nbytes(dst) < dst.untyped_storage().nbytes():
                c.hbm_bytes += _nbytes(dst)
        elif op is _aten.select and args[1] == 0 and _storage_key(args[0]) in self.stacked:
            c.hbm_bytes += _nbytes(out)
        return out


def _group_size(axis, group: str) -> int:
    return {"data": axis.ndata, "model": axis.tp, "stage": axis.nstage, "pod": axis.npod,
            "part": axis.dp, "expert": axis.ndata, "seq": axis.nseq}.get(group, 1)


def _add_collectives(costs: Costs, axis, before: dict) -> None:
    """The collectives ``axis.counts`` gained since ``before``: their HBM
    bytes, and their wire bytes and calls by the JAX package's mesh axis."""
    sizes = {"data": axis.ndata, "model": axis.tp, "pod": axis.npod, "stage": axis.nstage}
    for (group, op), (calls, nb) in axis.counts.items():
        c0, b0 = before.get((group, op), (0, 0))
        calls, nb = calls - c0, nb - b0
        if not calls:
            continue
        costs.hbm_bytes += _COLL_HBM[op](_group_size(axis, group)) * nb
        if op == "recv":      # the other end of a counted send
            continue
        if op not in COLLECTIVES:
            costs.notes.append(f"{group}:{op}: no wire factor, not counted")
            continue
        for ax in GROUP_AXES.get(group, ()):
            n = sizes[ax]
            if n <= 1:
                continue
            wire = COLLECTIVES[op](n) * nb
            costs.coll_bytes[ax] += wire
            costs.coll_op_bytes[(ax, op)] += wire
            costs.coll_counts[(ax, op)] += calls


def _storage_bytes(tensors, skip=()) -> dict:
    out: dict = {}
    for t in tensors:
        key = _storage_key(t)
        if key not in skip:
            out[key] = t.untyped_storage().nbytes()
    return out


def analyze(fn, *args, axis=None, see=()) -> Costs:
    """Run ``fn(*args)`` (one rank's step, on ``meta`` tensors: nothing is
    allocated and a fake group issues no collective) and return its
    ``Costs``, collectives from ``axis.counts`` (``axis`` the step's
    ``AxisCtx``; None: no groups), and its memory: ``argument_bytes`` (the
    storages of ``args``), ``temp_bytes`` (the peak of every other live
    storage), ``output_bytes`` (what ``fn`` returns that is not an
    argument) and ``device_bytes`` (temp plus argument, as the JAX package
    reports ``memory_analysis()``).  ``see`` as ``DotCounter``'s."""
    leaves = list(_tensors_with_path(args))
    args_keys = _storage_bytes(t for _, t in leaves)
    stacked = {_storage_key(t) for path, t in leaves if "layers" in path and t.dim() > 0}
    before = {k: list(v) for k, v in axis.counts.items()} if axis is not None else {}
    mode = _Analyzer(see, args_keys, stacked)
    with mode:
        out = fn(*args)
    costs = mode.costs
    if axis is not None:
        _add_collectives(costs, axis, before)
    out_bytes = _storage_bytes((t for _, t in _tensors_with_path(out)), skip=args_keys)
    arg = sum(args_keys.values())
    costs.memory = {"device_bytes": mode.peak + arg, "temp_bytes": mode.peak,
                    "argument_bytes": arg, "output_bytes": sum(out_bytes.values())}
    return costs


def model_flops_train(cfg, global_batch: int, seq: int) -> float:
    """6*N*D rule (paper appendix C.1: fwd 2ND + bwd 4ND; +2ND with full
    activation recompute, not counted), N the parameters a token runs
    through (an MoE layer's routed experts, not all of them)."""
    return 6.0 * cfg.param_count(active_only=True) * global_batch * seq


def model_flops_decode(cfg, global_batch: int) -> float:
    return 2.0 * cfg.param_count(active_only=True) * global_batch


def mfu(flops_per_step: float, step_time_s: float, *, n_devices: int = 1,
        peak_flops: float | None = None) -> float:
    """Model-flops utilization: model flops of one step over the flops the
    cards could have delivered in its wall time, at ``PEAK_FLOPS`` a card
    unless ``peak_flops`` is given."""
    peak = PEAK_FLOPS if peak_flops is None else peak_flops
    if step_time_s <= 0 or peak <= 0 or n_devices <= 0:
        return 0.0
    return flops_per_step / (step_time_s * n_devices * peak)
