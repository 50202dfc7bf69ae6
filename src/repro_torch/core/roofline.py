"""Roofline constants, the collectives' wire factors and a counter of the
port's own work (counterpart of ``repro/core/roofline.py``).

The JAX package counts a step's dot flops by walking its jaxpr
(``walk_jaxpr``): every ``dot_general``, times the trip counts of the scans
around it.  The walk never enters a ``pallas_call``, so a kernel's own dots
(the flash attention's QKᵀ and PV) are left out of its counts; with the
kernels off the model runs a plain attention, whose dots are counted in
full, S×S.  The port has no jaxpr: ``DotCounter`` is a dispatch mode that
counts the matrix products torch runs while it is active, on real tensors
or on ``meta`` tensors (shapes only, nothing allocated: a full-width layer
costs nothing to count).  ``kernels/ops.py`` marks the flash attention's
work (the one kernel on a counted path whose plain version holds matrix
products), on the card its launch and on the CPU or ``meta`` its plain
version, and the counter sees it as one opaque call, as the walk sees a
``pallas_call``; ``see=("flash_attention",)`` makes it count the
attention's plain dots, as the walk does with the kernels off.

Constants: the NVIDIA H100 SXM 80GB's data-sheet figures at its 700 W power
limit (the JAX package's are a TPU's: 197e12, 819e9 and 50e9).

  compute    = dot_flops / PEAK_FLOPS        (dense bf16, tensor cores)
  memory     = hbm_bytes / HBM_BW
  collective = wire_bytes / LINK_BW           (one NVLink direction a GPU)

Wire bytes, as in the JAX package (bandwidth-optimal rings, the paper's
appendix C.4): ``COLLECTIVES[op](n)`` times the full buffer (the gathered
output, the reduce-scatter's input, the all-reduced tensor, the sent one):
the bytes ``core/dist.py`` counts per (group, op).
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import ops as kops

# --- NVIDIA H100 SXM 80GB, data sheet, at its 700 W power limit --------------
PEAK_FLOPS = 989e12        # dense bf16 tensor-core flops/s (H100 SXM, 700 W)
HBM_BW = 3.35e12           # HBM3 bytes/s (H100 SXM 80GB, 700 W)
LINK_BW = 450e9            # NVLink 4 bytes/s, one direction of a GPU's 900 GB/s
                           # (H100 SXM, 700 W): the ring collectives' link

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


class DotCounter(TorchDispatchMode):
    """Counts the dot flops (2 x output elements x contraction length of
    every matrix product) torch runs while active.  The work of a kernel
    ``kernels/ops.py`` marks (the flash attention) is not counted, unless
    ``see`` names it."""

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
                a = args[1] if op in _BIASED else args[0]
                self.flops += 2.0 * out.numel() * a.shape[-1]
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
