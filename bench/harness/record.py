"""What a run hands the per-layer readers in ``bench/metrics``: the cell's
files, the window's host-clock counts and spans, and, in a traced run, the
device trace of its traced stretch and the shapes of the attention calls
made there.  A reader takes what it needs and returns None where the run
has nothing for it."""
from __future__ import annotations

import contextlib
import dataclasses

from bench.harness.profiling import Trace


@dataclasses.dataclass
class RunRecord:
    kind: str                       # "train" | "serve"
    conf: dict
    traffic: dict
    workload: dict
    chips: int = 1
    window_s: float = 0.0
    # training: steps completed in the window, host seconds of each step's call
    steps: int = 0
    enqueue_s: list = dataclasses.field(default_factory=list)
    # serving: (prompt length, due time, token wall times), seconds from the
    # window's start, per request
    requests: list = dataclasses.field(default_factory=list)
    # serving: the engine's prefill and decode spans in the window (seconds), and
    # the real prompt tokens its prefills took (its own counter)
    prefill_spans: list = dataclasses.field(default_factory=list)
    decode_spans: list = dataclasses.field(default_factory=list)
    prefill_tokens: int = 0
    # the traced stretch: its trace, its training steps, and the attention
    # calls made in it
    trace: Trace | None = None
    traced_steps: int = 0
    attn_calls: list = dataclasses.field(default_factory=list)
    paged_calls: list = dataclasses.field(default_factory=list)


@contextlib.contextmanager
def attention_spy(rec: RunRecord):
    """Records the shapes of every attention call the port makes through
    its kernel entries while the body runs: ``(B, Sq, Sk, Hq, Hkv, hd,
    with_backward)`` for ``flash_attention``, ``(rows, Hq, Hkv, hd,
    context_lens)`` for ``paged_attention``."""
    import torch
    from repro_torch.kernels import ops
    flash, paged = ops.flash_attention, ops.paged_attention

    def flash_spy(q, k, v, **kw):
        rec.attn_calls.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
                               q.shape[3], torch.is_grad_enabled() and q.requires_grad))
        return flash(q, k, v, **kw)

    def paged_spy(q, k_pool, v_pool, block_tables, context_lens, **kw):
        rec.paged_calls.append((q.shape[0], q.shape[1], k_pool.shape[1], q.shape[2],
                                context_lens.detach().clone()))
        return paged(q, k_pool, v_pool, block_tables, context_lens, **kw)

    ops.flash_attention, ops.paged_attention = flash_spy, paged_spy
    try:
        yield
    finally:
        ops.flash_attention, ops.paged_attention = flash, paged
