"""Continuous-batching scheduler: request lifecycle under a block budget.

The scheduling problem the paper's memory-vs-bandwidth argument implies for
inference: KV memory is cheap to *hold* but expensive to *move*, so the
engine should keep the decode batch as full as the block pool allows —
admitting new prefills into a running decode batch (continuous batching)
instead of draining it (static batching).

Request lifecycle:

  waiting --admit--> running --finish--> finished
     ^                  |
     +----preempt-------+

* **Admission** is FIFO over arrived requests: a request is admitted when a
  batch slot is free and the allocator can cover its whole prompt
  (``ceil(len / block_size)`` blocks).  Head-of-line order is preserved —
  a big request at the head is not overtaken by smaller ones (no starvation).
* **Growth**: each decode step writes one token; when a request crosses a
  block boundary it needs one more block.  ``ensure_block`` grabs it from
  the free list, and if the pool is exhausted it **preempts**: the
  lowest-priority (then youngest) running request is evicted — its blocks
  freed, its table dropped — and re-queued for *recompute* (its prompt plus
  everything it generated so far becomes the new prefill), vLLM-style.  A
  request never evicts a higher-priority one for growth, and evicting
  yourself means you just wait.
* **Static mode** (the benchmark baseline) admits only into an empty batch:
  the classic serve loop whose stragglers hold slots idle.

Everything here is host-side Python between model steps; the device side
(block tables, pool writes) lives in steps.py/engine.py.  A copy of
``repro/serving/scheduler.py``, kept in the port so it imports nothing of
``repro``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Iterable

from repro_torch.serving.cache import BlockAllocator, PagedCacheConfig


@dataclasses.dataclass
class Request:
    """One generation request and its runtime state."""

    rid: int
    prompt: tuple[int, ...]
    max_new_tokens: int
    arrival: int = 0                 # engine step at which it becomes visible
    eos_id: int | None = None
    priority: int = 0                # higher survives preemption longer

    # -- runtime (owned by the scheduler/engine) ------------------------
    generated: list[int] = dataclasses.field(default_factory=list)
    state: str = "waiting"           # waiting | running | finished
    context: tuple[int, ...] = ()    # tokens to (re)prefill on admission
    cached: int = 0                  # tokens with K/V in the pool
    blocks: list[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    pending: int | None = None       # last emitted token = next decode input
    preemptions: int = 0
    finish_step: int = -1
    # wall-clock latency telemetry (obs/metrics percentiles)
    wall_visible: float | None = None   # host time the engine first saw it
    wall_admitted: float | None = None  # host time of its first admission
    token_walls: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.prompt = tuple(self.prompt)
        if not self.context:
            self.context = self.prompt

    @property
    def done(self) -> bool:
        if len(self.generated) >= self.max_new_tokens:
            return True
        return bool(self.generated and self.eos_id is not None
                    and self.generated[-1] == self.eos_id)

    def total_tokens(self) -> int:
        return len(self.prompt) + self.max_new_tokens


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    cache: PagedCacheConfig
    max_batch: int                   # decode slots (R)
    mode: str = "continuous"         # continuous | static

    def __post_init__(self):
        assert self.mode in ("continuous", "static"), self.mode


class Scheduler:
    def __init__(self, cfg: SchedulerConfig):
        self.cfg = cfg
        self.alloc = BlockAllocator(cfg.cache.num_blocks)
        self.waiting: deque[Request] = deque()
        self.running: list[Request] = []
        self._free_slots = list(range(cfg.max_batch - 1, -1, -1))

    # -- submission ------------------------------------------------------
    def submit(self, req: Request) -> None:
        cap = self.cfg.cache.max_context
        if req.total_tokens() > cap:
            raise ValueError(
                f"request {req.rid}: {req.total_tokens()} tokens exceed the "
                f"{cap}-token table capacity")
        if self.cfg.cache.blocks_for(req.total_tokens()) > self.alloc.num_blocks:
            raise ValueError(
                f"request {req.rid}: needs more blocks than the whole pool "
                f"({self.alloc.num_blocks}) — it could never run")
        req.state = "waiting"
        self.waiting.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # -- preemption ------------------------------------------------------
    def _preempt(self, req: Request) -> None:
        """Evict: free the blocks, re-queue for recompute-prefill.  The
        tokens already emitted stay emitted; the re-prefill covers prompt +
        generated so the next prefill's output token continues the stream."""
        self.alloc.free(req.blocks)
        req.blocks = []
        req.cached = 0
        req.context = req.prompt + tuple(req.generated)
        req.pending = None
        req.preemptions += 1
        req.state = "waiting"
        self.running.remove(req)
        self._free_slots.append(req.slot)
        req.slot = -1
        self.waiting.appendleft(req)     # evicted work goes to the head

    def _victim(self, protect: Request) -> Request | None:
        """Lowest priority, then youngest, never above ``protect``'s rank."""
        cands = [r for r in self.running if r is not protect
                 and (r.priority, -r.arrival) <= (protect.priority,
                                                  -protect.arrival)]
        if not cands:
            return None
        return min(cands, key=lambda r: (r.priority, -r.arrival))

    def ensure_block(self, req: Request) -> bool:
        """Guarantee the block for ``req``'s next token write; may preempt.
        Returns False if ``req`` itself must yield (it is the lowest
        priority and the pool is exhausted)."""
        if req.cached % self.cfg.cache.block_size != 0:
            return True                   # tail block has room
        got = self.alloc.alloc(1)
        while got is None:
            victim = self._victim(req)
            if victim is None:
                self._preempt(req)
                return False
            self._preempt(victim)
            got = self.alloc.alloc(1)
        req.blocks.extend(got)
        return True

    # -- admission -------------------------------------------------------
    def admit(self, now: int) -> list[Request]:
        """Move arrived waiting requests into running slots under the block
        budget, stamping each one's first admission.  Returns the newly
        admitted requests (needing prefill)."""
        if self.cfg.mode == "static" and self.running:
            return []
        admitted: list[Request] = []
        while self.waiting and self._free_slots:
            req = self.waiting[0]
            if req.arrival > now:
                break
            need = self.cfg.cache.blocks_for(len(req.context))
            got = self.alloc.alloc(need)
            if got is None:
                break                     # head-of-line: keep FIFO order
            self.waiting.popleft()
            req.blocks = got
            req.slot = self._free_slots.pop()
            req.state = "running"
            if req.wall_admitted is None:
                req.wall_admitted = time.perf_counter()
            self.running.append(req)
            admitted.append(req)
        return admitted

    # -- completion ------------------------------------------------------
    def finish(self, req: Request, now: int) -> None:
        self.alloc.free(req.blocks)
        req.blocks = []
        req.state = "finished"
        req.finish_step = now
        self.running.remove(req)
        self._free_slots.append(req.slot)
        req.slot = -1


def poisson_trace(rng, *, n_requests: int, rate: float, vocab: int,
                  prompt_lens: Iterable[int], max_new: Iterable[int],
                  eos_id: int | None = None) -> list[Request]:
    """Synthetic arrival trace: exponential inter-arrival gaps at ``rate``
    requests per engine step, prompts drawn uniformly from the vocab."""
    prompt_lens = list(prompt_lens)
    max_new = list(max_new)
    t = 0.0
    reqs = []
    for i in range(n_requests):
        t += rng.exponential(1.0 / rate) if rate > 0 else 0.0
        pl = int(prompt_lens[i % len(prompt_lens)])
        reqs.append(Request(
            rid=i,
            prompt=tuple(int(x) for x in rng.integers(0, vocab, pl)),
            max_new_tokens=int(max_new[i % len(max_new)]),
            arrival=int(t), eos_id=eos_id))
    return reqs
