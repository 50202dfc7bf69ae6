"""The serving step loop: admit -> ragged batched prefill -> one decode step
(counterpart of ``repro/serving/engine.py``).

  1. **admit** arrived requests into free slots under the block budget
     (continuous mode: into the live batch; static mode: only into an
     empty one);
  2. **prefill** the newly admitted requests in one right-padded batch,
     bucketed to a power-of-two row count and a power-of-two block count
     (the same buckets as the JAX engine, so both see the same shapes);
     padded rows write to the trash block;
  3. **ensure capacity** for every running request's next token write
     (crossing a block boundary takes a block from the free list, or
     preempts lower-priority work — scheduler.py);
  4. **decode** every live slot by one token; idle slots ride along with
     ``len == -1``.

Greedy (argmax) sampling; requests finish on EOS or their token budget,
and their blocks return to the pool.

With a tracer, each prefill call and each decode step is one span
(``prefill``, ``decode``; ``serve.prefill`` and ``serve.decode`` on a
running profiler's host lane).  Their args split the span at the return of
the model step, when every kernel is enqueued: ``launch_ms`` before it,
``wait_ms`` the argmax's copy to the host after it.  A prefill's args also
carry its padding, ``rows`` (pow2 B) x ``bucket`` (S) = ``slot_tokens``
against ``real_tokens``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.models.common import ModelConfig
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import percentiles
from repro_torch.serving import steps
from repro_torch.serving.cache import init_paged_cache
from repro_torch.serving.scheduler import Request, Scheduler, SchedulerConfig


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params: dict, scfg: SchedulerConfig, *,
                 tracer=None):
        """The device is the one ``params`` live on.  ``tracer`` (an
        ``obs.trace.Tracer``) records each prefill call and decode step as a
        span, as the JAX engine does."""
        if cfg.input_mode != "tokens":
            raise ValueError(f"serving needs token inputs (got {cfg.input_mode!r})")
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.sched = Scheduler(scfg)
        self.pcfg = scfg.cache
        self.cache = init_paged_cache(cfg, self.pcfg, self.device)
        R, maxb = scfg.max_batch, self.pcfg.max_blocks_per_seq
        self._tables = np.full((R, maxb), self.pcfg.trash_block, np.int32)
        self._lens = np.zeros((R,), np.int32)
        self._tokens = np.zeros((R,), np.int32)
        self.tracer = tracer
        self.t = 0
        self.finished: dict[int, Request] = {}
        self.stats = {"engine_steps": 0, "decode_steps": 0,
                      "prefill_calls": 0, "prefill_tokens": 0,
                      "emitted_tokens": 0, "preemptions": 0}

    # -- submission ------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Queues ``req``; one whose arrival step has come is seen now."""
        self.sched.submit(req)
        if req.arrival <= self.t and req.wall_visible is None:
            req.wall_visible = time.perf_counter()

    def submit_all(self, reqs) -> None:
        for r in reqs:
            self.submit(r)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- prefill ---------------------------------------------------------
    def _run_prefill(self, reqs: list[Request], sp: obs_trace.Span | None) -> None:
        bs = self.pcfg.block_size
        maxb = self.pcfg.max_blocks_per_seq
        B = _next_pow2(len(reqs))
        # pow2 bucket, capped at the table width (every context fits it:
        # submit() rejects anything beyond max_context)
        S = bs * min(_next_pow2(max(self.pcfg.blocks_for(len(r.context))
                                    for r in reqs)), maxb)
        tokens = np.zeros((B, S), np.int32)
        lens = np.zeros((B,), np.int32)
        tables = np.full((B, maxb), self.pcfg.trash_block, np.int32)
        for i, r in enumerate(reqs):
            tokens[i, :len(r.context)] = r.context
            lens[i] = len(r.context)
            tables[i, :len(r.blocks)] = r.blocks
        logits, self.cache = steps.paged_prefill_step(
            self.cfg, self.params, self.cache,
            {"tokens": self._dev(tokens), "lens": self._dev(lens)}, self._dev(tables))
        launch_ms = sp.elapsed_ms() if sp is not None else 0.0
        first = logits.argmax(-1).cpu().numpy()
        real = int(lens.sum())
        self.stats["prefill_calls"] += 1
        self.stats["prefill_tokens"] += real
        if sp is not None:
            sp.args.update(launch_ms=launch_ms, wait_ms=sp.elapsed_ms() - launch_ms, rows=B,
                           bucket=S, real_tokens=real, slot_tokens=B * S)
        for i, r in enumerate(reqs):
            r.cached = len(r.context)
            self._emit(r, int(first[i]))

    # -- token bookkeeping -----------------------------------------------
    def _emit(self, req: Request, tok: int) -> None:
        req.generated.append(tok)
        req.pending = tok
        req.token_walls.append(time.perf_counter())
        self.stats["emitted_tokens"] += 1
        if req.done:
            self.sched.finish(req, self.t)
            self.finished[req.rid] = req

    def _sync_slots(self) -> None:
        self._tables[:] = self.pcfg.trash_block
        self._lens[:] = -1                 # idle-slot marker (see steps.py)
        self._tokens[:] = 0
        for r in self.sched.running:
            self._tables[r.slot, :len(r.blocks)] = r.blocks
            self._lens[r.slot] = r.cached
            self._tokens[r.slot] = r.pending if r.pending is not None else 0

    # -- one engine step --------------------------------------------------
    def step(self) -> dict:
        """Admits and prefills what it can, then decodes every live slot
        once; the spans go to the engine's ``tracer``."""
        with obs_trace.active(self.tracer):
            return self._step()

    def _step(self) -> dict:
        now = self.t
        wall = time.perf_counter()
        # TTFT starts when the engine first SEES a request (arrival step
        # reached), not when a slot frees up — queueing is part of latency;
        # one submitted after its arrival step was seen at submission
        for r in self.sched.waiting:
            if r.arrival <= now and r.wall_visible is None:
                r.wall_visible = wall
        pre_preempt = self.stats["preemptions"]
        admitted = self.sched.admit(now)
        if admitted:
            with obs_trace.span("prefill", cat="serve", tid=0, step=now,
                                batch=len(admitted)) as sp:
                self._run_prefill(admitted, sp)
        # capacity for every live request's next write, highest priority
        # first (ensure_block may preempt lower-priority tables)
        for r in sorted(self.sched.running, key=lambda r: (-r.priority, r.arrival)):
            if r.state == "running":          # may have been evicted above
                self.sched.ensure_block(r)
        self.stats["preemptions"] = sum(
            r.preemptions for rs in (self.sched.running, self.sched.waiting,
                                     self.finished.values()) for r in rs)
        decoded = 0
        if self.sched.running:
            self._sync_slots()
            with obs_trace.span("decode", cat="serve", tid=1, step=now,
                                batch=len(self.sched.running)) as sp:
                logits, self.cache = steps.paged_decode_step(
                    self.cfg, self.params, self.cache, self._dev(self._tables),
                    self._dev(self._lens), self._dev(self._tokens))
                launch_ms = sp.elapsed_ms() if sp is not None else 0.0
                nxt = logits.argmax(-1).cpu().numpy()
                if sp is not None:
                    sp.args.update(launch_ms=launch_ms, wait_ms=sp.elapsed_ms() - launch_ms)
            for r in list(self.sched.running):
                r.cached += 1
                self._emit(r, int(nxt[r.slot]))
                decoded += 1
            self.stats["decode_steps"] += 1
        self.stats["engine_steps"] += 1
        self.t += 1
        return {"step": now, "admitted": len(admitted), "decoded": decoded,
                "running": len(self.sched.running),
                "waiting": len(self.sched.waiting),
                "preempted": self.stats["preemptions"] - pre_preempt}

    # -- latency telemetry -------------------------------------------------
    def latency_summary(self) -> dict:
        """Wall-clock TTFT / inter-token-latency / queue-wait percentiles (ms)
        over the finished requests.  TTFT counts from engine visibility
        (arrival step reached), so queueing and preemption re-prefills show
        in the tail; the queue wait runs from visibility to first admission."""
        ttft, itl, queue = [], [], []
        for r in self.finished.values():
            w = r.token_walls
            if not w:
                continue
            if r.wall_visible is not None:
                ttft.append((w[0] - r.wall_visible) * 1e3)
                queue.append((r.wall_admitted - r.wall_visible) * 1e3)
            itl.extend((b - a) * 1e3 for a, b in zip(w, w[1:]))
        return {"n_requests": len(self.finished), "ttft_ms": percentiles(ttft),
                "itl_ms": percentiles(itl), "queue_ms": percentiles(queue)}

    def run(self, *, max_steps: int = 100_000) -> dict[int, list[int]]:
        """Drive until every submitted request finishes."""
        while self.sched.has_work:
            self.step()
            if self.t > max_steps:
                raise RuntimeError(f"engine did not drain in {max_steps} steps")
        return {rid: list(r.generated) for rid, r in sorted(self.finished.items())}
