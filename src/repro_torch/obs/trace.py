"""Span tracing with a Chrome-trace (Perfetto-loadable) exporter, and the
measured tick timeline of the pipeline (counterpart of
``repro/obs/trace.py``).

``Tracer`` records complete events (``ph: "X"``) under (pid, tid) lanes and
writes the ``{"traceEvents": [...]}`` object form.  A span's args carry its
``id`` and the ``parent`` span open around it on its thread, so a phase's
self time is its duration less its children's.  ``active(tracer)`` makes a
tracer the thread's own, and ``span(name, ...)`` opens its spans, so code
deep in a step (the accumulation schedules, the optimizer step) needs no
tracer passed down; with none active such a span is a shared null context.  A span opened with a CUDA
``device`` also times the card: a pair of CUDA events on the current stream,
resolved onto the tracer's clock (its own lane, ``DEVICE_PID``) once the card
has passed them.  While ``torch.profiler`` runs, every span also opens a
host-only range ``<cat>.<name>`` (function scope, not a user annotation, so
it never shows on the profiler's device lane), which names the profiler's
idle gaps by the program's phase.

``add_timeline`` renders tick timelines, ``(stage, kind, chunk, microbatch,
start, end)`` tuples, the schema that ``TickTable.timeline()`` and the
measurement below share.

``measure_tick_timeline`` runs a grad-only pass of the pipeline's
``grad_fn`` built with a ``TickRecorder``.  The port's executor already runs
tick by tick on the host, one process per stage, so each stage rank times
its own unit of each tick (CUDA events on the card, ``perf_counter`` on the
CPU) from an origin set just after a barrier, and the rows go to rank 0.
The JAX package's segmented executor times ticks lock-step instead (every
stage active in tick t shares that tick's interval); ``obs/drift.py``
normalises both to the makespan.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import threading
import time

import torch
import torch.distributed as tdist

_KIND_NAMES = {0: None, 1: "F", 2: "B", 3: "Bd", 4: "Bw"}
DEVICE_PID = 100     # the Chrome-trace lane of device spans


class DeviceClock:
    """Stamps in stream order on the card (CUDA events on the current
    stream), ``perf_counter`` on the CPU, read as seconds from an origin
    stamped just after a synchronize.  A card stamp is read once the card
    has passed it."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.origin = None

    def stamp(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def start(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self.origin = self.stamp()

    def seconds(self, s) -> float:
        if self.cuda:
            return self.origin.elapsed_time(s) / 1e3
        return s - self.origin


class Span:
    """An open ``Tracer.span``.  Its ``args`` may be added to until it
    closes; ``elapsed_ms()`` is the host time since it opened."""

    __slots__ = ("tracer", "name", "cat", "pid", "tid", "args", "on_card", "id", "parent",
                 "t0_us", "_range", "_start")

    def __init__(self, tracer, name, cat, pid, tid, on_card, args):
        self.tracer, self.name, self.cat, self.pid, self.tid = tracer, name, cat, pid, tid
        self.on_card, self.args = on_card, args

    def __enter__(self) -> "Span":
        tr = self.tracer
        stack = tr._stacks.setdefault(threading.get_ident(), [])
        self.parent = stack[-1] if stack else None
        self.id = next(tr._ids)
        stack.append(self.id)
        self._range = None
        if torch._C._autograd._profiler_enabled():
            from torch._C._profiler import _RecordFunctionFast
            self._range = _RecordFunctionFast(f"{self.cat}.{self.name}")
            self._range.__enter__()
        self._start = tr._card_stamp() if self.on_card else None
        self.t0_us = tr.now_us()
        return self

    def elapsed_ms(self) -> float:
        return (self.tracer.now_us() - self.t0_us) / 1e3

    def __exit__(self, *exc) -> None:
        tr = self.tracer
        dur = tr.now_us() - self.t0_us
        if self._start is not None:
            tr._pending.append((self, self._start, tr._clock.stamp()))
        if self._range is not None:
            self._range.__exit__(None, None, None)
        tr._stacks[threading.get_ident()].pop()
        tr.complete(self.name, ts_us=self.t0_us, dur_us=dur, cat=self.cat, pid=self.pid,
                    tid=self.tid, args=dict(self.args, id=self.id, parent=self.parent))
        if self.parent is None:
            tr._drain(block=False)


class Tracer:
    """Collects Chrome-trace events; wall clock in µs from construction.
    Device spans are stamped from an origin recorded just after a
    synchronize at the first of them."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self.events: list[dict] = []
        self._named: set = set()
        self._ids = itertools.count(1)
        self._stacks: dict[int, list[int]] = {}     # thread -> ids of its open spans
        self._clock: DeviceClock | None = None
        self._origin_us = 0.0
        self._pending: collections.deque = collections.deque()   # (span, start, end)

    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def complete(self, name: str, *, ts_us: float, dur_us: float, cat: str = "phase",
                 pid: int = 0, tid: int = 0, args: dict | None = None) -> None:
        ev = {"name": name, "cat": cat, "ph": "X", "ts": ts_us,
              "dur": max(dur_us, 0.0), "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, *, cat: str = "phase", pid: int = 0, tid: int = 0,
                args: dict | None = None) -> None:
        ev = {"name": name, "cat": cat, "ph": "i", "ts": self.now_us(), "s": "t",
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def span(self, name: str, *, cat: str = "phase", pid: int = 0, tid: int = 0,
             device: torch.device | None = None, **args) -> Span:
        """A context that records the body as a complete event with ``args``;
        with a CUDA ``device``, also the card's time over it (``resolve``)."""
        return Span(self, name, cat, pid, tid, device is not None and device.type == "cuda",
                    args)

    def _card_stamp(self):
        if self._clock is None:
            self._clock = DeviceClock(True)
            self._clock.start()
            self._origin_us = self.now_us()
        return self._clock.stamp()

    def _drain(self, block: bool) -> None:
        """Device spans the card has passed (all of them when ``block``, after
        a synchronize) become events on the device lane, in the order they
        closed."""
        while self._pending:
            sp, a, b = self._pending[0]
            if not block and not b.query():
                return
            self._pending.popleft()
            start = self._clock.seconds(a)
            self.name_process(DEVICE_PID, "device")
            self.complete(sp.name, ts_us=self._origin_us + start * 1e6,
                          dur_us=(self._clock.seconds(b) - start) * 1e6, cat=sp.cat,
                          pid=DEVICE_PID, tid=sp.tid, args={"id": sp.id, "parent": sp.parent})

    def resolve(self) -> None:
        """Waits for the card and puts every closed device span on the
        device lane."""
        if self._pending:
            torch.cuda.synchronize()
            self._drain(block=True)

    def name_process(self, pid: int, name: str) -> None:
        if ("p", pid) in self._named:
            return
        self._named.add(("p", pid))
        self.events.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                            "args": {"name": name}})

    def name_thread(self, pid: int, tid: int, name: str) -> None:
        if ("t", pid, tid) in self._named:
            return
        self._named.add(("t", pid, tid))
        self.events.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                            "args": {"name": name}})

    def to_chrome(self) -> dict:
        self.resolve()
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


class _Active(threading.local):
    tracer: Tracer | None = None


_ACTIVE = _Active()
_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def active(tracer: Tracer | None):
    """Makes ``tracer`` this thread's active tracer while the body runs."""
    prev, _ACTIVE.tracer = _ACTIVE.tracer, tracer
    try:
        yield tracer
    finally:
        _ACTIVE.tracer = prev


def span(name: str, **kw):
    """A span of this thread's active tracer (``Tracer.span``'s arguments);
    a null context when there is none."""
    tracer = _ACTIVE.tracer
    return _NO_SPAN if tracer is None else tracer.span(name, **kw)


# ---------------------------------------------------------------------------
# Chrome-trace JSON: load / validate / timeline round-trip
# ---------------------------------------------------------------------------
def load_chrome(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def validate_chrome(doc) -> list[str]:
    """Schema problems of a Chrome-trace JSON-object-format document
    (empty list == loadable by chrome://tracing / Perfetto)."""
    problems = []
    if not isinstance(doc, dict) or not isinstance(doc.get("traceEvents"), list):
        return ["document must be an object with a 'traceEvents' list"]
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if not isinstance(ev.get("name"), str):
            problems.append(f"event {i}: missing name")
        if ph not in ("X", "B", "E", "i", "I", "M", "C"):
            problems.append(f"event {i}: unknown ph {ph!r}")
            continue
        if ph == "M":
            continue
        if not isinstance(ev.get("ts"), (int, float)):
            problems.append(f"event {i}: missing ts")
        if ph == "X" and (not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0):
            problems.append(f"event {i}: complete event needs dur >= 0")
    return problems


def add_timeline(tracer: Tracer, events, *, pid: int, name: str, scale_us: float = 1.0,
                 cat: str = "tick") -> None:
    """Render ``(stage, kind, chunk, microbatch, start, end)`` events (kind a
    tick code or "F"/"B"/"Bd"/"Bw", times scaled by ``scale_us``) as complete
    events: one process per timeline, one thread per stage."""
    tracer.name_process(pid, name)
    for (s, kind, v, mb, start, end) in events:
        k = _KIND_NAMES.get(kind, kind) if isinstance(kind, int) else kind
        if k is None:
            continue
        tracer.name_thread(pid, int(s), f"stage {int(s)}")
        tracer.complete(f"{k} v{int(v)} mb{int(mb)}", ts_us=float(start) * scale_us,
                        dur_us=(float(end) - float(start)) * scale_us, cat=cat, pid=pid,
                        tid=int(s), args={"stage": int(s), "kind": k, "chunk": int(v),
                                          "microbatch": int(mb)})


def timeline_from_chrome(doc: dict, *, pid: int) -> list:
    """Inverse of ``add_timeline`` for the given pid (times in µs)."""
    out = []
    for ev in doc["traceEvents"]:
        if ev.get("ph") != "X" or ev.get("pid") != pid:
            continue
        a = ev.get("args", {})
        if not {"stage", "kind", "chunk", "microbatch"} <= set(a):
            continue
        out.append((a["stage"], a["kind"], a["chunk"], a["microbatch"], ev["ts"],
                    ev["ts"] + ev["dur"]))
    return out


# ---------------------------------------------------------------------------
# Measured per-tick timeline (the pipeline executor, one stage a rank)
# ---------------------------------------------------------------------------
class TickRecorder:
    """Times this stage rank's own unit of each tick: the executor calls
    ``begin(kind, v, mb)`` and ``end()`` around the unit's compute.  On the card each unit
    is a pair of CUDA events, read once the pass has synchronised; on the
    CPU, ``perf_counter`` (``DeviceClock``).  ``start()`` sets the common
    origin, after a barrier over every rank."""

    def __init__(self, stage: int, device: torch.device):
        self.stage = stage
        self.clock = DeviceClock(torch.device(device).type == "cuda")
        self.rows: list = []
        self._open = None

    def start(self) -> None:
        if tdist.is_initialized():
            tdist.barrier()
        self.rows = []
        self.clock.start()

    def begin(self, kind: int, v: int, mb: int) -> None:
        self._open = (kind, v, mb, self.clock.stamp())

    def end(self) -> None:
        self.rows.append((*self._open, self.clock.stamp()))

    def timeline(self) -> list:
        """This stage's rows ``(stage, kind, chunk, microbatch, start_s,
        end_s)`` from the origin (synchronises the card)."""
        if self.clock.cuda:
            torch.cuda.synchronize()
        sec = self.clock.seconds
        return [(self.stage, _KIND_NAMES[k], v, mb, sec(a), sec(b))
                for k, v, mb, a, b in self.rows]


def measure_tick_timeline(grad_fn, recorder: TickRecorder, storage, batch, *, axis,
                          warmup: int = 1, tracer: Tracer | None = None, pid: int = 1,
                          name: str = "measured ticks") -> list:
    """Run ``warmup`` untimed passes and one timed pass of ``grad_fn`` (from
    ``pipeline.make_pipeline_grad_fn(..., recorder=recorder)``; its gradients
    are discarded) and return the measured tick timeline ``(stage, kind,
    chunk, microbatch, start_s, end_s)`` of every non-idle table unit, on
    rank 0 (the rows of each stage's first data and model rank, gathered
    over the stage group); other ranks get ``[]``.  Every rank calls it."""
    for _ in range(max(warmup, 0)):
        grad_fn(storage, batch)
    recorder.start()
    grad_fn(storage, batch)
    rows = recorder.timeline()
    if axis.stage is not None:
        per_stage = [None] * axis.nstage if axis.stage_index == 0 else None
        tdist.gather_object(rows, per_stage, dst=axis.stage_ranks[0], group=axis.stage)
        rows = [r for st in per_stage for r in st] if axis.stage_index == 0 else []
    if axis.data_index or axis.model_index:
        rows = []
    events = sorted(rows, key=lambda r: (r[4], r[0]))
    if tracer is not None and events:
        add_timeline(tracer, events, pid=pid, name=name, scale_us=1e6)
    return events
