"""Span tracing with a Chrome-trace (Perfetto-loadable) exporter, and the
measured tick timeline of the pipeline (counterpart of
``repro/obs/trace.py``).

``Tracer`` records complete events (``ph: "X"``) under (pid, tid) lanes and
writes the ``{"traceEvents": [...]}`` object form.  ``add_timeline`` renders
tick timelines, ``(stage, kind, chunk, microbatch, start, end)`` tuples, the
schema that ``TickTable.timeline()`` and the measurement below share.

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

import contextlib
import json
import time

import torch
import torch.distributed as tdist

_KIND_NAMES = {0: None, 1: "F", 2: "B", 3: "Bd", 4: "Bw"}


class Tracer:
    """Collects Chrome-trace events; wall clock in µs from construction."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self.events: list[dict] = []
        self._named: set = set()

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

    @contextlib.contextmanager
    def span(self, name: str, *, cat: str = "phase", pid: int = 0, tid: int = 0, **args):
        t0 = self.now_us()
        try:
            yield self
        finally:
            self.complete(name, ts_us=t0, dur_us=self.now_us() - t0, cat=cat, pid=pid,
                          tid=tid, args=args or None)

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
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


def span(tracer: Tracer | None, name: str, **kw):
    """``tracer.span`` or nothing."""
    return tracer.span(name, **kw) if tracer is not None else contextlib.nullcontext()


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
    CPU, ``perf_counter``.  ``start()`` sets the common origin, after a
    barrier over every rank."""

    def __init__(self, stage: int, device: torch.device):
        self.stage = stage
        self.cuda = torch.device(device).type == "cuda"
        self.rows: list = []
        self._origin = self._open = None

    def _stamp(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def start(self) -> None:
        if tdist.is_initialized():
            tdist.barrier()
        if self.cuda:
            torch.cuda.synchronize()
        self.rows = []
        self._origin = self._stamp()

    def begin(self, kind: int, v: int, mb: int) -> None:
        self._open = (kind, v, mb, self._stamp())

    def end(self) -> None:
        self.rows.append((*self._open, self._stamp()))

    def timeline(self) -> list:
        """This stage's rows ``(stage, kind, chunk, microbatch, start_s,
        end_s)`` from the origin (synchronises the card)."""
        if self.cuda:
            torch.cuda.synchronize()
            sec = lambda e: self._origin.elapsed_time(e) / 1e3  # noqa: E731
        else:
            sec = lambda t: t - self._origin  # noqa: E731
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
