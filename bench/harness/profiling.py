"""The device trace of a traced run: ``torch.profiler`` over a short
stretch of the run, reduced to device intervals (kernels, copies, sets)
by name and the host operations running beside them.  Readers in
``bench/metrics`` take their numbers from the ``Trace`` this returns."""
from __future__ import annotations

import contextlib
import dataclasses

import torch

WINDOW = "bench.traced_window"


@dataclasses.dataclass
class Trace:
    """Times in seconds from the traced window's start."""
    window_s: float
    device: list          # (name, start, end) of every device operation
    host: list            # (name, start, end) of host operations on the run's thread

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (the union)."""
        total, end = 0.0, 0.0
        for _, a, b in sorted(self.device, key=lambda x: x[1]):
            a, b = max(a, end, 0.0), min(b, self.window_s)
            if b > a:
                total += b - a
                end = b
        return total

    def device_s(self, match) -> tuple[float, int]:
        """(summed seconds, launches) of the device operations whose name
        ``match(name)`` accepts."""
        hit = [b - a for n, a, b in self.device if match(n)]
        return sum(hit), len(hit)

    def gaps(self) -> list[tuple[float, float]]:
        """The idle stretches (start, end) of the window."""
        out, end = [], 0.0
        for _, a, b in sorted(self.device, key=lambda x: x[1]):
            if a > end:
                out.append((end, min(a, self.window_s)))
            end = max(end, b)
        if end < self.window_s:
            out.append((end, self.window_s))
        return [(a, b) for a, b in out if b > a]

    def host_at(self, t: float) -> str:
        """The innermost host operation running at ``t`` ("idle host" when
        none)."""
        best = None
        for n, a, b in self.host:
            if a <= t <= b and n != WINDOW and (best is None or b - a < best[1]):
                best = (n, b - a)
        return best[0] if best else "idle host"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        gaps, each named by the host operation running in its middle."""
        by_name: dict[str, float] = {}
        for n, a, b in self.device:
            by_name[n] = by_name.get(n, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[self.host_at((a + b) / 2)[:120], b - a] for a, b in gaps]}


def _events(prof):
    """(name, is_device, start_us, end_us, thread) of every event.  The
    window's own range shows on the device's timeline too, as an
    annotation; ``traced`` drops it there."""
    from torch.autograd import DeviceType
    try:
        evs = prof.profiler.kineto_results.events()
        out = []
        for e in evs:
            start = e.start_ns() / 1e3 if hasattr(e, "start_ns") else e.start_us()
            dur = e.duration_ns() / 1e3 if hasattr(e, "duration_ns") else e.duration_us()
            out.append((e.name(), e.device_type() != DeviceType.CPU, start, start + dur,
                        e.start_thread_id()))
        return out
    except (AttributeError, RuntimeError, TypeError):
        return [(e.name, e.device_type != DeviceType.CPU, e.time_range.start,
                 e.time_range.end, e.thread) for e in prof.events()]


@contextlib.contextmanager
def traced(device: torch.device):
    """Profiles the body; on exit, ``box[0]`` is its ``Trace``.  The body's
    last device work is waited for inside the window."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    box: list = []
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield box
            if device.type == "cuda":
                torch.cuda.synchronize()
    evs = _events(prof)
    win = [e for e in evs if e[0] == WINDOW and not e[1]]
    if not win:
        raise RuntimeError("the profiler recorded no traced window")
    t0, t1, thread = win[0][2], win[0][3], win[0][4]
    box.append(Trace(
        window_s=(t1 - t0) / 1e6,
        device=[(n, (a - t0) / 1e6, (b - t0) / 1e6) for n, dev, a, b, _ in evs
                if dev and n != WINDOW and b > t0 and a < t1],
        host=[(n, (a - t0) / 1e6, (b - t0) / 1e6) for n, dev, a, b, th in evs
              if not dev and th == thread and b > t0 and a < t1]))
