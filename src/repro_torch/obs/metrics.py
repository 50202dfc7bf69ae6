"""Metric registry, host-side JSONL sink and derived estimates (counterpart
of ``repro/obs/metrics.py``).

A ``Registry`` names counters, gauges and histograms once; ``init()`` builds
a zero metric tree of torch tensors and ``update()`` folds new values in
(fixed shapes, so a step can carry the tree on the device without a host
sync); ``to_host`` gives the same plain floats and int lists as the JAX
package's.  ``MetricsSink`` streams one JSON object per line, flushed per
line, so the file survives a crashed step; ``close()`` appends a summary
record.  Only rank 0 of a grid writes one.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Any

import torch

from repro_torch.core import roofline

_KINDS = ("counter", "gauge", "histogram")


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    name: str
    kind: str                        # counter | gauge | histogram
    buckets: tuple = ()              # histogram bucket upper edges


class Registry:
    """Declares metrics once; builds and updates fixed-shape tensor trees."""

    def __init__(self):
        self._specs: dict[str, MetricSpec] = {}

    def _add(self, name: str, kind: str, buckets=()):
        if kind not in _KINDS:
            raise ValueError(f"unknown metric kind {kind!r}; known: {_KINDS}")
        if name in self._specs:
            if self._specs[name].kind != kind:
                raise ValueError(f"metric {name!r} is a {self._specs[name].kind}, not a {kind}")
            return name
        self._specs[name] = MetricSpec(name, kind, tuple(buckets))
        return name

    def counter(self, name: str) -> str:
        """Monotone sum: ``update`` adds, ``merge`` adds."""
        return self._add(name, "counter")

    def gauge(self, name: str) -> str:
        """Last-value wins: ``update`` overwrites, ``merge`` takes the right."""
        return self._add(name, "gauge")

    def histogram(self, name: str, buckets) -> str:
        """Bucketized counts: ``update`` increments the bucket of each value
        (edges are upper bounds; one overflow bucket)."""
        if len(buckets) == 0:
            raise ValueError(f"histogram {name!r} needs at least one bucket edge")
        return self._add(name, "histogram", buckets)

    @property
    def specs(self) -> dict[str, MetricSpec]:
        return dict(self._specs)

    def init(self) -> dict:
        """Zero metrics, CPU tensors (``update`` keeps each on its device)."""
        tree = {}
        for name, sp in self._specs.items():
            if sp.kind == "histogram":
                tree[name] = torch.zeros((len(sp.buckets) + 1,), dtype=torch.int32)
            else:
                tree[name] = torch.zeros((), dtype=torch.float32)
        return tree

    def update(self, tree: dict, **values) -> dict:
        """Fold new values in (shapes never change; no host sync)."""
        out = dict(tree)
        for name, val in values.items():
            sp = self._specs[name]
            cur = out[name]
            v = torch.as_tensor(val, dtype=torch.float32, device=cur.device)
            if sp.kind == "counter":
                out[name] = cur + v
            elif sp.kind == "gauge":
                out[name] = v.reshape(())
            else:
                edges = torch.tensor(sp.buckets, dtype=torch.float32, device=cur.device)
                idx = torch.searchsorted(edges, v.reshape(-1))   # == len(edges): overflow
                out[name] = cur.index_add(0, idx, torch.ones_like(idx, dtype=cur.dtype))
        return out

    def merge(self, a: dict, b: dict) -> dict:
        return {name: b[name] if sp.kind == "gauge" else a[name] + b[name]
                for name, sp in self._specs.items()}

    def to_host(self, tree: dict) -> dict:
        """Tensor tree -> plain python (floats / int lists), for the sink."""
        out = {}
        for name, sp in self._specs.items():
            v = tree[name].detach().cpu()
            out[name] = [int(x) for x in v.tolist()] if sp.kind == "histogram" else float(v)
        return out


def resilience_registry() -> Registry:
    """The resilience layer's metric names: restart, lost-step, skip and
    shrink counters and the last recovery time (``resilience/supervisor.py``)."""
    reg = Registry()
    reg.counter("restarts")
    reg.counter("lost_steps")
    reg.counter("skipped_steps")
    reg.counter("shrinks")
    reg.gauge("recovery_time_s")
    return reg


# ---------------------------------------------------------------------------
# Derived estimates
# ---------------------------------------------------------------------------
def percentiles(values, qs=(50, 95, 99)) -> dict:
    """``{"p50": ..., }`` over a value list (empty -> {})."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return {}
    out = {}
    for q in qs:
        # nearest-rank on the sorted list
        k = max(0, min(len(vals) - 1, math.ceil(q / 100 * len(vals)) - 1))
        out[f"p{q}"] = vals[k]
    return out


def mfu_estimate(cfg, *, global_batch: int, seq_len: int, step_time_s: float,
                 n_devices: int = 1) -> float:
    """Model-flops utilization of one optimizer step: 6ND training flops
    (fwd 2ND + bwd 4ND; recomputation not counted) over ``step_time *
    n_devices * peak``, the H100's dense bf16 peak (``core/roofline.py``)."""
    return roofline.mfu(roofline.model_flops_train(cfg, global_batch, seq_len),
                        step_time_s, n_devices=n_devices)


# ---------------------------------------------------------------------------
# Host-side sink
# ---------------------------------------------------------------------------
class MetricsSink:
    """Streams metric records to JSONL and aggregates a summary.

    Every ``log()`` writes one line and flushes it.  ``close()`` appends an
    ``{"event": "summary", ...}`` line (once); use it as a context manager
    or from ``finally:``.  ``path=None`` keeps the aggregation without a
    file (the sink of every rank but 0)."""

    def __init__(self, path: str | None = None, *, meta: dict | None = None):
        self.path = path
        self._fh = open(path, "w") if path else None
        self._agg: dict[str, dict] = {}
        self._n = 0
        self._closed = False
        if meta:
            self._write(dict({"event": "meta"}, **meta))

    def _write(self, record: dict) -> None:
        if self._fh is not None:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()

    def log(self, record: dict | None = None, *, event: str = "step", **kw) -> dict:
        """Write one record (dict and/or keywords) and fold numerics into
        the running summary aggregates."""
        rec = dict(record or {}, **kw)
        self._n += 1
        for k, v in rec.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            a = self._agg.setdefault(k, {"count": 0, "sum": 0.0, "min": v, "max": v, "last": v})
            a["count"] += 1
            a["sum"] += v
            a["min"] = min(a["min"], v)
            a["max"] = max(a["max"], v)
            a["last"] = v
        self._write(dict({"event": event, "time": time.time()}, **rec))
        return rec

    def summary(self) -> dict:
        out: dict[str, Any] = {"records": self._n}
        for k, a in self._agg.items():
            out[k] = {"last": a["last"], "mean": a["sum"] / a["count"],
                      "min": a["min"], "max": a["max"]}
        return out

    def close(self, extra: dict | None = None) -> dict:
        """Write the summary line (idempotent) and close the file."""
        s = self.summary()
        if not self._closed:
            self._closed = True
            self._write({"event": "summary", **s, **(extra or {})})
            if self._fh is not None:
                self._fh.close()
                self._fh = None
        return s

    def __enter__(self) -> "MetricsSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_jsonl(path: str) -> list[dict]:
    """Load a sink's output (skips a torn final line from a hard crash)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out
