"""Measured-vs-predicted tick timeline drift (a copy of ``repro/obs/drift.py``).

Both a ``TickTable``'s own unit-tick rendering and the executor's
measurement (``obs/trace.measure_tick_timeline``) emit timelines in one
schema: ``(stage, kind, chunk, microbatch, start, end)``.  ``drift_report``
normalizes each timeline to its own makespan (shift to start 0, scale to
span 1 — time *shape*, not absolute rate), matches units by their
``(stage, kind, chunk, microbatch)`` identity, and reports per-kind start /
duration drift plus coverage (missing / extra units).  A timeline aligned
against itself is exactly zero drift everywhere; the report against a plan's
embedded table is the diff a ``CostModel`` calibration minimizes.
"""
from __future__ import annotations

import json

_KIND_NAMES = {0: None, 1: "F", 2: "B", 3: "Bd", 4: "Bw"}


def _norm_events(events) -> dict:
    """Events -> {key: (start, end)} normalized to [0, 1] makespan."""
    units = {}
    for (s, kind, v, mb, start, end) in events:
        k = _KIND_NAMES.get(kind, kind) if isinstance(kind, int) else kind
        if k is None:
            continue
        units[(int(s), str(k), int(v), int(mb))] = (float(start), float(end))
    if not units:
        return {}
    t0 = min(a for a, _ in units.values())
    t1 = max(b for _, b in units.values())
    span = (t1 - t0) or 1.0
    return {k: ((a - t0) / span, (b - t0) / span)
            for k, (a, b) in units.items()}


def table_timeline(table) -> list:
    """A ``TickTable``'s predicted timeline in the shared schema (one time
    unit per tick — the lockstep rendering the segmented measurement also
    produces), via ``TickTable.timeline()``."""
    return table.timeline()


def drift_report(measured, predicted) -> dict:
    """Align two timelines; per-kind and overall drift statistics.

    Returns a JSON-ready dict: for each kind, matched/missing/extra unit
    counts and mean/max absolute drift of normalized start times and
    durations; ``overall`` aggregates across kinds, and ``max_abs_drift`` is
    the headline number (0.0 for a timeline against itself).
    """
    m = _norm_events(measured)
    p = _norm_events(predicted)
    kinds = sorted({k[1] for k in m} | {k[1] for k in p})
    report: dict = {"n_measured": len(m), "n_predicted": len(p), "kinds": {}}
    all_start, all_dur = [], []
    total_missing = total_extra = 0
    for kind in kinds:
        mk = {k: v for k, v in m.items() if k[1] == kind}
        pk = {k: v for k, v in p.items() if k[1] == kind}
        matched = sorted(set(mk) & set(pk))
        start_d = [abs(mk[k][0] - pk[k][0]) for k in matched]
        dur_d = [abs((mk[k][1] - mk[k][0]) - (pk[k][1] - pk[k][0]))
                 for k in matched]
        all_start.extend(start_d)
        all_dur.extend(dur_d)
        missing = len(set(pk) - set(mk))
        extra = len(set(mk) - set(pk))
        total_missing += missing
        total_extra += extra
        report["kinds"][kind] = {
            "matched": len(matched), "missing": missing, "extra": extra,
            "start_drift_mean": _mean(start_d), "start_drift_max": _mx(start_d),
            "dur_drift_mean": _mean(dur_d), "dur_drift_max": _mx(dur_d),
        }
    report["overall"] = {
        "matched": len(all_start), "missing": total_missing,
        "extra": total_extra,
        "start_drift_mean": _mean(all_start), "start_drift_max": _mx(all_start),
        "dur_drift_mean": _mean(all_dur), "dur_drift_max": _mx(all_dur),
    }
    report["max_abs_drift"] = max(report["overall"]["start_drift_max"],
                                  report["overall"]["dur_drift_max"])
    return report


def _mean(xs) -> float:
    return (sum(xs) / len(xs)) if xs else 0.0


def _mx(xs) -> float:
    return max(xs) if xs else 0.0


def format_report(report: dict) -> str:
    """Human-readable rendering of ``drift_report`` output."""
    lines = [f"tick drift: {report['overall']['matched']} units matched, "
             f"{report['overall']['missing']} missing, "
             f"{report['overall']['extra']} extra "
             f"(max |drift| {report['max_abs_drift']:.4f} of makespan)"]
    hdr = (f"  {'kind':<5} {'match':>5} {'miss':>4} {'extra':>5} "
           f"{'start mean':>10} {'start max':>9} {'dur mean':>9} "
           f"{'dur max':>8}")
    lines.append(hdr)
    for kind, st in sorted(report["kinds"].items()):
        lines.append(
            f"  {kind:<5} {st['matched']:>5} {st['missing']:>4} "
            f"{st['extra']:>5} {st['start_drift_mean']:>10.4f} "
            f"{st['start_drift_max']:>9.4f} {st['dur_drift_mean']:>9.4f} "
            f"{st['dur_drift_max']:>8.4f}")
    return "\n".join(lines)


def save_report(report: dict, path: str) -> str:
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    return path
