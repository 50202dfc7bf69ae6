"""One run of one cell: the cell's driver (``bench/drivers/<kind>.py``),
the per-layer readers of a traced run, the guard against JAX, and the
result line.  A driver module has ``UNITS`` (its end-to-end metrics) and
``run``; the line carries those of its metrics that ``BENCHMARK.json``
gives the cell.  A driver of a cell on several cards starts its ranks on
cards 0 to chips - 1 itself and reports the largest rank's peak."""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys

import torch

from bench.harness import spec

# compared by the whole top-level name: the port, repro_torch, is not repro
BANNED = ("jax", "jaxlib", "flax", "repro")


class BannedModules(RuntimeError):
    pass


def banned_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def load_reader(name: str):
    path = spec.BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    return importlib.import_module(f"bench.drivers.{kind}")


def end_to_end_names(cell: str, measured) -> list[str]:
    """The end-to-end metrics ``BENCHMARK.json`` gives this cell, of those
    ``measured`` (all of them without the file)."""
    bj = spec.benchmark_json()
    if bj is None:
        return list(measured)
    return [m["name"] for m in bj["end_to_end"]
            if cell in m.get("workloads", [cell]) and m["name"] in measured]


def per_layer_names(cell: str) -> list[str]:
    """The per-layer metrics ``BENCHMARK.json`` gives this cell (every
    reader in ``bench/metrics`` without the file)."""
    bj = spec.benchmark_json()
    if bj is None:
        return sorted(p.stem for p in (spec.BENCH / "metrics").glob("*.py"))
    return [m["name"] for m in bj["per_layer"] if cell in m.get("workloads", [cell])]


def device_facts(device: torch.device, peak: int, chips: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float) -> dict:
    """The result line's object; ``checks`` is its last key."""
    drv = driver(cell.kind)
    out = drv.run(cell, seed, seconds, trace, device, t_start)
    found = banned_loaded()
    if found:
        raise BannedModules(f"loaded in the run's process: {', '.join(found)}")
    rec = out["record"]
    if trace:
        metrics = {}
        for name in per_layer_names(cell.name):
            reader = load_reader(name)
            v = reader.read(rec)
            if v is not None:
                metrics[name] = {"value": v, "unit": reader.UNIT}
    else:
        metrics = {k: {"value": out["e2e"][k], "unit": drv.UNITS[k]}
                   for k in end_to_end_names(cell.name, out["e2e"])}
    dev = device_facts(device, out["peak"], rec.chips)
    result = {"correct": bool(out["correct"] and all(
                  math.isfinite(m["value"]) for m in metrics.values())),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if trace and rec.trace is not None:
        dev.update(busy_s=rec.trace.busy_s(), window_s=rec.trace.window_s)
        result["breakdown"] = rec.trace.breakdown()
    result["checks"] = out["checks"]
    result["_readings"] = out["readings"]
    return result


def emit(result: dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output (``checks`` its last key)."""
    readings = result.pop("_readings", None)
    if readings is not None:
        print("readings " + json.dumps(readings, default=str)[:6000], file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} at {c['at']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
