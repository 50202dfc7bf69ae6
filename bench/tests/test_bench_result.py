"""The result line of a run, driven whole on the CPU at a small size: its
keys, units and checks, and that the per-layer readers and the
BENCHMARK.json entries agree."""
import json
import math
import time

import pytest
import torch

from bench.harness import runner, spec

def run(cell, trace):
    r = runner.run_cell(cell, 2 ** 35 + 1, 1.0, trace, torch.device("cpu"), time.perf_counter())
    r.pop("_readings")
    return r


@pytest.mark.parametrize("name", ["granite-20b.train_layered", "granite-20b.serve_code"])
def test_result_line(tiny, name, capsys):
    cell = tiny(name)
    r = run(cell, False)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    # (a small run is not held to the cell's limits: see test_bench_faults)
    assert isinstance(r["correct"], bool) and r["attempted"] > 0 and r["failed"] == 0
    units = runner.driver(cell.kind).UNITS
    assert set(r["metrics"]) == set(runner.end_to_end_names(cell.name, units))
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2
    for k, m in r["metrics"].items():
        assert m["unit"] == units[k] and math.isfinite(m["value"])
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit", "at"}
    runner.emit(dict(r, _readings={}))
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(json.dumps(r))
    assert err.strip().splitlines()[-1].startswith("check ")


def test_traced_line_has_the_cells_per_layer_metrics(tiny):
    cell = tiny("yi-6b.train_long16k")
    r = run(cell, True)
    want = set(runner.per_layer_names(cell.name))
    # the CPU trace has no device operations: the device readers stay silent
    assert {"mfu.train", "enqueue_ms.train"} <= set(r["metrics"]) <= want
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_benchmark_json_matches_the_files():
    bj = spec.benchmark_json()
    assert set(bj) == {"command", "paths", "run_seconds", "configs", "workloads",
                       "end_to_end", "per_layer"}
    for c in bj["configs"]:
        conf = json.loads((spec.BENCH.parent / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert conf["source"] == c["source"]
    for w in bj["workloads"]:
        cell = spec.load_cell(w["name"])
        assert (cell.workload["config"], cell.workload["traffic"], cell.workload["chips"]) == \
            (w["config"], w["traffic"], w["chips"])
        assert cell.workload["why"] == w["why"]
        units = runner.driver(cell.kind).UNITS
        for m in bj["end_to_end"]:
            if w["name"] in m.get("workloads", [w["name"]]):
                assert units[m["name"]] == m["unit"]
    for m in bj["per_layer"]:
        assert runner.load_reader(m["name"]).UNIT == m["unit"]
