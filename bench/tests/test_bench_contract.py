"""BENCHMARK.json against the benchmark contract's static rules."""
import json
import re

from bench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTHS = re.compile(r"(_size$|_dim$|_rank$|^head|heads|expan|per_tok|latent|state)")


def bj():
    return spec.benchmark_json()


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_shape_and_names():
    b = bj()
    assert b["command"][:2] == ["python3", "bench/run.py"] and len(b["command"]) <= 32
    assert b["paths"] == ["bench"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]] \
        + [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len({c["name"] for c in b["configs"]}) == len(b["configs"])
    assert len({w["name"] for w in b["workloads"]}) == len(b["workloads"])
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert len(json.dumps(b)) < 64 * 1024


def test_configs():
    b = bj()
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and c["file"].startswith("bench/") and line(c["source"])
        assert line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTHS.search(k) for k in c["reduced"])
    assert len({c["file"] for c in b["configs"]}) == len(b["configs"])


def test_workloads():
    b = bj()
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = [w for w in b["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(b["workloads"]) // 4)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line(w["why"]) and NAME.match(w["traffic"])


def test_metrics():
    b = bj()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and line(m["layer"]) and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace", "program_span", "program_counter")
        for w in m["workloads"]:
            e = next(x for x in b["end_to_end"] if x["name"] == m["moves"])
            assert w in e.get("workloads", cells)
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for w in cells:      # every cell reports setup_s, another end-to-end metric, a per-layer one
        assert sum(w in m.get("workloads", cells) for m in b["end_to_end"]) >= 2
        assert any(w in m.get("workloads", cells) for m in b["per_layer"])


def test_a_full_check_fits_its_time_at_24_cells():
    rs = bj()["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_roofline_has_an_mfu_beside_it():
    b = bj()
    for m in b["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline"):
            assert any("mfu" in o["name"] and o["moves"] == m["moves"]
                       and set(m["workloads"]) <= set(o["workloads"]) for o in b["per_layer"])
