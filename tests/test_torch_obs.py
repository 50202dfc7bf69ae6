"""The port's telemetry (``obs/metrics.py``, ``obs/trace.py``,
``obs/drift.py``, the tick profiler of ``core/pipeline.py`` and the engine's
spans) against the JAX package's.

Without processes: the registry gives JAX's host values for the same
updates; the sink survives a crash, closes once and its reader skips a torn
line; each package's Chrome trace passes the other's ``validate_chrome``;
the table timelines are JAX's; drift reports equal JAX's on the same
timelines and a timeline against itself is 0; for the same flags the
trainer's JSONL has JAX's record keys, plain and supervised.

On gloo, ``launch.train --stages 2 --drift-report --trace`` under
``torch.distributed.run`` (modular, and split 1f1b): the measured tick
timeline has exactly the unit identities of JAX's ``table.timeline()``, no
unit is missing or extra, and the trace holds the measured and the planned
lanes.  ``launch.serve --trace`` gives the JAX engine's prefill and decode
spans.

The port's own span machinery: parent links per thread, the active tracer,
device spans resolved onto the tracer's clock (CUDA events faked on the
CPU) and the host-only ranges a running profiler sees.
"""
import dataclasses
import json
import sys
import threading
import time

import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.core.schedules import PipeSpec as JPipeSpec
from repro.launch import train as jtrain
from repro.obs import drift as jdrift
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro_torch import configs
from repro_torch.core.schedules import PipeSpec
from repro_torch.launch import serve, train
from repro_torch.obs import drift as obs_drift
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.resilience import faults as flt
from test_torch_dist import Procs


# ---------------------------------------------------------------------------
# Registry and sink
# ---------------------------------------------------------------------------
def _registries():
    out = []
    for mod in (obs_metrics, jmetrics):
        reg = mod.Registry()
        reg.counter("tokens")
        reg.gauge("loss")
        reg.histogram("step_ms", [1.0, 4.0, 16.0])
        out.append(reg)
    return out


def test_registry_matches_jax():
    """The same updates give the same host values: counters add, gauges
    keep the last value, each value lands in its bucket (edges are upper
    bounds, one overflow bucket); merge adds counters and keeps the right
    gauge."""
    port, ref = _registries()
    hosts = []
    for reg, arr in ((port, float), (ref, jnp.float32)):
        tree = reg.init()
        for i in range(5):
            tree = reg.update(tree, tokens=8, loss=arr(i), step_ms=arr(i))
        tree = reg.update(tree, step_ms=[20.0, 0.5])
        other = reg.update(reg.init(), tokens=3, loss=arr(7.0))
        hosts.append((reg.to_host(tree), reg.to_host(reg.merge(tree, other))))
    assert hosts[0] == hosts[1]
    assert hosts[0][0] == {"tokens": 40.0, "loss": 4.0, "step_ms": [3, 3, 0, 1]}
    assert hosts[0][1]["tokens"] == 43.0 and hosts[0][1]["loss"] == 7.0
    specs = [{k: (v.kind, v.buckets) for k, v in mod.resilience_registry().specs.items()}
             for mod in (obs_metrics, jmetrics)]
    assert specs[0] == specs[1]


def test_sink_survives_midrun_exception(tmp_path):
    path = tmp_path / "metrics.jsonl"
    sink = obs_metrics.MetricsSink(str(path), meta={"arch": "t"})
    with pytest.raises(RuntimeError):
        try:
            for i in range(3):
                sink.log(step=i, loss=1.0 / (i + 1))
            raise RuntimeError("boom at step 3")
        finally:
            sink.close(extra={"aborted": True})
    recs = obs_metrics.read_jsonl(str(path))
    assert [r["event"] for r in recs] == ["meta", "step", "step", "step", "summary"]
    summ = recs[-1]
    assert summ["aborted"] is True and summ["records"] == 3
    assert summ["loss"]["last"] == pytest.approx(1.0 / 3)
    assert summ["loss"]["max"] == pytest.approx(1.0)


def test_sink_close_idempotent_and_read_skips_torn_line(tmp_path):
    path = tmp_path / "m.jsonl"
    sink = obs_metrics.MetricsSink(str(path))
    sink.log(step=0, loss=2.0)
    sink.close()
    sink.close(extra={"late": 1})
    with open(path, "a") as f:
        f.write('{"event": "step", "trunc')
    assert [r["event"] for r in obs_metrics.read_jsonl(str(path))] == ["step", "summary"]
    assert jmetrics.read_jsonl(str(path)) == obs_metrics.read_jsonl(str(path))


def test_percentiles_and_mfu():
    assert obs_metrics.percentiles(list(range(1, 101))) == {"p50": 50.0, "p95": 95.0,
                                                            "p99": 99.0}
    assert obs_metrics.percentiles([]) == {}
    cfg = configs.get_config("gemma-2b", smoke=True)
    one = obs_metrics.mfu_estimate(cfg, global_batch=8, seq_len=32, step_time_s=0.25)
    assert one == pytest.approx(6.0 * cfg.param_count() * 8 * 32 / (0.25 * 989e12))
    assert obs_metrics.mfu_estimate(cfg, global_batch=8, seq_len=32, step_time_s=0.25,
                                    n_devices=4) == pytest.approx(one / 4)
    assert obs_metrics.mfu_estimate(cfg, global_batch=8, seq_len=32, step_time_s=0.0) == 0.0


# ---------------------------------------------------------------------------
# Chrome traces, table timelines and drift
# ---------------------------------------------------------------------------
SCHEDULES = [("modular", False), ("1f1b", False), ("1f1b", True), ("interleaved", True)]


@pytest.mark.parametrize("schedule,split", SCHEDULES,
                         ids=[f"{s}{'-split' if p else ''}" for s, p in SCHEDULES])
def test_table_timeline_is_jax(schedule, split):
    kw = dict(n_stages=2, layers_per_stage=2, n_microbatches=4, schedule=schedule,
              split_backward=split)
    got = PipeSpec(**kw).tick_table().timeline()
    assert got and got == jdrift.table_timeline(JPipeSpec(**kw).tick_table())


def test_chrome_traces_pass_each_others_validator(tmp_path):
    """The port's trace, timeline lanes and all, passes JAX's
    ``validate_chrome`` and JAX's passes the port's; the timeline comes back
    from the file unit for unit."""
    timeline = PipeSpec(n_stages=2, layers_per_stage=2, n_microbatches=4,
                        schedule="1f1b").tick_table().timeline()
    docs = []
    for mod in (obs_trace, jtrace):
        tracer = mod.Tracer()
        with tracer.span("outer", cat="phase", step=1):
            tracer.instant("marker")
        mod.add_timeline(tracer, timeline, pid=3, name="planned", scale_us=1e6)
        path = tmp_path / f"{mod.__name__}.json"
        tracer.save(str(path))
        docs.append(mod.load_chrome(str(path)))
    for doc in docs:
        assert obs_trace.validate_chrome(doc) == [] == jtrace.validate_chrome(doc)
    got, want = (sorted((e["name"], e["ph"], e.get("args", {}).get("stage"))
                        for e in d["traceEvents"]) for d in docs)
    assert got == want
    back = obs_trace.timeline_from_chrome(docs[0], pid=3)
    assert {(s, k, v, mb): (a / 1e6, b / 1e6) for s, k, v, mb, a, b in back} == \
        pytest.approx({(s, k, v, mb): (a, b) for s, k, v, mb, a, b in timeline})


def test_spans_link_parents_per_thread_and_follow_the_active_tracer():
    """A span's parent is the span open around it on its own thread; a
    module-level ``span(name)`` goes to the thread's active tracer (another
    thread has none) and is a null context without one; a tracer's own
    ``span`` needs none active."""
    tr = obs_trace.Tracer()
    assert obs_trace.span("free") is obs_trace.span("free", cat="c")
    with obs_trace.active(None):
        assert obs_trace.span("free") is obs_trace.span("other")
    seen = []

    def apart():
        with obs_trace.span("unseen") as none, tr.span("apart"):
            seen.append(none)

    with obs_trace.active(tr):
        with obs_trace.span("outer", cat="c", k=1) as o:
            with tr.span("inner") as i:
                i.args["late"] = 2
            other = threading.Thread(target=apart)
            other.start()
            other.join(timeout=10)
            assert not other.is_alive()
    assert seen == [None] and obs_trace._ACTIVE.tracer is None
    ev = {e["name"]: e for e in tr.events}
    assert ev["outer"]["args"] == {"k": 1, "id": o.id, "parent": None}
    assert ev["inner"]["args"] == {"late": 2, "id": i.id, "parent": o.id}
    assert ev["apart"]["args"]["parent"] is None
    assert set(ev) == {"outer", "inner", "apart"}


class _FakeEvent:
    """A CUDA event that stamps the host clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def query(self):
        return True

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_device_spans_resolve_onto_the_tracers_clock(monkeypatch):
    """On the card a span also records an event pair, put on the device
    lane with its id and parent once passed (here at the top-level span's
    close), from the origin stamped after the first synchronize; on the CPU
    a device span has no device times.  ``TickRecorder`` stamps through the
    same clock."""
    syncs = []
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: syncs.append(1))
    tr = obs_trace.Tracer()
    card = torch.device("cuda")
    with tr.span("outer", cat="t", device=card) as o:
        with tr.span("inner", cat="t", device=card) as i:
            time.sleep(0.002)
        with tr.span("host", cat="t", device=torch.device("cpu")):
            pass
    assert len(syncs) == 1
    dev = [e for e in tr.events if e["ph"] == "X" and e["pid"] == obs_trace.DEVICE_PID]
    host = {e["name"]: e for e in tr.events if e["ph"] == "X" and e["pid"] == 0}
    assert [e["name"] for e in dev] == ["inner", "outer"]
    assert dev[0]["args"] == {"id": i.id, "parent": o.id}
    assert dev[1]["args"] == {"id": o.id, "parent": None}
    assert dev[1]["ts"] <= dev[0]["ts"] and dev[0]["dur"] >= 2000.0
    assert dev[0]["ts"] + dev[0]["dur"] <= dev[1]["ts"] + dev[1]["dur"]
    assert dev[0]["ts"] == pytest.approx(host["inner"]["ts"], abs=500.0)
    assert set(host) == {"outer", "inner", "host"}
    assert tr.to_chrome()["traceEvents"] == tr.events
    rec = obs_trace.TickRecorder(0, card)
    rec.start()
    rec.begin(1, 0, 0)
    time.sleep(0.001)
    rec.end()
    ((_, kind, _, _, a, b),) = rec.timeline()
    assert kind == "F" and 0.0 <= a < b and len(syncs) == 3


def test_spans_are_host_ranges_on_the_profilers_clock():
    """Under a running profiler a span opens ``<cat>.<name>`` as a
    function-scope range, not a user annotation, on the host; without the
    profiler, or without a tracer, it opens none."""
    from torch.profiler import ProfilerActivity, profile
    tr = obs_trace.Tracer()
    with tr.span("early", cat="serve"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs_trace.active(tr), obs_trace.span("gather", cat="accum"):
            torch.ones(4).add_(1)
        with obs_trace.span("nobody", cat="accum"):
            torch.ones(4).add_(1)
    got = [e for e in prof.events() if "." in e.name and e.name.split(".")[0] in
           ("serve", "accum")]
    assert [e.name for e in got] == ["accum.gather"]
    assert not got[0].is_user_annotation and got[0].device_type == torch.autograd.DeviceType.CPU


def test_validate_chrome_rejects_malformed():
    bad = {"traceEvents": [{"name": "x", "ph": "X", "ts": 0.0, "dur": -1.0, "pid": 0,
                            "tid": 0}, {"name": "y", "ph": "?", "ts": 0.0}]}
    for doc in ([], {"traceEvents": "nope"}, bad):
        assert obs_trace.validate_chrome(doc) == jtrace.validate_chrome(doc) != []
    assert len(obs_trace.validate_chrome(bad)) == 2


def test_drift_report_is_jax(tmp_path):
    """The same two timelines give JAX's report, key for key; a timeline
    against itself (or scaled and shifted) is 0."""
    tl = PipeSpec(n_stages=2, layers_per_stage=2, n_microbatches=4,
                  schedule="1f1b").tick_table().timeline()
    moved = [list(ev) for ev in tl]
    moved[0][4] += 0.5 * len(tl)
    moved = [tuple(e) for e in moved[1:]] + [(0, "F", 9, 9, 0.0, 1.0)]
    rep = obs_drift.drift_report(moved, tl)
    assert rep == jdrift.drift_report(moved, tl)
    assert obs_drift.format_report(rep) == jdrift.format_report(rep)
    assert rep["overall"]["missing"] == 1 and rep["overall"]["extra"] == 1
    assert obs_drift.drift_report(tl, tl)["max_abs_drift"] == 0.0
    scaled = [(s, k, v, mb, 5.0 + 3.0 * a, 5.0 + 3.0 * b) for s, k, v, mb, a, b in tl]
    assert obs_drift.drift_report(scaled, tl)["max_abs_drift"] == pytest.approx(0.0, abs=1e-12)
    obs_drift.save_report(rep, str(tmp_path / "d.json"))
    assert json.load(open(tmp_path / "d.json")) == json.loads(json.dumps(rep))


# ---------------------------------------------------------------------------
# The trainer's JSONL: JAX's keys for the same flags
# ---------------------------------------------------------------------------
FLAGS = ["--arch", "yi-6b", "--smoke", "--steps", "3", "--global-batch", "4", "--seq-len",
         "32", "--microbatches", "2", "--log-every", "100"]


@pytest.fixture
def jax_no_kernels(monkeypatch):
    orig = jconfigs.get_config
    monkeypatch.setattr(jtrain.configs, "get_config",
                        lambda *a, **k: dataclasses.replace(orig(*a, **k), kernels=False))


def _keys(path) -> dict:
    out = {}
    for r in jmetrics.read_jsonl(str(path)):
        out.setdefault(r["event"], set()).update(r)
    return out


@pytest.mark.parametrize("supervised", [False, True], ids=["plain", "supervised"])
def test_jsonl_has_jax_record_keys(tmp_path, jax_no_kernels, capsys, supervised):
    """Meta, step and event records carry JAX's keys exactly; the summary
    carries every key of JAX's (the port's result line adds the mesh)."""
    extra = []
    if supervised:
        fpath = tmp_path / "f.json"
        flt.FaultPlan([flt.Fault("crash", 2), flt.Fault("nan_grad", 2)]).save(str(fpath))
    for name, main, dev in (("jax", jtrain.main, []), ("port", train.main, ["--device", "cpu"])):
        if supervised:
            extra = ["--checkpoint-dir", str(tmp_path / f"{name}.ck"), "--checkpoint-every",
                     "1", "--faults", str(fpath)]
        main(FLAGS + dev + extra + ["--metrics", str(tmp_path / f"{name}.jsonl")])
    capsys.readouterr()
    jk, pk = _keys(tmp_path / "jax.jsonl"), _keys(tmp_path / "port.jsonl")
    assert sorted(jk) == sorted(pk)
    if supervised:
        assert {"restart", "anomaly", "meta", "step", "summary"} <= set(jk)
    for event in jk:
        if event == "summary":
            assert jk[event] <= pk[event], jk[event] - pk[event]
        else:
            assert pk[event] == jk[event], event


# ---------------------------------------------------------------------------
# The tick profiler through the entry point, two stages on gloo
# ---------------------------------------------------------------------------
PIPE_FLAGS = ["--arch", "yi-6b", "--smoke", "--device", "cpu", "--stages", "2", "--steps",
              "2", "--global-batch", "4", "--seq-len", "32", "--microbatches", "2"]
PIPE_RUNS = {"modular": [], "1f1b-split": ["--schedule", "1f1b", "--split-backward"]}


@pytest.fixture(scope="module")
def pipe_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs_pipe")
    out = {}
    for name, flags in PIPE_RUNS.items():
        files = {k: str(tmp / f"{name}.{k}") for k in ("drift", "trace", "jsonl")}
        proc = Procs(tmp, name, [[
            sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
            "2", "-m", "repro_torch.launch.train", *PIPE_FLAGS, *flags, "--drift-report",
            files["drift"], "--trace", files["trace"], "--metrics", files["jsonl"]]])
        out[name] = (proc, files)
    yield out
    for proc, _ in out.values():
        proc.kill()


@pytest.mark.parametrize("name", list(PIPE_RUNS))
def test_measured_ticks_are_the_tables_units(pipe_runs, name):
    """Each stage rank timed its own unit of every tick: the measured units
    are exactly JAX's ``table.timeline()`` units, none missing or extra,
    every interval inside the pass; the trace passes JAX's validator and
    holds both lanes; the drift is logged."""
    proc, files = pipe_runs[name]
    (stdout,) = proc.wait()
    result = json.loads(stdout.splitlines()[-1])
    schedule = "1f1b" if "1f1b" in name else "modular"
    table = JPipeSpec(n_stages=2, layers_per_stage=1, n_microbatches=2, schedule=schedule,
                      split_backward="split" in name).tick_table()
    want = {(s, k, v, mb) for s, k, v, mb, _, _ in table.timeline()}
    doc = jtrace.load_chrome(files["trace"])
    assert jtrace.validate_chrome(doc) == []
    measured = obs_trace.timeline_from_chrome(doc, pid=1)
    assert {(s, k, v, mb) for s, k, v, mb, _, _ in measured} == want
    assert len(measured) == len(want)
    assert all(0 <= a <= b for *_, a, b in measured)
    assert {(s, k, v, mb) for s, k, v, mb, _, _ in obs_trace.timeline_from_chrome(
        doc, pid=2)} == want
    rep = json.load(open(files["drift"]))
    assert rep["overall"]["missing"] == rep["overall"]["extra"] == 0
    assert rep["overall"]["matched"] == len(want)
    assert result["max_abs_drift"] == pytest.approx(rep["max_abs_drift"])
    assert obs_drift.drift_report(measured, measured)["max_abs_drift"] == 0.0
    (drift,) = [r for r in obs_metrics.read_jsonl(files["jsonl"]) if r["event"] == "drift"]
    assert drift["matched"] == len(want) and drift["missing"] == drift["extra"] == 0


def test_serve_trace_has_the_engines_spans(tmp_path, capsys):
    """``launch.serve --trace``: one ``prefill`` span per prefill call and
    one ``decode`` span per decode step, as the JAX engine records them."""
    path = tmp_path / "serve.json"
    res = serve.main(["--arch", "yi-6b", "--smoke", "--device", "cpu", "--requests", "4",
                      "--trace", str(path)])
    capsys.readouterr()
    doc = jtrace.load_chrome(str(path))
    assert jtrace.validate_chrome(doc) == []
    names = [e["name"] for e in doc["traceEvents"]]
    assert names.count("prefill") == res["prefill_calls"]
    assert names.count("decode") == res["decode_steps"]
    assert {e["tid"] for e in doc["traceEvents"] if e["name"] == "decode"} == {1}
