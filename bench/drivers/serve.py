"""A serving cell: the port's ``ServingEngine`` (paged KV cache,
continuous batching, greedy decoding) with the configuration's weights in
its served type, made on the card from the seed.

The loop is open: each request is submitted at its due time on the wall
clock, whatever the engine is doing, and the engine steps while it has
work.  A request's time to first token counts from its due time, so a
stall delays every request due during it.  After the window no request is
added and the engine drains; the latencies of every request due in the
window count, the drained ones' in full.  As each request finishes, the
K and V rows its decode steps wrote to the paged cache are kept.  Then the
port's state is freed, and the reference reads a sample of the served
requests, drawn from the seed with the longest in it: their served tokens
and those rows."""
from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from bench.harness import compare, inputs
from bench.harness.profiling import traced
from bench.harness.record import RunRecord, attention_spy
from bench.harness.spec import Cell, model_config
from bench.reference import serve as ref_serve

UNITS = {"ttft_p50_ms": "ms", "ttft_p90_ms": "ms", "itl_p95_ms": "ms", "setup_s": "s"}
_WARMUP = 6          # the stream of the warm-up prompts
DRAIN_S = 90.0
REPLAY_RID = 10 ** 8  # request ids of the traced replay


def serving_params(conf: dict, seed: int, device) -> dict:
    """The engine's parameter dict: matrices in the served type, norms fp32."""
    dt = getattr(torch, conf["dtype"])
    outer = inputs.outer_weights(conf, seed, device, dtype=dt)
    return dict(outer, layers=[inputs.layer_weights(conf, seed, l, device, dtype=dt)
                               for l in range(conf["num_hidden_layers"])])


def warm_up(engine, w: dict, vocab: int, seed: int) -> None:
    """One prefill at each of the traffic's prompt buckets, a batch at the
    largest, and decode steps of every slot: the shapes the window meets."""
    from repro_torch.serving.scheduler import Request
    rng = inputs.numpy_rng(seed, _WARMUP)
    wu = w["warmup"]
    shots = [[n] for n in wu["prompts"]] + [[wu["batch_prompt"]] * wu["batch"]]
    rid = 10 ** 9
    for shot in shots:
        for n in shot:
            engine.submit(Request(rid=rid, prompt=tuple(rng.integers(0, vocab, n).tolist()),
                                  max_new_tokens=wu["new_tokens"], arrival=engine.t))
            rid += 1
        while engine.sched.has_work:
            engine.step()


def _pct(xs: list, q: float) -> float:
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def open_engine(cell: Cell, seed: int, device, trace: bool):
    """The engine over the seed's weights, warmed up; and its tracer."""
    from repro_torch.obs.trace import Tracer
    from repro_torch.serving.cache import PagedCacheConfig
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import SchedulerConfig

    e = cell.workload["engine"]
    scfg = SchedulerConfig(cache=PagedCacheConfig(num_blocks=e["num_blocks"],
                                                  block_size=e["block_size"],
                                                  max_blocks_per_seq=e["max_blocks_per_seq"]),
                           max_batch=e["max_batch"])
    tracer = Tracer() if trace else None
    engine = ServingEngine(model_config(cell.config), serving_params(cell.config, seed, device),
                           scfg, tracer=tracer)
    warm_up(engine, cell.workload, cell.config["vocab_size"], seed)
    return engine


@contextlib.contextmanager
def cache_rows(engine, rows: dict):
    """While the body runs, as each request of the window finishes, keeps
    the K and V rows that decode steps wrote for it to the pool, before its
    blocks go back: ``rows[rid]`` [n, layers, 2, Hkv, hd] on the device, at
    the positions of its served tokens but the last (which no step writes)."""
    sched, bs = engine.sched, engine.pcfg.block_size
    finish = sched.finish

    def keep(req, now):
        if req.rid < REPLAY_RID:
            pos = np.arange(len(req.prompt), len(req.prompt) + len(req.generated) - 1)
            bid = torch.as_tensor(np.asarray(req.blocks, dtype=np.int64)[pos // bs],
                                  device=engine.device)
            off = torch.as_tensor(pos % bs, device=engine.device)
            rows[req.rid] = torch.stack([engine.cache[n][:, bid, :, off] for n in "kv"], 2)
        finish(req, now)

    sched.finish = keep
    try:
        yield
    finally:
        del sched.finish


def window(engine, todo: list, seconds: float, device, rec: RunRecord) -> dict:
    """Serves ``todo`` on the wall clock from now, then drains.  Fills
    ``rec`` and returns the requests, the window's start, the latencies, the
    generator's lateness and the cache rows of every finished request."""
    from repro_torch.serving.scheduler import Request

    tracer = engine.tracer
    reqs: list = []
    n_spans0 = len(tracer.events) if tracer else 0
    tok0 = engine.stats["prefill_tokens"]
    late: list = []
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()

    def submit_due() -> None:
        now = time.perf_counter() - t0
        while len(reqs) < len(todo) and todo[len(reqs)]["due"] <= now:
            r = todo[len(reqs)]
            req = Request(rid=len(reqs), prompt=tuple(r["prompt"].tolist()),
                          max_new_tokens=r["max_new"], arrival=engine.t)
            engine.submit(req)
            reqs.append(req)
            late.append(now - r["due"])

    most_waiting = most_admitted = 0
    decoding: list = []
    rows: dict = {}
    with cache_rows(engine, rows):
        while True:
            submit_due()
            if len(reqs) == len(todo) and time.perf_counter() - t0 >= seconds:
                break
            if engine.sched.has_work:
                most_waiting = max(most_waiting, len(engine.sched.waiting))
                out = engine.step()
                most_admitted = max(most_admitted, out["admitted"])
                decoding.append(out["decoded"])
            else:
                time.sleep(max(0.0, min(todo[len(reqs)]["due"] - (time.perf_counter() - t0),
                                        0.01)) if len(reqs) < len(todo) else 0.001)
        rec.window_s = time.perf_counter() - t0
        backlog = len(engine.sched.waiting)
        if tracer is not None:
            for ev in tracer.events[n_spans0:]:
                if ev.get("ph") != "X":
                    continue
                (rec.prefill_spans if ev["name"] == "prefill" else rec.decode_spans).append(
                    ev["dur"] / 1e6)
            rec.prefill_tokens = engine.stats["prefill_tokens"] - tok0
        t_drain = time.perf_counter()
        while engine.sched.has_work and time.perf_counter() - t_drain < DRAIN_S:
            engine.step()
    done = [r for r in reqs if len(r.generated) >= r.max_new_tokens]
    rec.requests = [(len(r.prompt), todo[r.rid]["due"], [t - t0 for t in r.token_walls])
                    for r in done]
    return {"requests": reqs, "done": done, "t0": t0, "backlog_at_close": backlog,
            "most_waiting": most_waiting, "most_admitted": most_admitted,
            "decoding_mean": sum(decoding) / max(sum(d > 0 for d in decoding), 1),
            "rows": rows, "drain_s": time.perf_counter() - t_drain,
            "ttft_ms": [(r.token_walls[0] - t0 - todo[r.rid]["due"]) * 1e3 for r in done],
            "itl_ms": [(b - a) * 1e3 for r in done
                       for a, b in zip(r.token_walls, r.token_walls[1:])],
            "late_s": late}


def traced_replay(engine, todo: list, seconds: float, device, rec: RunRecord,
                  plan: dict) -> dict:
    """After the drain, the window's requests due from ``warm_s`` before its
    middle on are served again on the wall clock, from an empty engine.  Once the replay has run ``warm_s`` (its slots filled
    as the window's were there) and a request is due, the profiler takes
    the next ``steps`` engine steps: that request's prefill, then decode
    steps of the slots then live.  No request is added while it traces:
    profiling slows the host some threefold, and arrivals on the wall clock
    would fill the slots far past the window's.  Then the replay drains.
    Returns the mean of the slots each traced decode step served."""
    from repro_torch.serving.scheduler import Request
    base = seconds / 2 - plan["warm_s"]
    part = [r for r in todo if r["due"] >= base] or todo[-1:]
    base = min(base, part[0]["due"])
    t0, sent = time.perf_counter(), 0

    def submit_due() -> None:
        nonlocal sent
        now = time.perf_counter() - t0
        while sent < len(part) and part[sent]["due"] - base <= now:
            r = part[sent]
            engine.submit(Request(rid=REPLAY_RID + sent, prompt=tuple(r["prompt"].tolist()),
                                  max_new_tokens=r["max_new"], arrival=engine.t))
            sent += 1

    def busy() -> bool:
        return engine.sched.has_work or sent < len(part)

    while busy():
        submit_due()
        if engine.sched.waiting and time.perf_counter() - t0 >= plan["warm_s"]:
            break
        if engine.sched.has_work:
            engine.step()
        else:
            time.sleep(0.001)
    decoding: list = []
    with attention_spy(rec), traced(device) as box:
        while len(decoding) < plan["steps"] and engine.sched.has_work:
            decoding.append(engine.step()["decoded"])
    rec.trace = box[0]
    while engine.sched.has_work:
        engine.step()
    return sum(decoding) / max(sum(d > 0 for d in decoding), 1)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float) -> dict:
    """The run's outcome (``bench/drivers/train.py``'s ``run``'s keys)."""
    conf, w = cell.config, cell.workload
    engine = open_engine(cell, seed, device, trace)
    todo = inputs.requests(cell.traffic, conf["vocab_size"], seed, seconds)
    rec = RunRecord("serve", conf, cell.traffic, w, chips=w.get("chips", 1))
    setup_s = time.perf_counter() - t_start
    win = window(engine, todo, seconds, device, rec)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    traced_decoding = None
    if trace:
        traced_decoding = traced_replay(engine, todo, seconds, device, rec, w["traced_replay"])
    done, reqs = win["done"], win["requests"]
    ttft = {f"ttft_p{q}_ms": _pct(win["ttft_ms"], q) if done else float("inf")
            for q in (50, 90, 95)}
    e2e = {"ttft_p50_ms": ttft["ttft_p50_ms"], "ttft_p90_ms": ttft["ttft_p90_ms"],
           "itl_p95_ms": _pct(win["itl_ms"], 95) if win["itl_ms"] else float("inf"),
           "setup_s": setup_s}
    samples, sample = served_sample(seed, done, w["check"]["served_tokens"])
    rows = [win["rows"].get(done[i].rid) for i in sample]
    preempted = engine.stats["preemptions"]
    del engine, done, win["done"], win["rows"]
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, gaps, kv = check_sample(conf, seed, samples, sample, rows, device)
    numbers = dict({"unfinished": (float(len(reqs) - len(rec.requests)), "requests")}, **numbers)
    ok, checks = compare.checks(numbers, w["check"]["limits"])
    return {"e2e": e2e, "peak": peak, "record": rec, "attempted": len(reqs),
            "failed": len(reqs) - len(rec.requests), "correct": ok, "checks": checks,
            "readings": {"gaps": gaps, "kv_gaps": [g for g, _ in kv], "sample": sample,
                         "ttft_ms": ttft, "late_s_max": max(win["late_s"], default=0.0),
                         "backlog_at_close": win["backlog_at_close"],
                         "most_waiting": win["most_waiting"],
                         "most_admitted": win["most_admitted"],
                         "decoding_window": win["decoding_mean"],
                         "decoding_traced": traced_decoding, "preemptions": preempted,
                         "served_tokens": sum(len(g) for _, g in samples),
                         "drain_s": win["drain_s"]}}


def check_sample(conf: dict, seed: int, samples: list, sample: list, rows: list,
                 device) -> tuple[dict, list, list]:
    """The serving numbers of the sampled requests against the fp32
    reference: ``logit_gap``, the widest gap by which a served token's
    logit lies below the reference's best; ``kv_gap``, the widest relative
    gap between the K or V rows decode steps wrote for them and the
    reference's.  Returns the numbers ({name: (value, where)}) and each
    sample's gaps."""
    if not samples or any(r is None for r in rows):
        nothing = (float("inf"), "no sample" if not samples else "rows missing")
        return {"logit_gap": nothing, "kv_gap": nothing}, [], []
    z = ref_serve.served_logits(conf, seed, samples, device, rows=rows)
    gaps = ref_serve.gaps(z["fp32"], [g for _, g in samples])
    kv = z["kv"]["program"]
    worst = int(np.argmax(gaps))
    kv_worst = max(range(len(kv)), key=lambda i: (kv[i][0] != kv[i][0], kv[i][0]))
    return ({"logit_gap": (max(gaps), f"request {sample[worst]}"),
             "kv_gap": (kv[kv_worst][0], f"request {sample[kv_worst]} {kv[kv_worst][1]}")},
            gaps, kv)


def served_sample(seed: int, done: list, min_served: int) -> tuple[list, list]:
    """(prompt, served tokens) of the sample the reference reads, and its
    indices into ``done``."""
    sample = inputs.sample_indices(seed, [len(r.prompt) + len(r.generated) for r in done],
                                   [len(r.generated) for r in done], min_served)
    return [(np.asarray(done[i].prompt), list(done[i].generated)) for i in sample], sample
