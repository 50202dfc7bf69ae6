#!/usr/bin/env python3
"""The readings that a cell's limits are set from, and the serving knee;
run on the card, not by the benchmark's runs.

    python3 bench/controls.py readings --workload <cell> --seeds 1,2,3 [--control]
        [--fault dropped_writes] [--seconds S]
    python3 bench/controls.py sweep --workload <serve cell> --rates 3,4,5 --seconds S --seed N

``readings``, for each seed: the port's numbers against the fp32 reference
(training: the set-up's checked steps; serving: a window of ``--seconds``
at the cell's load, drained, and its sample).  With ``--control``, the
control's too (the reference with its products in fp8 in the port's
place) and, for training, the fault of half the rows left out (the
reference on the first half of each batch, the mean over it).  With
``--fault dropped_writes`` (serving), the port's decode steps keep none of
their cache writes (``drop_cache_writes``).  ``sweep``
serves a window at each rate on one engine and prints the load it bore.
One JSON line per reading on standard output; also appended to
``chiprun_out/controls.jsonl``.
"""
import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _say(rec: dict) -> None:
    line = json.dumps(rec, default=float)
    print(line, flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "controls.jsonl", "a") as f:
        f.write(line + "\n")


@contextlib.contextmanager
def drop_cache_writes():
    """A fault of the serving path: every decode step's K and V writes to
    the paged pool are undone once the step has returned, so the step sees
    its own token but no later step does, and the cache is left as it was."""
    import torch
    from repro_torch.serving import steps
    decode = steps.paged_decode_step

    def dropped(cfg, params, cache, block_tables, lens, tokens, *a, **kw):
        bs, trash = cache["k"].shape[3], cache["k"].shape[1] - 1
        n = lens.long()
        at = n.clamp(min=0)
        bid = block_tables.long().gather(1, (at // bs)[:, None])[:, 0]
        bid = torch.where(n >= 0, bid, torch.full_like(bid, trash))
        off = at % bs
        held = {x: cache[x][:, bid, :, off].clone() for x in "kv"}
        logits, cache = decode(cfg, params, cache, block_tables, lens, tokens, *a, **kw)
        for x in "kv":
            cache[x][:, bid, :, off] = held[x]
        return logits, cache

    steps.paged_decode_step = dropped
    try:
        yield
    finally:
        steps.paged_decode_step = decode


def train_readings(cell, seeds, control: bool, device) -> None:
    from bench.drivers import train as train_cell
    from bench.harness import compare
    from bench.reference import train as ref_train
    w = cell.workload
    n = w["check"]["steps"]
    for seed in seeds:
        t = time.perf_counter()
        st = train_cell.start(cell, seed, device)
        prog = st["prog"]
        del st
        train_cell.free(device)
        t_prog = time.perf_counter() - t
        ref = ref_train.run(cell.config, w["optimizer"], cell.traffic, seed, n, device)
        t_ref = time.perf_counter() - t - t_prog
        rec = {"cell": cell.name, "seed": seed, "s_program": t_prog, "s_reference": t_ref,
               "program": {k: list(v) for k, v in compare.train_numbers(prog, ref).items()}}
        if control:
            for name, kw in (("fp8", {"prec": "fp8"}), ("half_rows", {"rows": "half"})):
                other = ref_train.run(cell.config, w["optimizer"], cell.traffic, seed, n,
                                      device, **kw)
                rec[name] = {k: list(v) for k, v in compare.train_numbers(other, ref).items()}
                train_cell.free(device)
        _say(rec)
        train_cell.free(device)


def serve_readings(cell, seeds, control: bool, fault: str | None, seconds: float,
                   device) -> None:
    import torch

    from bench.drivers import serve
    from bench.harness import inputs
    from bench.harness.record import RunRecord
    from bench.reference import serve as ref_serve
    w = cell.workload
    for seed in seeds:
        with drop_cache_writes() if fault == "dropped_writes" else contextlib.nullcontext():
            engine = serve.open_engine(cell, seed, device, False)
            todo = inputs.requests(cell.traffic, cell.config["vocab_size"], seed, seconds)
            win = serve.window(engine, todo, seconds, device,
                               RunRecord("serve", cell.config, cell.traffic, w))
        samples, sample = serve.served_sample(seed, win["done"], w["check"]["served_tokens"])
        rows = [win["rows"][win["done"][i].rid] for i in sample]
        rec = {"cell": cell.name, "seed": seed, "seconds": seconds, "fault": fault,
               "requests": len(win["requests"]), "done": len(win["done"]),
               "served_tokens": sum(len(g) for _, g in samples),
               "preemptions": engine.stats["preemptions"]}
        del engine, win
        serve.gc.collect()
        torch.cuda.empty_cache()
        precs = ("fp32", "fp8") if control else ("fp32",)
        z = ref_serve.served_logits(cell.config, seed, samples, device, precs, rows=rows)
        rec["program"] = {"logit_gap": max(ref_serve.gaps(z["fp32"], [g for _, g in samples])),
                          "kv_gap": max(g for g, _ in z["kv"]["program"])}
        if control:
            firsts = [zz.argmax(-1).tolist() for zz in z["fp8"]]
            rec["fp8"] = {"logit_gap": max(ref_serve.gaps(z["fp32"], firsts)),
                          "kv_gap": max(g for g, _ in z["kv"]["fp8"])}
        _say(rec)


def sweep(cell, rates, seconds: float, seed: int, device) -> None:
    import numpy as np

    from bench.drivers import serve
    from bench.harness import inputs
    from bench.harness.record import RunRecord
    engine = serve.open_engine(cell, seed, device, False)
    for rate in rates:
        todo = inputs.requests(cell.traffic, cell.config["vocab_size"], seed, seconds, rate)
        win = serve.window(engine, todo, seconds, device,
                           RunRecord("serve", cell.config, cell.traffic, cell.workload))
        done = win["done"]
        last = max((r.token_walls[-1] for r in done), default=win["t0"]) - win["t0"]
        q = lambda xs, p: float(np.percentile(xs, p)) if xs else None  # noqa: E731
        _say({"cell": cell.name, "rate": rate, "seconds": seconds, "requests": len(todo),
              "done": len(done), "backlog_at_close": win["backlog_at_close"],
              "most_waiting": win["most_waiting"], "most_admitted": win["most_admitted"],
              "drain_s": win["drain_s"], "last_token_s": last,
              "ttft_p50_ms": q(win["ttft_ms"], 50), "ttft_p90_ms": q(win["ttft_ms"], 90),
              "ttft_p95_ms": q(win["ttft_ms"], 95),
              "itl_p50_ms": q(win["itl_ms"], 50), "itl_p95_ms": q(win["itl_ms"], 95),
              "late_max_s": max(win["late_s"], default=0.0),
              "tokens_per_s": sum(len(r.generated) for r in done) / max(last, 1e-9)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("readings", "sweep"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rates", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=("dropped_writes",))
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from bench.harness import spec
    if not torch.cuda.is_available():
        print("controls.py needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    if args.what == "sweep":
        sweep(cell, [float(r) for r in args.rates.split(",")], args.seconds, args.seed, device)
    elif cell.kind == "train":
        train_readings(cell, seeds, args.control, device)
    else:
        serve_readings(cell, seeds, args.control, args.fault, args.seconds, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
