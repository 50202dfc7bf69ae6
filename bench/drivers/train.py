"""A training cell: the port's ``stepfn.build_train_step`` (the layered
schedule over fp32 ZeRO chunks, then AdamW) on the cell's configuration,
driven from the seed.

Set-up builds the one step and its state, and drives it through the
cell's first ``check.steps`` steps, on batches of the window's own feed;
their losses, the first gradient as the optimizer holds it (its first
moment after one step, over 1 - b1) and the weights' change over them are
read before the window goes on with the same object.  The window runs
whole steps, a fresh batch drawn on the card for each, one host sync a
step on the loss (as ``launch.train`` does), until ``seconds`` have
passed.  After it the port's state is freed and the reference repeats the
checked steps."""
from __future__ import annotations

import gc
import time

import torch

from bench.harness import compare, inputs
from bench.harness.profiling import traced
from bench.harness.record import RunRecord, attention_spy
from bench.harness.spec import Cell, model_config
from bench.reference import train as ref_train

UNITS = {"train_tokens_per_s": "tokens/s", "train_peak_gb": "GB", "setup_s": "s"}


def leaf_norms(tree_: dict, scale: float = 1.0) -> dict:
    """{leaf name: norm} of a storage-layout tree, one entry a layer for the
    stacked layer leaves."""
    from repro_torch import tree
    names, vals = [], []
    for path, t in tree.leaves_with_path(tree_):
        if path[0] == "layers":
            for l in range(t.shape[0]):
                names.append(f"layers.{l}." + ".".join(path[1:]))
                vals.append(t[l].norm())
        else:
            names.append(".".join(path))
            vals.append(t.norm())
    return {n: v * scale for n, v in zip(names, torch.stack(vals).tolist())}


def _initial_storage(cfg, conf: dict, seed: int, partitioned: bool, device, layer=None):
    """The seed's fp32 weights in the port's storage layout (through its
    ``stepfn.storage_from_params``): the outer leaves, or layer ``layer``'s
    leaves stacked on a dim of one."""
    from repro_torch import tree
    from repro_torch.core import stepfn
    if layer is None:
        outer = inputs.outer_weights(conf, seed, device)
        return stepfn.storage_from_params(cfg, outer, partitioned=partitioned)
    one = tree.tree_map(lambda t: t[None], inputs.layer_weights(conf, seed, layer, device))
    return stepfn.storage_from_params(cfg, {"layers": one}, partitioned=partitioned)["layers"]


def build_storage(cfg, conf: dict, seed: int, partitioned: bool, device) -> dict:
    from repro_torch import tree
    out = _initial_storage(cfg, conf, seed, partitioned, device)
    layers = None
    for l in range(cfg.num_layers):
        one = _initial_storage(cfg, conf, seed, partitioned, device, layer=l)
        if layers is None:
            layers = tree.tree_map(lambda t: torch.empty((cfg.num_layers, *t.shape[1:]),
                                                         dtype=torch.float32, device=device), one)
        tree.tree_map(lambda buf, t: buf[l].copy_(t[0]), layers, one)
    return dict(out, layers=layers)


def change_norms(storage: dict, cfg, conf: dict, seed: int, partitioned: bool, device) -> dict:
    """{leaf: norm of its change from the seed's initial weights}."""
    from repro_torch import tree
    with torch.no_grad():
        now = {k: v for k, v in storage.items() if k != "layers"}
        diff = tree.tree_map(lambda a, b: a - b, now,
                             _initial_storage(cfg, conf, seed, partitioned, device))
        out = leaf_norms(diff)
        for l in range(cfg.num_layers):
            d = tree.tree_map(lambda a, b: a[l:l + 1] - b, storage["layers"],
                              _initial_storage(cfg, conf, seed, partitioned, device, layer=l))
            out.update({n.replace("layers.0.", f"layers.{l}.", 1): v
                        for n, v in leaf_norms({"layers": d}).items()})
    return out


def start(cell: Cell, seed: int, device) -> dict:
    """Set-up: the step, its state from the seed, and the first
    ``check.steps`` steps through it with the port's readings of them."""
    from repro_torch.core import stepfn
    from repro_torch.core.accumulation import AccumConfig
    from repro_torch.optim.adam import AdamConfig, adam_init

    conf, traffic, w = cell.config, cell.traffic, cell.workload
    cfg = model_config(conf)
    sched = w["schedule"]
    acc = AccumConfig(method=sched["method"], partitioned=sched["partitioned"],
                      n_microbatches=traffic["n_microbatches"])
    opt_cfg = AdamConfig(**w["optimizer"])
    step = stepfn.build_train_step(cfg, acc, opt_cfg)
    storage = build_storage(cfg, conf, seed, acc.partitioned, device)
    opt = adam_init(storage)
    prog = {"loss": []}
    for i in range(w["check"]["steps"]):
        storage, opt, m = step(storage, opt,
                               inputs.train_batch(traffic, conf["vocab_size"], seed, i, device))
        prog["loss"].append(float(m["loss"]))
        if i == 0:
            prog["grad_norm"] = leaf_norms(opt["mu"], 1.0 / (1.0 - opt_cfg.b1))
    prog["change"] = change_norms(storage, cfg, conf, seed, acc.partitioned, device)
    return {"step": step, "storage": storage, "opt": opt, "prog": prog}


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float) -> dict:
    """The run's outcome: ``e2e`` (end-to-end metrics), ``peak`` (bytes),
    ``record`` (for the readers), ``attempted``, ``failed``, ``correct``,
    ``checks`` and ``readings``."""
    conf, traffic, w = cell.config, cell.traffic, cell.workload
    V = conf["vocab_size"]
    tokens_per_step = traffic["global_batch"] * traffic["seq_len"]
    st = start(cell, seed, device)
    step, storage, opt, prog = st.pop("step"), st.pop("storage"), st.pop("opt"), st.pop("prog")

    rec = RunRecord("train", conf, traffic, w, chips=w.get("chips", 1))
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    i = w["check"]["steps"]
    while True:
        batch = inputs.train_batch(traffic, V, seed, i, device)
        a = time.perf_counter()
        storage, opt, m = step(storage, opt, batch)
        rec.enqueue_s.append(time.perf_counter() - a)
        float(m["loss"])                      # the step's one host sync
        i += 1
        rec.steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    rec.window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    e2e = {"train_tokens_per_s": rec.steps * tokens_per_step / rec.window_s,
           "train_peak_gb": peak / 1e9, "setup_s": setup_s}

    if trace:
        n = w.get("traced_steps", 2)
        with attention_spy(rec), traced(device) as box:
            for _ in range(n):
                storage, opt, m = step(storage, opt, inputs.train_batch(traffic, V, seed, i, device))
                float(m["loss"])
                i += 1
        rec.trace, rec.traced_steps = box[0], n

    del storage, opt, step, m, batch
    free(device)
    ref = ref_train.run(conf, w["optimizer"], traffic, seed, w["check"]["steps"], device)
    ok, checks = compare.checks(compare.train_numbers(prog, ref), w["check"]["limits"])
    return {"e2e": e2e, "peak": peak, "record": rec, "attempted": rec.steps, "failed": 0,
            "correct": ok, "checks": checks, "readings": {"prog": prog, "ref": ref}}
