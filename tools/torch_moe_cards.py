#!/usr/bin/env python3
"""Time the port's expert-parallel MoE training across the cards of one host.

Every rank trains dbrx-132b (every published width, all 16 experts, depth cut
by ``--layers``) with the layered, partitioned step and
``AccumConfig(expert_parallel=True)``: each of the D data ranks holds 16 / D
experts resident and tokens reach them by all-to-all (``launch.train`` has no
such flag, as the JAX trainer has none).  Each rank writes its per-step
records (step time, loss, grad norm, aux, peak device memory, its collective
counts) to ``OUT/<tag>.rank<r>.json``; rank 0 prints each step, and one
summary line with the card's name and power limit: step time, tok/s, MFU a
card (6ND at the active parameters), peak memory a card, all-to-all calls and
bytes a step.

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        tools/torch_moe_cards.py OUT TAG --layers 3 --global-batch 16 \\
        --seq-len 2048 --microbatches 4 --steps 5

``--gathered`` trains the experts as ZeRO chunks instead (the paper's
layout).  With ``--device cpu --smoke`` it runs the smoke config on gloo, for
a rehearsal.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    import torch

    from repro_torch import configs
    from repro_torch.core import dist, roofline, stepfn
    from repro_torch.core.accumulation import AccumConfig
    from repro_torch.data.synthetic import DataConfig, batch_for
    from repro_torch.device import resolve_device
    from repro_torch.optim.adam import AdamConfig, adam_init

    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("tag")
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--gathered", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    world = int(os.environ["WORLD_SIZE"])
    device = resolve_device(args.device)
    axis = dist.from_env(world, 1, device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    rank = torch.distributed.get_rank()
    try:
        cfg = dataclasses.replace(configs.get_config("dbrx-132b", smoke=args.smoke),
                                  num_layers=args.layers)
        ep = not args.gathered
        acc = AccumConfig("layered", True, args.microbatches, expert_parallel=ep)
        step = stepfn.build_train_step(cfg, acc, AdamConfig(lr=3e-3, warmup_steps=1,
                                                             decay_steps=args.steps),
                                       axis=axis)
        t0 = time.perf_counter()
        storage = stepfn.init_storage(cfg, 0, partitioned=True, device=device, axis=axis,
                                      expert_resident=ep)
        opt = adam_init(storage)
        init_s = time.perf_counter() - t0
        data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                          global_batch=args.global_batch, n_microbatches=args.microbatches)
        tokens = args.global_batch * args.seq_len
        flops = roofline.model_flops_train(cfg, args.global_batch, args.seq_len)
        recs = []
        for i in range(args.steps):
            batch = batch_for(cfg, data, i, axis)
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            axis.reset_counts()
            t0 = time.perf_counter()
            storage, opt, m = step(storage, opt, batch)
            loss = float(m["loss"])                   # device sync: ends the step
            dt = time.perf_counter() - t0
            recs.append({"step": i, "step_time_s": dt, "tokens_per_s": tokens / dt,
                         "mfu": roofline.mfu(flops, dt, n_devices=world), "loss": loss,
                         "grad_norm": float(m["grad_norm"]), "aux": float(m["aux"]),
                         "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                                         if device.type == "cuda" else None),
                         "collectives": {f"{g} {op}": list(c)
                                         for (g, op), c in axis.counts.items()}})
    finally:
        torch.distributed.destroy_process_group()
    tmp = out / f"{args.tag}.rank{rank}.json.tmp"
    tmp.write_text(json.dumps({"rank": rank, "records": recs, "init_s": init_s}))
    os.replace(tmp, out / f"{args.tag}.rank{rank}.json")    # whole, when rank 0 sees it
    if rank != 0:
        return 0
    paths = [out / f"{args.tag}.rank{r}.json" for r in range(world)]
    deadline = time.time() + 120
    while not all(p.exists() for p in paths) and time.time() < deadline:
        time.sleep(0.5)
    ranks = [json.loads(p.read_text()) for p in paths]
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        smi = f"no nvidia-smi ({device})"
    for i, r in enumerate(recs):
        peaks = [rk["records"][i]["peak_mem_gb"] for rk in ranks]
        print(f"{args.tag} step {i}: {r['step_time_s']:.4f} s, {r['tokens_per_s']:.0f} tok/s, "
              f"loss {r['loss']:.6f}, grad norm {r['grad_norm']:.6f}, aux {r['aux']:.6f}, "
              f"peak GB by rank {peaks}", flush=True)
    steady = recs[1:] or recs
    mean = sum(r["step_time_s"] for r in steady) / len(steady)
    peak = max((rk["records"][-1]["peak_mem_gb"] or 0.0) for rk in ranks)
    a2a = steady[-1]["collectives"].get("expert all_to_all", [0, 0])
    print(f"{args.tag} on {world} x {smi}: dbrx-132b width {cfg.d_model}, {cfg.num_layers} "
          f"layers, {cfg.num_experts} experts ({cfg.num_experts // world if ep else 'all'} a "
          f"rank, {'resident' if ep else 'ZeRO chunks'}), {args.global_batch} x "
          f"{args.seq_len} tokens in {args.microbatches} micro-batches; steady step "
          f"{mean:.4f} s, {sum(r['tokens_per_s'] for r in steady) / len(steady):.0f} tok/s, "
          f"MFU {100 * sum(r['mfu'] for r in steady) / len(steady):.2f}% per card, max peak "
          f"{peak:.2f} GB; all-to-alls a step {a2a[0]} calls, {a2a[1] / 1e9:.3f} GB; init "
          f"{ranks[0]['init_s']:.1f} s; rank 0's collectives a step "
          f"{steady[-1]['collectives']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
