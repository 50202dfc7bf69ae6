#!/usr/bin/env python3
"""Where a decode step over a process group spends its extra time, on one
card: a world-size-1 NCCL group against the one-rank steps.

    python3 tools/torch_group_host.py [--profile]

Prints (1) the host cost of one bf16 all-reduce of a decode step's
activation ``[8, 1, 4096]`` through ``torch.distributed`` and through the
port's counting ``AxisCtx.all_reduce``, beside one plain kernel launch,
each over 200 calls; (2) Yi-6B at full depth, paged, 8 slots of 256 cached
tokens: ``--steps`` greedy decode steps of ``paged_decode_step`` one rank
and over the group, in turns, each synchronised and timed on the host;
(3) with ``--profile``, ``torch.profiler``'s operators by self CPU time
over 4 decode steps of each.  Run it under different ``TORCH_NCCL_*``
settings (they are read when the group is made) to see whether one removes
the group's extra.  Every line carries the card's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import numpy as np
    import torch
    import torch.distributed as tdist
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch import configs
    from repro_torch.core import dist
    from repro_torch.core.dist import LOCAL
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as T
    from repro_torch.serving import steps
    from repro_torch.serving.cache import PagedCacheConfig, init_paged_cache

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_group_host: needs a CUDA device", flush=True)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    env = {k: v for k, v in os.environ.items() if k.startswith("TORCH_NCCL")}
    _build.build()
    _build.library()
    with chip_smoke.one_rank_launch():
        axis = dist.from_env(1, 1, torch.device("cuda"))
        try:
            t = torch.zeros(8, 1, 4096, dtype=torch.bfloat16, device="cuda")
            for label, fn in (("torch.distributed.all_reduce",
                               lambda: tdist.all_reduce(t, group=axis.model)),
                              ("AxisCtx.all_reduce", lambda: axis.all_reduce(t, "model")),
                              ("one plain launch (t.add_)", lambda: t.add_(1))):
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    fn()
                host = (time.perf_counter() - t0) / 200 * 1e6
                torch.cuda.synchronize()
                print(f"{smi}, {env}: {label} {host:.1f} us of host a call, "
                      f"{(time.perf_counter() - t0) / 200 * 1e6:.1f} us to the sync", flush=True)
            cfg = configs.get_config("yi-6b")
            params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
                                   axis)
            R, bs, maxb = 8, 16, 36
            pcfg = PagedCacheConfig(num_blocks=R * maxb, block_size=bs, max_blocks_per_seq=maxb)
            toks = torch.from_numpy(np.random.default_rng(0).integers(
                0, cfg.vocab_size, (R, 256)).astype(np.int32)).cuda()
            lens = torch.full((R,), 256, dtype=torch.int32, device="cuda")
            tables = torch.arange(R * maxb, dtype=torch.int32, device="cuda").view(R, maxb)
            runs = {}
            for label, ax, dec in (("one rank", LOCAL, steps.build_paged_decode_fn(cfg)),
                                   ("group", axis, steps.build_paged_serve_step(cfg, axis=axis))):
                cache = init_paged_cache(cfg, pcfg, "cuda", ax)
                lg, cache = steps.build_paged_prefill_fn(cfg, ax)(
                    params, cache, {"tokens": toks, "lens": lens}, tables)
                runs[label] = {"decode": dec, "cache": cache, "logits": lg, "ms": []}

            def step(r, i):
                r["logits"], r["cache"] = r["decode"](params, r["cache"], tables, lens + i,
                                                      r["logits"].argmax(-1).int())

            for i in range(args.steps):
                for r in runs.values():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step(r, i)
                    torch.cuda.synchronize()
                    r["ms"].append(1e3 * (time.perf_counter() - t0))
            ms = {k: sum(r["ms"][2:]) / len(r["ms"][2:]) for k, r in runs.items()}
            print(f"{smi}, {env}: Yi-6B paged decode, 8 slots, mean of {args.steps - 2} steps: "
                  f"one rank {ms['one rank']:.2f} ms, group {ms['group']:.2f} ms "
                  f"({ms['group'] - ms['one rank']:+.2f})", flush=True)
            if args.profile:
                for label, r in runs.items():
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        for i in range(args.steps, args.steps + 4):
                            step(r, i)
                        torch.cuda.synchronize()
                    print(f"--- {label}, 4 decode steps under the profiler", flush=True)
                    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=12),
                          flush=True)
        finally:
            tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
