#!/usr/bin/env python3
"""Time the port's pipelined trainer across the cards of one host.

Every rank runs ``repro_torch.launch.train`` with the flags given and writes
its per-step records (step time, loss, grad norm, peak device memory, its
collective counts) to ``OUT/<tag>.rank<r>.json``; rank 0 then prints, per
step, the step time and every rank's peak memory, and one summary line with
the card's name and power limit.

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        tools/torch_pipeline_cards.py OUT TAG --arch yi-6b --stages 4 --mesh 1x1 \\
        --global-batch 8 --seq-len 2048 --microbatches 4 --steps 5 --schedule modular

(With ``--device cpu`` it runs on gloo, for a rehearsal at a small size.)
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    out, tag, argv = pathlib.Path(sys.argv[1]), sys.argv[2], sys.argv[3:]
    out.mkdir(parents=True, exist_ok=True)
    from repro_torch.launch import train

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    res = train.main(argv)
    tmp = out / f"{tag}.rank{rank}.json.tmp"
    tmp.write_text(json.dumps({"rank": rank, "records": res["records"],
                               "device": res["device"]}))
    os.replace(tmp, out / f"{tag}.rank{rank}.json")    # whole, when rank 0 sees it
    if rank != 0:
        return 0
    paths = [out / f"{tag}.rank{r}.json" for r in range(world)]
    deadline = time.time() + 120
    while not all(p.exists() for p in paths) and time.time() < deadline:
        time.sleep(0.5)
    ranks = [json.loads(p.read_text()) for p in paths]
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        smi = f"no nvidia-smi ({res['device']})"
    for i, r in enumerate(res["records"]):
        peaks = [rk["records"][i]["peak_mem_gb"] for rk in ranks]
        print(f"{tag} step {i}: {r['step_time_s']:.4f} s, {r['tokens_per_s']:.0f} tok/s, loss "
              f"{r['loss']:.6f}, grad norm {r['grad_norm']:.6f}, peak GB by rank {peaks}",
              flush=True)
    steady = res["records"][1:]
    mean = sum(r["step_time_s"] for r in steady) / len(steady)
    peak = max((rk["records"][-1]["peak_mem_gb"] or 0.0) for rk in ranks)
    print(f"{tag} on {world} x {smi}: steady step {mean:.4f} s, "
          f"{sum(r['tokens_per_s'] for r in steady) / len(steady):.0f} tok/s, MFU "
          f"{100 * sum(r['mfu'] for r in steady) / len(steady):.2f}% per card, "
          f"max peak {peak:.2f} GB; rank 0's collectives a step {steady[-1]['collectives']}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
