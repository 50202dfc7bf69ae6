#!/usr/bin/env python3
"""The data-parallel dimension of the ZeRO state on the cards of one host:
the pod axis, and a failure-shrink that drains a lost replica's chunks to
the survivors.  One world of 4 ranks; each part makes its own grids over it.

  pods    Yi-6B over pod x data x model 2x2x1, the partition over (pod,
          data) (``span_pods``) and over data with the gradients summed
          over pod, beside data 4 (1x4x1): ``POD_STEPS`` steps each, bf16
          at ``--layers`` layers, ``GLOBAL_BATCH`` x ``--seq-len`` tokens
          in ``MICROBATCHES`` micro-batches.  Per run: step seconds (the
          mean after the first), the bytes a step of every (group, op) (the
          pod and partition groups cross pods, the data group stays in one),
          peak GB a rank.  Gate: step 0's loss and grad norm at an fp32
          ``CHECK_LAYERS``-layer cut within ``GATE`` of 1x4x1's.
  shrink  the supervised loop (``resilience/supervisor.py``) on data x model
          2x2, a ``lose_replica`` fault before step ``LOSE_AT`` of
          ``STEPS``: the last data row drains its chunks to the survivors,
          which go on at 1x2.  Gate: an fp32 ``CHECK_LAYERS``-layer cut,
          shrunk and unshrunk, every step's loss within ``GATE``; then the
          bf16 runs at ``--layers`` layers: the unshrunk run, and the shrunk
          one, checkpointing every ``LOSE_AT`` steps (the pre-shrink
          checkpoint and one the survivors write), whose leaving ranks end
          their processes after the drain (a leaver's NCCL teardown must not
          touch the survivors' groups).  Per run: losses, step seconds, peak
          GB a rank before and after the shrink, the drain's
          ``recovery_time_s`` and bytes; then the survivors restore the
          pre-shrink checkpoint onto 1x2 instead, timed (the other way to
          recover, which loses the steps since that checkpoint).

Rank 0 prints each result beside the card's name and power limit and
writes ``OUT/replica_cards.json``; every rank writes ``OUT/rank<r>.json``.
The checkpoints go under ``CKPT_DIR`` (in the gitignored ``build/``) and
are removed at the end.

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        tools/torch_replica_cards.py OUT

With ``--smoke --device cpu`` it runs Yi-6B's smoke config on gloo, for a
rehearsal.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
CHECK_LAYERS = 2     # the fp32 gates' depth
GATE = 1e-4          # fp32 losses and grad norms against the reference run, relative
OPT = dict(lr=3e-3, warmup_steps=1, decay_steps=100)
GLOBAL_BATCH = 16    # rows a step
MICROBATCHES = 4
POD_STEPS = 4        # steps of each pods run
STEPS = 8            # steps of each supervised run
LOSE_AT = 3          # the lose_replica fault's step, and the shrunk run's checkpoint interval
CKPT_DIR = ROOT / "build" / "replica_ck"


def main() -> int:
    import torch
    import torch.distributed as tdist

    from repro_torch import configs
    from repro_torch.core import dist, stepfn
    from repro_torch.core.accumulation import AccumConfig
    from repro_torch.data.synthetic import DataConfig, batch_for
    from repro_torch.device import resolve_device
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.optim.adam import AdamConfig, adam_init
    from repro_torch.resilience import faults as flt
    from repro_torch.resilience.reshard import MeshLayout
    from repro_torch.resilience.supervisor import Supervisor, SupervisorConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    device = resolve_device(args.device)
    world = dist.from_env(4, 1, device)        # data 4: the pods part's reference grid
    rank = tdist.get_rank()
    cuda = device.type == "cuda"
    if cuda:
        device = torch.device("cuda", torch.cuda.current_device())
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines() or ["?"])[0] \
        if cuda else "cpu"
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    M = MICROBATCHES
    ckpt_dir = str(CKPT_DIR)
    res: dict = {"card": smi, "args": vars(args)}

    def say(*a):
        if rank == 0:
            print(*a, flush=True)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def peak_gb() -> float:
        return torch.cuda.max_memory_allocated(device) / 1e9 if cuda else 0.0

    def reset_peak():
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)

    def cfg_of(layers: int, dtype: str | None = None):
        cfg = dataclasses.replace(configs.get_config("yi-6b", smoke=args.smoke),
                                  num_layers=layers)
        return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg

    data = DataConfig(cfg_of(1).vocab_size, args.seq_len, GLOBAL_BATCH, M, seed=SEED)

    # ---- pods -----------------------------------------------------------
    pods = dist.make_axis(2, 1, npod=2)

    def train_run(cfg, axis, span: bool, steps: int) -> dict:
        """``steps`` layered partitioned steps: losses, grad norms, step
        seconds, each step's collectives, the peak."""
        reset_peak()
        step = stepfn.build_train_step(cfg, AccumConfig("layered", True, M, span_pods=span),
                                       AdamConfig(**OPT), axis=axis)
        storage = stepfn.init_storage(cfg, SEED, partitioned=True, device=device, axis=axis,
                                      span_pods=span)
        opt = adam_init(storage)
        r = {"loss": [], "grad_norm": [], "step_s": [], "collectives": []}
        for i in range(steps):
            batch = batch_for(cfg, data, i, axis)
            axis.reset_counts()
            sync()
            t0 = time.perf_counter()
            storage, opt, m = step(storage, opt, batch)
            r["loss"].append(m["loss"].item())
            r["grad_norm"].append(m["grad_norm"].item())
            r["step_s"].append(time.perf_counter() - t0)
            r["collectives"].append({f"{g} {op}": list(c) for (g, op), c in axis.counts.items()})
        r["peak_gb"] = peak_gb()
        del storage, opt, step
        return r

    grids = {"1x4x1": (world, False), "2x2x1 span": (pods, True),
             "2x2x1 no span": (pods, False)}
    res["pods"] = {}
    for name, (axis, span) in grids.items():
        r = train_run(cfg_of(args.layers), axis, span, POD_STEPS)
        r["check"] = train_run(cfg_of(CHECK_LAYERS, "float32"), axis, span, 1)
        res["pods"][name] = r
        steady = r["step_s"][1:] or r["step_s"]
        say(f"pods {name} on {smi}: step {sum(steady) / len(steady):.4f} s (steps "
            f"{[round(t, 4) for t in r['step_s']]}), peak {r['peak_gb']:.2f} GB a rank, losses "
            f"{[round(x, 6) for x in r['loss']]}; bytes a step by (group, op) "
            f"{ {k: v[1] for k, v in r['collectives'][-1].items()} }; fp32 {CHECK_LAYERS}-layer "
            f"step 0 loss {r['check']['loss'][0]:.8f}, grad norm "
            f"{r['check']['grad_norm'][0]:.8f}")
    ref = res["pods"]["1x4x1"]["check"]
    problems = []
    for name, r in res["pods"].items():
        for k in ("loss", "grad_norm"):
            d = abs(r["check"][k][0] - ref[k][0]) / abs(ref[k][0])
            r["check"][f"{k}_rel_diff"] = d
            if d > GATE:
                problems.append(f"pods {name}: fp32 step 0 {k} {d:.2e} from 1x4x1's")

    # ---- shrink ---------------------------------------------------------
    class Sink(obs_metrics.MetricsSink):
        """Keeps the records and, after each step, the step's peak memory."""

        def __init__(self):
            super().__init__(None)
            self.records = []

        def log(self, record=None, *, event="step", **kw):
            rec = dict(record or {}, **kw, event=event)
            if event == "step":
                rec["peak_gb"] = peak_gb()
                reset_peak()
            self.records.append(rec)
            return super().log(record, event=event, **kw)

    def supervised(cfg, faults, root: str, every: int) -> dict:
        reset_peak()
        sink = Sink()
        sv = Supervisor(cfg, AdamConfig(**OPT), data, MeshLayout(1, 2, 2, n_microbatches=M),
                        ckpt_root=root, sup=SupervisorConfig(checkpoint_every=every,
                                                             keep_checkpoints=2),
                        fault_plan=flt.FaultPlan(faults), sink=sink,
                        axis=dist.make_axis(2, 2), device=device)
        r = sv.run(STEPS)
        steps = [rec for rec in sink.records if rec["event"] == "step"]
        r = {"left": r.get("left"), "shrinks": r["shrinks"], "lost_steps": r["lost_steps"],
             "restarts": r["restarts"], "final_layout": r["final_layout"],
             "loss": [rec["loss"] for rec in steps], "step_s": [rec["step_time_s"] for rec in steps],
             "peak_gb": [rec["peak_gb"] for rec in steps],
             "shrink": [rec for rec in sink.records if rec["event"] == "shrink"],
             "io": sv.io}
        del sv
        return r

    lose = lambda: [flt.Fault("lose_replica", LOSE_AT)]  # noqa: E731 (a plan fires its own)
    shutil.rmtree(ckpt_dir, ignore_errors=True) if rank == 0 else None
    tdist.barrier()
    check = {"unshrunk": supervised(cfg_of(CHECK_LAYERS, "float32"), [],
                                    os.path.join(ckpt_dir, "check_a"), 10 ** 6),
             "shrunk": supervised(cfg_of(CHECK_LAYERS, "float32"), lose(),
                                  os.path.join(ckpt_dir, "check_b"), 10 ** 6)}
    res["shrink_check"] = check
    if check["shrunk"]["left"] is None:
        for s, (a, b) in enumerate(zip(check["shrunk"]["loss"], check["unshrunk"]["loss"])):
            if abs(a - b) / abs(b) > GATE:
                problems.append(f"shrink: fp32 step {s} loss {a} against the unshrunk {b}")
        say(f"shrink fp32 {CHECK_LAYERS}-layer gate: largest loss rel diff "
            f"{max(abs(a - b) / abs(b) for a, b in zip(check['shrunk']['loss'], check['unshrunk']['loss'])):.2e}")
    big = cfg_of(args.layers)
    res["shrink"] = {"unshrunk": supervised(big, [], os.path.join(ckpt_dir, "a"), 10 ** 6)}
    root = os.path.join(ckpt_dir, "b")
    res["shrink"]["shrunk"] = r = supervised(big, lose(), root, LOSE_AT)
    if r["left"] is not None:
        # a leaving rank: its process ends here; the survivors go on
        (out / f"rank{rank}.json").write_text(json.dumps(res))
        tdist.destroy_process_group()
        return 1 if problems else 0
    u = res["shrink"]["unshrunk"]
    r["loss_rel_diff"] = [abs(a - b) / abs(b) for a, b in zip(r["loss"], u["loss"])]
    # the survivors' checkpoint records their grid; then the other way to
    # recover: restore the pre-shrink checkpoint onto 1x2 (the survivors
    # only) and take one step from it
    grid = dist.make_axis(1, 2, ranks=[0, 1])
    after = os.path.join(root, f"step_{2 * LOSE_AT:08d}")    # the first the survivors wrote
    r["post_shrink_checkpoint_data"] = json.loads(
        pathlib.Path(after, "manifest.json").read_text())["meta"]["layout"]["data"]
    tdist.barrier(group=grid.world)
    if rank == 0:
        shutil.rmtree(after)
    tdist.barrier(group=grid.world)
    sv = Supervisor(big, AdamConfig(**OPT), data, MeshLayout(1, 1, 2, n_microbatches=M),
                    ckpt_root=root, sup=SupervisorConfig(checkpoint_every=10 ** 6),
                    axis=grid, device=device)
    t0 = time.perf_counter()
    sv.run(LOSE_AT + 1)
    sync()
    res["restore"] = {"seconds": time.perf_counter() - t0, "io": sv.io,
                      "loss": sv.history_by_step()[LOSE_AT]["loss"],
                      "drained_loss": r["loss"][LOSE_AT]}
    del sv
    say(f"shrink on {smi}: unshrunk 2x2 losses {[round(x, 6) for x in u['loss']]}; shrunk "
        f"{[round(x, 6) for x in r['loss']]} (rel diff max {max(r['loss_rel_diff']):.2e}), "
        f"shrinks {r['shrinks']}, lost steps {r['lost_steps']}, restarts {r['restarts']}; "
        f"drain {r['shrink']}; step s unshrunk {[round(t, 4) for t in u['step_s']]}, shrunk "
        f"{[round(t, 4) for t in r['step_s']]}; peak GB a rank by step {r['peak_gb']}; "
        f"checkpoint io {r['io']}; restoring the pre-shrink checkpoint onto 1x2 instead: "
        f"{res['restore']}")
    if r["shrinks"] != 1 or r["lost_steps"] or r["restarts"] or r["final_layout"]["data"] != 1 \
            or r["post_shrink_checkpoint_data"] != 1:
        problems.append(f"shrink: {r['shrinks']} shrinks, {r['lost_steps']} lost steps, the "
                        f"survivors' checkpoint at data {r['post_shrink_checkpoint_data']}")
    res["problems"] = problems
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    tdist.barrier(group=grid.world)
    if rank == 0:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        parts = {p.name: json.loads(p.read_text()) for p in sorted(out.glob("rank*.json"))}
        (out / "replica_cards.json").write_text(json.dumps(
            {"rank0": res, "peak_gb": {k: {"pods": {n: v["peak_gb"] for n, v in p["pods"].items()},
                                           "shrunk": p["shrink"]["shrunk"]["peak_gb"]}
                                       for k, p in parts.items()}}, indent=1))
        say(json.dumps({"problems": problems}))
    tdist.destroy_process_group()
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
