"""Training entry point: real steps on one card, or on a data x model grid
of processes (counterpart of ``repro/launch/train.py``).

Runs ``build_train_step`` (layered or standard accumulation, over the fp32
ZeRO chunk layout unless ``--no-partition``, then AdamW: the fused one-pass
kernel on the chunks) on deterministic synthetic data.  Weights are random,
drawn from ``--seed``; the run goes on the card unless ``--device cpu`` is
given (the plain PyTorch versions of the kernels).

``--mesh DxM`` runs D data-parallel (ZeRO) by M tensor-parallel ranks under
``python -m torch.distributed.run --nproc_per_node D*M``: NCCL on the cards
(rank r on card LOCAL_RANK), gloo with ``--device cpu``.  Under the launcher
even ``--mesh 1x1`` runs the process-group path (every collective issued, on
a group of one); outside it only ``--mesh 1x1`` runs, with no group.  Rank 0
prints.

``--stages S`` (S > 1) takes the pipelined path: ``--schedule`` (modular,
naive/gpipe, 1f1b, interleaved; ``--split-backward`` for the zero-bubble
split) over S stages of the D x M mesh, S*D*M processes in rank order
``(s*D + d)*M + m``, through ``stepfn.build_pipeline_train_step``.
``--stages 1`` keeps the unpipelined path.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \\
      --device cpu --steps 3
  PYTHONPATH=src python -m torch.distributed.run --nproc_per_node 4 \\
      -m repro_torch.launch.train --arch yi-6b --smoke --device cpu --mesh 2x2 --steps 3
  PYTHONPATH=src python -m torch.distributed.run --nproc_per_node 8 \\
      -m repro_torch.launch.train --arch yi-6b --smoke --device cpu --stages 2 \\
      --mesh 2x2 --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --layers 8 \\
      --global-batch 8 --seq-len 2048 --microbatches 4 --steps 5
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch
import torch.distributed

from repro_torch import configs
from repro_torch.core import dist, stepfn
from repro_torch.core.accumulation import AccumConfig
from repro_torch.core.schedules import KNOWN_SCHEDULES, PipeSpec
from repro_torch.data.synthetic import DataConfig, batch_for
from repro_torch.device import resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.optim.adam import AdamConfig, adam_init
from repro_torch.planner.simulator import EXECUTABLE_SCHEDULES

# the JAX trainer's flags for what the port has not yet: each is refused
NOT_PORTED = ("--plan", "--checkpoint-dir", "--resume", "--faults", "--metrics", "--trace",
              "--drift-report")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers at full width (0: the "
                         "config's depth)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--method", default="layered", choices=["layered", "standard"])
    ap.add_argument("--no-partition", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="1x1",
                    help="data x model ranks, DxM; more than one rank needs "
                         "python -m torch.distributed.run --nproc_per_node D*M")
    ap.add_argument("--stages", type=int, default=1,
                    help="pipeline stages; > 1 trains through the tick-table executor")
    ap.add_argument("--schedule", default="modular",
                    help="pipeline schedule with --stages > 1: modular, naive/gpipe, 1f1b "
                         "or interleaved")
    ap.add_argument("--split-backward", action="store_true",
                    help="with --stages > 1: split each backward unit into dgrad and "
                         "wgrad ticks (same gradients, another order)")
    ap.add_argument("--log-every", type=int, default=1)
    for flag in NOT_PORTED:
        ap.add_argument(flag, nargs="?", const=True, default=None,
                        help="not ported yet")
    args = ap.parse_args(argv)
    refused = [f for f in NOT_PORTED if getattr(args, f[2:].replace("-", "_")) is not None]
    if refused:
        ap.error(f"not ported yet: {', '.join(refused)} (the port trains without "
                 f"plans, checkpoints or telemetry so far)")
    try:
        ndata, tp = (int(n) for n in args.mesh.lower().split("x"))
    except ValueError:
        ap.error(f"--mesh {args.mesh}: expected DxM, for example 2x2")
    cfg = configs.get_config(args.arch, smoke=args.smoke)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    spec = None
    if args.stages > 1:
        if args.schedule not in KNOWN_SCHEDULES:
            ap.error(f"--schedule {args.schedule!r} is not executable; the tick-table "
                     f"executor runs: {', '.join(EXECUTABLE_SCHEDULES)} (aliases: naive = "
                     f"gpipe)")
        if cfg.num_layers % args.stages:
            ap.error(f"--stages {args.stages} does not divide num_layers={cfg.num_layers}")
        try:
            spec = PipeSpec(n_stages=args.stages,
                            layers_per_stage=cfg.num_layers // args.stages,
                            n_microbatches=args.microbatches, schedule=args.schedule,
                            split_backward=args.split_backward)
        except AssertionError as e:
            ap.error(f"infeasible pipeline shape for schedule {args.schedule!r}: {e}")
    n = args.stages * ndata * tp
    what = (f"{args.stages} stages of --mesh {args.mesh} need" if args.stages > 1
            else f"--mesh {args.mesh} needs")
    if dist.under_launcher():
        world = int(os.environ["WORLD_SIZE"])
        if world != n:
            ap.error(f"{what} {n} processes, the launcher started {world} "
                     f"(--nproc_per_node {n})")
    elif n != 1:
        ap.error(f"{what} {n} processes: run it under python -m torch.distributed.run "
                 f"--nproc_per_node {n}")

    device = resolve_device(args.device)
    axis = dist.LOCAL
    if dist.under_launcher():
        axis = dist.from_env(ndata, tp, device, nstage=args.stages)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    try:
        return _train(args, cfg, spec, device, axis)
    finally:
        if axis is not dist.LOCAL:
            torch.distributed.destroy_process_group()


def _train(args, cfg, spec: PipeSpec | None, device: torch.device,
           axis: dist.AxisCtx) -> dict:
    rank0 = axis.data_index == 0 and axis.model_index == 0 and axis.stage_index == 0
    partitioned = not args.no_partition
    opt_cfg = AdamConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                         decay_steps=args.steps)
    if spec is not None:
        step = stepfn.build_pipeline_train_step(cfg, spec, opt_cfg, partitioned=partitioned,
                                                axis=axis)
        storage = stepfn.init_pipeline_storage(cfg, args.seed, spec, partitioned=partitioned,
                                               device=device, axis=axis)
    else:
        acc = AccumConfig(method=args.method, partitioned=partitioned,
                          n_microbatches=args.microbatches)
        step = stepfn.build_train_step(cfg, acc, opt_cfg, axis=axis)
        storage = stepfn.init_storage(cfg, args.seed, partitioned=partitioned, device=device,
                                      axis=axis)
    opt = adam_init(storage, moment_dtype=opt_cfg.moment_dtype)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.global_batch, n_microbatches=args.microbatches,
                      seed=args.seed)
    tokens_per_step = args.global_batch * args.seq_len

    history, records = [], []
    t_start = time.time()
    for i in range(args.steps):
        batch = batch_for(cfg, data, i, axis)
        axis.reset_counts()
        t0 = time.perf_counter()
        storage, opt, metrics = step(storage, opt, batch)
        loss = float(metrics["loss"])          # device sync: ends the step
        dt = time.perf_counter() - t0
        tok_s = tokens_per_step / dt
        rec = {"step": i, "loss": loss, "lr": float(metrics["lr"]),
               "grad_norm": float(metrics["grad_norm"]), "step_time_s": dt,
               "tokens_per_s": tok_s,
               # per card: the grid's S*D*M cards share the step's flops
               "mfu": obs_metrics.mfu_estimate(cfg, global_batch=args.global_batch,
                                               seq_len=args.seq_len, step_time_s=dt)
                      / (axis.nstage * axis.ndata * axis.tp),
               "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                               if device.type == "cuda" else None),
               # this rank's collectives of the step: "group op" -> [calls, bytes]
               "collectives": {f"{g} {op}": list(c) for (g, op), c in axis.counts.items()}}
        records.append(rec)
        history.append(loss)
        if rank0 and i % args.log_every == 0:
            print(f"step {i:5d}  loss {loss:8.4f}"
                  f"  lr {rec['lr']:.2e}"
                  f"  gnorm {rec['grad_norm']:7.3f}"
                  f"  {tok_s:9.0f} tok/s"
                  f"  {time.time()-t_start:6.1f}s", flush=True)
    result = {"arch": args.arch, "mesh": args.mesh, "stages": args.stages,
              "schedule": args.schedule if spec is not None else None,
              "first_loss": history[0],
              "last_loss": history[-1], "steps": len(history),
              "seconds": round(time.time() - t_start, 1)}
    if rank0:
        print(json.dumps(result), flush=True)
    return dict(result, records=records, device=str(device))


if __name__ == "__main__":
    main()
