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

The run-time services are the JAX trainer's, reading and writing the same
files: ``--checkpoint-dir`` with ``--checkpoint-every N`` saves a params +
Adam-moments bundle every N steps (``checkpointing/store.py``'s format, the
global arrays of the layout, assembled on rank 0), ``--keep-checkpoints``
keeps the newest valid ones, ``--resume`` (``latest``) restores the newest
valid checkpoint once and trains ``--steps`` more; ``--faults PLAN.json``
or ``--resume auto`` hand the run to the supervisor
(``resilience/supervisor.py``: auto-resume after crashes, the anomaly gate,
the failure-shrink of a ``lose_replica`` fault, after which the leaving
ranks' processes end and the survivors train on), where ``--steps`` is the
total target.  ``--metrics`` streams JSONL records,
``--trace`` writes a Chrome trace: each train step, and inside it the
accumulation schedule's phases (``accum.gather``, ``accum.forward``,
``accum.head``, ``accum.backward``, ``accum.add``, ``accum.reduce``,
``accum.embed_grad``, ``core/accumulation.py``) and the optimizer's
``step.update``, each also timed on the card on its own lane; with
``--stages > 1`` both ``--trace``
and ``--drift-report`` add a profiled grad-only pass on batch 0 after
training: the measured tick timeline, and its drift against the table's.
The ranks share one filesystem: rank 0 writes, every rank reads.

``--plan PLAN.json`` (from either package's ``launch.plan``) fills every
flag the command line leaves out from the plan's execution section (arch,
smoke, layers, mesh, method, partition, micro-batches, batch, length, steps,
stages, schedule, split); flags given win.  A pipelined plan's embedded
tick table is the one the executor runs: it must name the resolved
schedule, stage count and micro-batch count, and be executable.

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
  PYTHONPATH=src python -m repro_torch.launch.plan --arch yi-6b --layers 8 \\
      --global-batch 8 --seq-len 2048 --microbatches 1,2,4,8 --out plan.json
  PYTHONPATH=src python -m repro_torch.launch.train --plan plan.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch
import torch.distributed

from repro_torch import configs
from repro_torch.checkpointing import store
from repro_torch.core import dist, stepfn
from repro_torch.core import pipeline as pp
from repro_torch.core.accumulation import AccumConfig
from repro_torch.core.schedules import KNOWN_SCHEDULES, PipeSpec
from repro_torch.data.synthetic import DataConfig, batch_for
from repro_torch.device import resolve_device
from repro_torch.obs import drift as obs_drift
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.optim.adam import AdamConfig, adam_init
from repro_torch.planner import plan as planlib
from repro_torch.planner import simulator as simlib
from repro_torch.resilience import faults as flt
from repro_torch.resilience import reshard
from repro_torch.resilience.supervisor import Supervisor, SupervisorConfig


def apply_plan(args, argv) -> None:
    """Fill ``args`` from a plan's execution section (``launch.plan``'s
    output, either package's): plan values replace the defaults, and flags
    given in ``argv`` keep their value."""
    ex = planlib.execution_of(planlib.load_plan(args.plan))
    passed = {a.split("=")[0] for a in argv if a.startswith("--")}

    def take(flag: str, attr: str, key: str):
        if key in ex and flag not in passed:
            setattr(args, attr, ex[key])

    take("--arch", "arch", "arch")
    take("--smoke", "smoke", "smoke")
    take("--layers", "layers", "layers")
    take("--mesh", "mesh", "mesh")
    take("--method", "method", "method")
    take("--microbatches", "microbatches", "microbatches")
    take("--global-batch", "global_batch", "global_batch")
    take("--seq-len", "seq_len", "seq_len")
    take("--steps", "steps", "steps")
    take("--stages", "stages", "stages")
    take("--schedule", "schedule", "schedule")
    take("--split-backward", "split_backward", "split_backward")
    if "partitioned" in ex and "--no-partition" not in passed:
        args.no_partition = not ex["partitioned"]
    # a pipelined plan embeds the tick table it scored: the executor runs it
    args.plan_tick_table = ex.get("tick_table")
    args.plan_execution = ex


def execution(args, table) -> dict:
    """The resolved run as a plan's execution section (``table``: the tick
    table a pipelined run executes)."""
    ex = {"arch": args.arch, "smoke": args.smoke, "mesh": args.mesh, "method": args.method,
          "partitioned": not args.no_partition, "microbatches": args.microbatches,
          "global_batch": args.global_batch, "seq_len": args.seq_len, "steps": args.steps}
    if args.layers:
        ex["layers"] = args.layers
    if table is not None:
        ex.update(stages=args.stages, schedule=args.schedule,
                  split_backward=table.is_split, tick_table=table.to_json())
    return ex


def main(argv=None, *, keep_state: bool = False) -> dict:
    """The training run.  Returns the result line's keys, the per-step
    records and the device; with ``keep_state`` (callers in Python) also
    ``state``, this rank's final storage and optimizer state."""
    # allow_abbrev=False: apply_plan finds the flags given by their full spelling
    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--plan", default=None,
                    help="JSON plan from launch.plan (either package's); its execution "
                         "section fills the flags not given")
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
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", nargs="?", const="latest", default=None,
                    choices=["latest", "auto"],
                    help="latest: restore the newest valid checkpoint once and continue; "
                         "auto: run under the supervisor, which auto-resumes after crashes "
                         "(bounded retries, checksum fallback)")
    ap.add_argument("--faults", default=None,
                    help="JSON fault plan (resilience/faults.py) to inject "
                         "deterministically; implies the supervised loop and requires "
                         "--checkpoint-dir")
    ap.add_argument("--keep-checkpoints", type=int, default=3,
                    help="garbage-collect all but the newest N valid checkpoints after "
                         "each save")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--metrics", default=None,
                    help="stream per-step metrics (loss, step time, tokens/s, MFU) to this "
                         "JSONL file, flushed per record")
    ap.add_argument("--trace", default=None,
                    help="write a Chrome-trace JSON of the run's phases here: the train "
                         "steps and, inside each, the accumulation schedule's accum.gather, "
                         "accum.forward, accum.head, accum.backward, accum.add, "
                         "accum.reduce, accum.embed_grad and the optimizer's step.update, "
                         "host and device lanes; with --stages > 1 it also holds the "
                         "measured and the planned tick timelines")
    ap.add_argument("--drift-report", default=None,
                    help="with --stages > 1: profile one grad-only pass tick by tick and "
                         "write the measured-vs-planned tick drift report (obs/drift.py) "
                         "to this JSON file")
    args = ap.parse_args(argv)
    args.plan_tick_table = args.plan_execution = None
    if args.plan:
        apply_plan(args, argv if argv is not None else sys.argv[1:])
    if not args.arch:
        ap.error("--arch required (directly or through --plan)")
    if (args.faults or args.resume == "auto") and not args.checkpoint_dir:
        ap.error("--faults / --resume auto require --checkpoint-dir")
    try:
        ndata, tp = (int(n) for n in args.mesh.lower().split("x"))
    except ValueError:
        ap.error(f"--mesh {args.mesh}: expected DxM, for example 2x2")
    cfg = configs.get_config(args.arch, smoke=args.smoke)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    spec = table = None
    if args.stages > 1:
        if args.schedule not in KNOWN_SCHEDULES:
            ap.error(f"--schedule {args.schedule!r} is not executable; the tick-table "
                     f"executor runs: {', '.join(simlib.EXECUTABLE_SCHEDULES)} (aliases: "
                     f"naive = gpipe)")
        if cfg.num_layers % args.stages:
            ap.error(f"--stages {args.stages} does not divide num_layers={cfg.num_layers}")
        try:
            spec = PipeSpec(n_stages=args.stages,
                            layers_per_stage=cfg.num_layers // args.stages,
                            n_microbatches=args.microbatches, schedule=args.schedule,
                            split_backward=args.split_backward)
        except AssertionError as e:
            ap.error(f"infeasible pipeline shape for schedule {args.schedule!r}: {e}")
        if args.plan_tick_table is not None:
            table = simlib.TickTable.from_json(args.plan_tick_table)
            if (table.schedule, table.n_stages, table.n_microbatches) != \
                    (spec.schedule, spec.n_stages, spec.n_microbatches):
                ap.error(
                    f"plan tick table ({table.schedule}, S={table.n_stages}, "
                    f"M={table.n_microbatches}) does not match the resolved "
                    f"execution (schedule={spec.schedule}, S={spec.n_stages}, "
                    f"M={spec.n_microbatches})")
            if table.is_split != spec.split_backward:
                # a plan whose split flag disagrees with its table: the table
                # is the contract, follow it
                spec = dataclasses.replace(spec, split_backward=table.is_split)
            try:
                table.validate_executable()
            except (NotImplementedError, ValueError) as e:
                ap.error(f"plan tick table is not executable: {e}")
        else:
            table = spec.tick_table()
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
        if args.faults or args.resume == "auto":
            return _run_supervised(args, cfg, device, axis, keep_state)
        return _train(args, cfg, spec, table, device, axis, keep_state)
    finally:
        if axis is not dist.LOCAL:
            torch.distributed.destroy_process_group()


def _is_rank0(axis: dist.AxisCtx) -> bool:
    return axis.data_index == 0 and axis.model_index == 0 and axis.stage_index == 0


def _opt_cfg(args) -> AdamConfig:
    return AdamConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1), decay_steps=args.steps)


def _data_cfg(args, cfg) -> DataConfig:
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.global_batch, n_microbatches=args.microbatches,
                      seed=args.seed)


def _layout(args, axis: dist.AxisCtx) -> reshard.MeshLayout:
    return reshard.layout_of(axis, partitioned=not args.no_partition, schedule=args.schedule,
                             n_microbatches=args.microbatches)


def _run_supervised(args, cfg, device: torch.device, axis: dist.AxisCtx,
                    keep_state: bool = False) -> dict:
    """Run under the supervisor (``--faults`` / ``--resume auto``).  ``--steps``
    is the *total* completed-step target: a killed-and-resumed run finishes
    at the same step as an unkilled one."""
    rank0 = _is_rank0(axis)
    fault_plan = flt.FaultPlan.load(args.faults) if args.faults else None
    sup = SupervisorConfig(checkpoint_every=args.checkpoint_every or 1,
                           keep_checkpoints=args.keep_checkpoints, seed=args.seed)
    sink = obs_metrics.MetricsSink(
        args.metrics if rank0 else None,
        meta={"arch": args.arch, "smoke": args.smoke, "mesh": args.mesh,
              "stages": args.stages, "supervised": True,
              "global_batch": args.global_batch, "seq_len": args.seq_len,
              "partitioned": not args.no_partition,
              "faults": fault_plan.to_json()["faults"] if fault_plan else []})
    tracer = obs_trace.Tracer() if args.trace and rank0 else None
    sv = Supervisor(cfg, _opt_cfg(args), _data_cfg(args, cfg), _layout(args, axis),
                    ckpt_root=args.checkpoint_dir, method=args.method, sup=sup,
                    fault_plan=fault_plan, sink=sink, tracer=tracer, axis=axis, device=device,
                    plan_execution=args.plan_execution)
    result: dict = {}
    try:
        result = sv.run(args.steps)
        result.update(arch=args.arch, skipped_state=sv.skipped, checkpoint_io=sv.io)
        if rank0:
            print(json.dumps(result), flush=True)
        return dict(result, state={"storage": sv.storage, "opt": sv.opt}) if keep_state \
            else result
    finally:
        if tracer is not None:
            tracer.save(args.trace)
        sink.close(extra={k: v for k, v in result.items()
                          if not isinstance(v, (list, dict))} or None)


def _resume_latest(args, cfg, layout, axis, storage: dict, opt: dict) -> int:
    """``--resume latest``: the newest valid checkpoint bundle into this
    rank's tensors, else a params-only checkpoint at the directory's root
    (moments restart from zero); its step."""
    root = args.checkpoint_dir
    step = reshard.restore_bundle(root, {"params": storage, "mu": opt["mu"], "nu": opt["nu"],
                                         "opt_step": opt["step"]}, cfg, layout, axis,
                                  moment_dtype=_opt_cfg(args).moment_dtype)
    if step is not None:
        return step
    manifest = store.load_manifest(root)       # CheckpointError when there is none
    saved = reshard.saved_layout(manifest, layout)
    reshard.load_blocks(root, manifest, reshard.storage_template(cfg, saved), storage, cfg,
                        saved, layout, axis)
    return manifest["step"]


def _train(args, cfg, spec: PipeSpec | None, table, device: torch.device,
           axis: dist.AxisCtx, keep_state: bool = False) -> dict:
    rank0 = _is_rank0(axis)
    partitioned = not args.no_partition
    opt_cfg = _opt_cfg(args)
    n_devices = axis.nstage * axis.ndata * axis.tp
    sink = obs_metrics.MetricsSink(
        args.metrics if rank0 else None,
        meta={"arch": args.arch, "smoke": args.smoke, "mesh": args.mesh,
              "stages": args.stages, "schedule": args.schedule if spec is not None else None,
              "global_batch": args.global_batch, "seq_len": args.seq_len,
              "n_devices": n_devices, "partitioned": partitioned})
    tracer = obs_trace.Tracer() if args.trace and rank0 else None
    result: dict = {}
    with obs_trace.active(tracer):
        try:
            if spec is not None:
                with obs_trace.span("build_step"):
                    step = stepfn.build_pipeline_train_step(cfg, spec, opt_cfg,
                                                            partitioned=partitioned, axis=axis,
                                                            table=table)
                with obs_trace.span("init_storage"):
                    storage = stepfn.init_pipeline_storage(cfg, args.seed, spec,
                                                           partitioned=partitioned, device=device,
                                                           axis=axis)
            else:
                acc = AccumConfig(method=args.method, partitioned=partitioned,
                                  n_microbatches=args.microbatches)
                with obs_trace.span("build_step"):
                    step = stepfn.build_train_step(cfg, acc, opt_cfg, axis=axis)
                with obs_trace.span("init_storage"):
                    storage = stepfn.init_storage(cfg, args.seed, partitioned=partitioned,
                                                  device=device, axis=axis)
            opt = adam_init(storage, moment_dtype=opt_cfg.moment_dtype)
            layout = _layout(args, axis)
            start = 0
            if args.resume and args.checkpoint_dir:
                start = _resume_latest(args, cfg, layout, axis, storage, opt)
                if rank0:
                    print(f"resumed from step {start}", flush=True)
            data = _data_cfg(args, cfg)
            tokens_per_step = args.global_batch * args.seq_len

            history, records = [], []
            t_start = time.time()
            for i in range(start, start + args.steps):
                batch = batch_for(cfg, data, i, axis)
                axis.reset_counts()
                t0 = time.perf_counter()
                with obs_trace.span("train step", cat="step", step=i):
                    storage, opt, metrics = step(storage, opt, batch)
                    loss = float(metrics["loss"])          # device sync: ends the step
                dt = time.perf_counter() - t0
                tok_s = tokens_per_step / dt
                rec = {"step": i, "loss": loss, "lr": float(metrics["lr"]),
                       "grad_norm": float(metrics["grad_norm"]), "step_time_s": dt,
                       "tokens_per_s": tok_s,
                       # per card: the grid's S*D*M cards share the step's flops
                       "mfu": obs_metrics.mfu_estimate(cfg, global_batch=args.global_batch,
                                                       seq_len=args.seq_len, step_time_s=dt,
                                                       n_devices=n_devices)}
                sink.log(rec)
                rec.update(peak_mem_gb=(torch.cuda.max_memory_allocated(device) / 1e9
                                        if device.type == "cuda" else None),
                           aux=float(metrics.get("aux", 0.0)),   # the router's load balance
                           # this rank's collectives of the step: "group op" -> [calls, bytes]
                           collectives={f"{g} {op}": list(c) for (g, op), c in axis.counts.items()})
                records.append(rec)
                history.append(loss)
                if rank0 and i % args.log_every == 0:
                    print(f"step {i:5d}  loss {loss:8.4f}"
                          f"  lr {rec['lr']:.2e}"
                          f"  gnorm {rec['grad_norm']:7.3f}"
                          f"  {tok_s:9.0f} tok/s"
                          f"  {time.time()-t_start:6.1f}s", flush=True)
                if (args.checkpoint_every and args.checkpoint_dir
                        and (i + 1) % args.checkpoint_every == 0):
                    reshard.save_bundle(
                        args.checkpoint_dir, {"params": storage, "mu": opt["mu"], "nu": opt["nu"],
                                              "opt_step": opt["step"]}, cfg, layout, axis,
                        step=i + 1, meta={"arch": args.arch, "loss": loss,
                                          "layout": layout.to_meta(),
                                          "moment_dtype": opt_cfg.moment_dtype},
                        keep=args.keep_checkpoints)

            # ---- the tick profiler: measured tick timeline + drift ----
            if spec is not None and (args.trace or args.drift_report):
                with obs_trace.span("tick profiling"):
                    events = profile_ticks(cfg, spec, partitioned, axis, storage, data, device,
                                            tracer, table)
                predicted = table.timeline()
                if tracer is not None and events:
                    # the table's unit ticks at the measured mean tick length, so the
                    # lanes align side by side
                    mk = max(e[5] for e in events)
                    obs_trace.add_timeline(tracer, predicted, pid=2, name="planned ticks",
                                           scale_us=mk * 1e6 / max(table.n_ticks, 1))
                if args.drift_report and rank0:
                    rep = obs_drift.drift_report(events, predicted)
                    obs_drift.save_report(rep, args.drift_report)
                    print(obs_drift.format_report(rep), flush=True)
                    sink.log(event="drift", record={"max_abs_drift": rep["max_abs_drift"],
                                                    "matched": rep["overall"]["matched"],
                                                    "missing": rep["overall"]["missing"],
                                                    "extra": rep["overall"]["extra"]})
                    result["max_abs_drift"] = rep["max_abs_drift"]

            result.update({"arch": args.arch, "mesh": args.mesh, "stages": args.stages,
                           "schedule": args.schedule if spec is not None else None,
                           "first_loss": history[0], "last_loss": history[-1],
                           "steps": len(history), "seconds": round(time.time() - t_start, 1)})
            if rank0:
                print(json.dumps(result), flush=True)
            out = dict(result, records=records, device=str(device),
                       execution=execution(args, table))
            return dict(out, state={"storage": storage, "opt": opt}) if keep_state else out
        finally:
            if tracer is not None:
                tracer.save(args.trace)
            sink.close(extra=result or None)


def profile_ticks(cfg, spec: PipeSpec, partitioned: bool, axis: dist.AxisCtx, storage: dict,
                  data: DataConfig, device: torch.device, tracer, table=None) -> list:
    """One warm-up and one timed grad-only pass on batch 0 through the
    executor (``table``, else the spec's) with a tick recorder; the
    gradients are discarded."""
    rec = obs_trace.TickRecorder(axis.stage_index, device)
    grad_fn = pp.make_pipeline_grad_fn(cfg, spec, stepfn.full_template(cfg),
                                       partitioned=partitioned, axis=axis, recorder=rec,
                                       table=table)
    batch = {k: v.to(device) for k, v in batch_for(cfg, data, 0, axis).items()}
    return obs_trace.measure_tick_timeline(grad_fn, rec, storage, batch, axis=axis,
                                           warmup=1, tracer=tracer, pid=1)


if __name__ == "__main__":
    main()
