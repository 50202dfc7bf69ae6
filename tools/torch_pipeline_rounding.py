#!/usr/bin/env python3
"""Where a pipelined trajectory leaves the layered one.  Trajectories of
the port's trainer at one stage from the same seeded weights and batches,
each printed step by step (loss, grad norm):

  layered    ``stepfn.build_train_step``, layered and partitioned
  pipelined  ``stepfn.build_pipeline_train_step``, modular, partitioned
  and three layered ones whose step 0 takes one part from the pipelined
  step (its later steps are layered):
  gradient   the pipeline's gradient (``grad_fn`` on the same weights)
  norm       the clip scale from the pipeline's global norm (its
             ``sq_reduce``) of the layered gradient
  update     the pipeline's AdamW routes (its ``fused``: the tree-map
             update on the outer leaves, K6 on the layer chunks)

The part whose trajectory moves from ``layered`` as far as ``pipelined``
does is where the gap starts.  One process, a group of one (NCCL on the
card, gloo on the CPU).

    python tools/torch_pipeline_rounding.py --arch zamba2-7b --layers 12
    python tools/torch_pipeline_rounding.py --arch zamba2-7b --layers 12 \\
        --smoke --device cpu --seq-len 64
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib
import socket
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--smoke", action="store_true", help="the arch's smoke widths")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    import torch.distributed as tdist

    from repro_torch import configs, tree
    from repro_torch.core import dist, stepfn
    from repro_torch.core.accumulation import AccumConfig
    from repro_torch.core.schedules import PipeSpec
    from repro_torch.data.synthetic import DataConfig, batch_for
    from repro_torch.optim.adam import AdamConfig, adam_init, adam_update, global_norm

    cfg = configs.get_config(args.arch, smoke=args.smoke)
    over = {"num_layers": args.layers}
    if cfg.is_moe:
        over["router_aux_weight"] = 0.0          # the pipeline drops the aux loss
    cfg = dataclasses.replace(cfg, **over)
    M = args.microbatches
    data = DataConfig(cfg.vocab_size, args.seq_len, args.global_batch, M, seed=args.seed)
    opt_cfg = AdamConfig(lr=args.lr, warmup_steps=1, decay_steps=args.steps)
    spec = PipeSpec(n_stages=1, layers_per_stage=cfg.num_layers, n_microbatches=M)
    device = torch.device(args.device)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    axis = dist.from_env(1, 1, device, nstage=1)
    try:
        layered = stepfn.build_train_step(cfg, AccumConfig("layered", True, M), opt_cfg,
                                          axis=axis)
        piped = stepfn.build_pipeline_train_step(cfg, spec, opt_cfg, partitioned=True,
                                                 axis=axis)

        pst = stepfn.init_pipeline_storage(cfg, args.seed, spec, partitioned=True,
                                           device=device, axis=axis)
        shapes = {k: t.shape for k, t in tree.leaves_with_path(pst)}
        b0 = {k: v.to(device) for k, v in batch_for(cfg, data, 0, axis).items()}
        g0, _ = piped.grad_fn(pst, b0)
        first = dict(tree.leaves_with_path(g0))
        del pst, g0

        def pview(t: dict) -> dict:
            """A layered-layout tree read in the pipeline's layout."""
            return tree.tree_map_with_path(lambda k, x: x.view(shapes[k]), t)

        def run(label, step, storage, part=None):
            opt = adam_init(storage)
            out = []
            for i in range(args.steps):
                batch = batch_for(cfg, data, i, axis)
                if i == 0 and part is not None:
                    grads, m = step.grad_fn(storage,
                                            {k: v.to(device) for k, v in batch.items()})
                    if part == "gradient":
                        grads = tree.tree_map_with_path(
                            lambda k, g: first[k].reshape(g.shape), grads)
                    gn, gs = (global_norm(opt_cfg, pview(grads), sq_reduce=piped.sq_reduce)
                              if part == "norm" else
                              global_norm(opt_cfg, grads, sq_reduce=step.sq_reduce))
                    if part == "update":
                        adam_update(opt_cfg, pview(storage),
                                    dict({k: pview(opt[k]) for k in ("mu", "nu")},
                                         step=opt["step"]),
                                    pview(grads), gs, fused=piped.fused)
                        opt = dict(opt, step=opt["step"] + 1)
                    else:
                        storage, opt, _ = adam_update(opt_cfg, storage, opt, grads, gs,
                                                      fused=step.fused)
                    m = dict(m, grad_norm=gn)
                else:
                    storage, opt, m = step(storage, opt, batch)
                out.append((m["loss"].item(), m["grad_norm"].item()))
            print(f"{label}: " + ", ".join(f"step {i} loss {lo:.6f} grad norm {g:.6f}"
                                           for i, (lo, g) in enumerate(out)), flush=True)
            return out

        def init():
            return stepfn.init_storage(cfg, args.seed, partitioned=True, device=device,
                                       axis=axis)

        runs = {"layered": run("layered", layered, init()),
                "pipelined": run("pipelined", piped, stepfn.init_pipeline_storage(
                    cfg, args.seed, spec, partitioned=True, device=device, axis=axis))}
        for part in ("gradient", "norm", "update"):
            runs[part] = run(part, layered, init(), part)
    finally:
        tdist.destroy_process_group()

    def rel(a, b):
        return abs(a - b) / abs(b)

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        smi = f"no nvidia-smi ({device})"
    base = runs.pop("layered")
    for i in range(args.steps):
        print(f"step {i} grad norm against layered: " + ", ".join(
            f"{label} {rel(r[i][1], base[i][1]):.2e}" for label, r in runs.items()), flush=True)
    print(f"{args.arch} at {cfg.num_layers} layers, width {cfg.d_model}, on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
