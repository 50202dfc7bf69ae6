"""The dry run: one rank's roofline costs and peak memory of a production
step, without the cards (counterpart of ``repro/launch/dryrun.py``).

The JAX package lowers each (arch x workload shape x mesh) step on 512
virtual CPU devices and walks its jaxpr.  The port runs the step of rank 0
of the production grid (``core/dist.py:production_grid``: 16 x 16 ranks,
2 x 16 x 16 under ``--multi-pod``) on ``meta`` tensors over a fake process
group, under ``core/roofline.py:analyze``: nothing is allocated and no
collective is issued, but every collective is counted and every op seen.
The figures are per H100 rank (``roofline``'s constants); ``memory`` is the
tracker's (argument, temp, output and device bytes), the counterpart of
``compiled.memory_analysis()``.  There is no counterpart of
``xla_cost_analysis``: the port compiles nothing.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k \\
      --multi-pod --save out/
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out out/

Inputs, state and weights are built from shapes (this rank's ZeRO chunks,
bf16 moments, ``[M, B/(M*dp), S]`` rows), never drawn.  ``--all`` runs
every combination in a subprocess of its own and skips reports that exist.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

import repro_torch
from repro_torch import configs, tree
from repro_torch.core import dist as D
from repro_torch.core import partition as zp
from repro_torch.core import roofline, stepfn
from repro_torch.core.accumulation import AccumConfig
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adam import AdamConfig

SHAPES = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode_long", "seq": 524288, "batch": 1},
}

# long_500k needs sub-quadratic attention: run for SSM/hybrid and the
# sliding-window dense arch; skip pure full-attention archs (DESIGN.md §4).
LONG_OK = {"rwkv6-3b", "zamba2-7b", "gemma2-9b"}

META = torch.device("meta")


def arch_shape_supported(arch: str, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and arch not in LONG_OK:
        return False, "pure full-attention arch: no sub-quadratic variant (see DESIGN.md)"
    return True, ""


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# Inputs, weights, state
# ---------------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: str, axis: D.AxisCtx, *, n_microbatches: int):
    """This rank's ``meta`` inputs of the workload shape: a training batch's
    rows ``[M, B/(M*dp), S]``, a prefill batch's ``[B/dp, S]`` (its labels
    and mask too, as the JAX package's inputs hold them), a decode step's
    tokens ``[B/dp]`` (every row under ``decode_long``'s sequence-sharded
    cache); the ``embeddings`` and ``vlm`` input modes' keys as
    ``data/synthetic.py`` makes them, embeddings in ``cfg.dtype``."""
    info = SHAPES[shape]
    S, B = info["seq"], info["batch"]
    i32, f = torch.int32, cfg.torch_dtype
    if info["kind"] in ("decode", "decode_long"):
        rows = B if info["kind"] == "decode_long" else B // axis.dp
        return _empty((rows,), i32)
    lead = ((n_microbatches, B // n_microbatches // axis.dp) if info["kind"] == "train"
            else (B // axis.dp,))
    shapes = {"labels": ((*lead, S), i32), "mask": ((*lead, S), i32)}
    if cfg.input_mode == "embeddings":
        shapes["embeds"] = ((*lead, S, cfg.d_model), f)
    elif cfg.input_mode == "vlm":
        P_ = cfg.vision_prefix_len
        shapes["tokens"] = ((*lead, S - P_), i32)
        shapes["vision_embeds"] = ((*lead, P_, cfg.d_model), f)
    else:
        shapes["tokens"] = ((*lead, S), i32)
    return {k: _empty(*v) for k, v in shapes.items()}


def params_specs(cfg: ModelConfig, axis: D.AxisCtx) -> dict:
    """The serving weights of this rank, ``meta`` in ``cfg.dtype``: its
    block of every leaf by ``transformer.serve_param_specs`` (MoE experts
    over the data group, hidden dims over the model group), the layers a
    list, as ``transformer.init_params`` gives them."""
    dt = cfg.torch_dtype
    shapes = tree.tree_map(lambda shp, sp: zp.local_shape(shp, sp, axis.tp, axis.ndata),
                           stepfn.full_template(cfg), T.serve_param_specs(cfg, axis.tp))
    params = {k: tree.tree_map(lambda s: _empty(s, dt), v) for k, v in shapes.items()}
    params["layers"] = [tree.tree_map(lambda s: _empty(s[1:], dt), shapes["layers"])
                        for _ in range(cfg.num_layers)]
    return params


def storage_specs(cfg: ModelConfig, axis: D.AxisCtx, partitioned: bool, *,
                  span_pods: bool = False, expert_resident: bool = False) -> dict:
    """This rank's fp32 training storage on ``meta``: its ZeRO chunks
    (over pod x data under ``span_pods`` on a grid with pods; the expert
    stacks resident under ``expert_resident``), or its model shards whole."""
    full = tree.tree_map(lambda s: _empty(s, torch.float32), stepfn.full_template(cfg))
    st = stepfn.storage_from_params(cfg, full, partitioned=partitioned, axis=axis,
                                    expert_resident=expert_resident and cfg.is_moe,
                                    span_pods=span_pods)
    return tree.tree_map(lambda t: _empty(t.shape, t.dtype), st)


def cache_specs(cfg: ModelConfig, axis: D.AxisCtx, batch: int, max_seq: int, *,
                seq_shard: bool) -> dict:
    """This rank's dense cache on ``meta``: ``transformer.init_cache`` over
    the serving axis (``stepfn.serve_axis``): its rows, or every row with
    the sequence split over the data group under ``seq_shard``."""
    rows = batch if seq_shard else batch // axis.dp
    return T.init_cache(cfg, rows, max_seq, stepfn.serve_axis(cfg, axis, seq_shard=seq_shard),
                        device=META)


# ---------------------------------------------------------------------------
# One (arch x shape x grid) dry run
# ---------------------------------------------------------------------------
def build(cfg: ModelConfig, shape: str, axis: D.AxisCtx, *, method: str = "layered",
          partitioned: bool = True, span_pods: bool = False, expert_parallel: bool = False,
          reduce_dtype: str = "float32", fused: bool = False):
    """(step, its ``meta`` arguments) of rank ``axis`` for the workload
    shape, as the JAX package's ``run_one`` builds them: training at the
    paper-optimal micro-batch of one sequence a data rank (``M = batch //
    dp``), bf16 moments, no clipping in the fused step."""
    info = SHAPES[shape]
    kind = info["kind"]
    if kind == "train":
        M = max(info["batch"] // axis.dp, 1)
        acc = AccumConfig(method=method, partitioned=partitioned, n_microbatches=M,
                          span_pods=span_pods, expert_parallel=expert_parallel,
                          reduce_dtype=reduce_dtype)
        opt_cfg = AdamConfig(moment_dtype="bfloat16", grad_clip=0 if fused else 1.0)
        make_step = stepfn.build_fused_train_step if fused else stepfn.build_train_step
        step = make_step(cfg, acc, opt_cfg, axis=axis)
        storage = storage_specs(cfg, axis, partitioned, span_pods=span_pods,
                                expert_resident=expert_parallel)
        opt = {m: tree.tree_map(lambda t: _empty(t.shape, torch.bfloat16), storage)
               for m in ("mu", "nu")}
        opt["step"] = _empty((), torch.int32)
        return step, (storage, opt, input_specs(cfg, shape, axis, n_microbatches=M))
    params = params_specs(cfg, axis)
    if kind == "prefill":
        cache = cache_specs(cfg, axis, info["batch"], info["seq"], seq_shard=False)
        return (stepfn.build_prefill_step(cfg, axis=axis),
                (params, cache, input_specs(cfg, shape, axis, n_microbatches=1)))
    seq_shard = kind == "decode_long"
    cache = cache_specs(cfg, axis, info["batch"], info["seq"], seq_shard=seq_shard)
    return (stepfn.build_serve_step(cfg, axis=axis, seq_shard=seq_shard),
            (params, cache, input_specs(cfg, shape, axis, n_microbatches=1)))


def trace(cfg: ModelConfig, shape: str, axis: D.AxisCtx, **kw) -> roofline.Costs:
    """``roofline.analyze`` of ``build``'s step: the JAX model's path at
    the shape's length decides which kernels' work is counted
    (``roofline.attention_seen``)."""
    step, args = build(cfg, shape, axis, **kw)
    return roofline.analyze(step, *args, axis=axis,
                            see=roofline.attention_seen(cfg, SHAPES[shape]["seq"]))


def run_one(arch: str, shape: str, *, multi_pod: bool, method: str = "layered",
            partitioned: bool = True, save: str | None = None,
            mesh_shape: str | None = None, expert_parallel: bool = False,
            reduce_dtype: str = "float32", tag_extra: str = "",
            fused: bool = False) -> dict:
    info = SHAPES[shape]
    kind = info["kind"]
    ok, why = arch_shape_supported(arch, shape)
    if not ok:
        return _emit({"arch": arch, "shape": shape, "multi_pod": multi_pod,
                      "status": "skipped", "reason": why}, save, kind, method, tag_extra)
    t0 = time.time()
    with D.production_grid(multi_pod=multi_pod, mesh_shape=mesh_shape) as axis:
        cfg = configs.get_config(arch).padded_for_tp(axis.tp)
        costs = trace(cfg, shape, axis, method=method, partitioned=partitioned,
                      span_pods=multi_pod, expert_parallel=expert_parallel,
                      reduce_dtype=reduce_dtype, fused=fused)
        n_chips = axis.dp * axis.tp
    if kind == "train":
        mf = roofline.model_flops_train(cfg, info["batch"], info["seq"])
    elif kind == "prefill":
        mf = roofline.model_flops_train(cfg, info["batch"], info["seq"]) / 3.0
    else:
        mf = roofline.model_flops_decode(cfg, info["batch"])
    report = {
        "arch": arch, "shape": shape, "multi_pod": multi_pod,
        "method": method if kind == "train" else "n/a",
        "partitioned": partitioned if kind == "train" else False,
        "status": "ok",
        "n_chips": n_chips,
        "seconds": round(time.time() - t0, 1),
        "memory": costs.memory,
        "roofline": costs.summary(),
        "coll_counts": {f"{ax}:{nm}": v for (ax, nm), v in costs.coll_counts.items()},
        "model_flops_global": mf,
        "model_flops_per_chip": mf / n_chips,
        "useful_flops_ratio": (mf / n_chips) / max(costs.dot_flops, 1.0),
        "notes": costs.notes[:5],
        "constants": {"peak_flops": roofline.PEAK_FLOPS, "hbm_bw": roofline.HBM_BW,
                      "link_bw": roofline.LINK_BW, "pod_bw": roofline.POD_BW},
    }
    return _emit(report, save, kind, method, tag_extra)


def _emit(report: dict, save: str | None, kind: str, method: str, tag_extra: str) -> dict:
    """Print the report; under ``save``, write it as ``<tag>.json`` (a
    skipped combination too, so that a sweep has one file for each)."""
    print(json.dumps(report, indent=1, default=str))
    if save:
        os.makedirs(save, exist_ok=True)
        tag = f"{report['arch']}_{report['shape']}_{'pod2' if report['multi_pod'] else 'pod1'}"
        if kind == "train" and method != "layered":
            tag += f"_{method}"
        if tag_extra:
            tag += f"_{tag_extra}"
        with open(os.path.join(save, tag + ".json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
    return report


def run_all(out_dir: str, *, archs=None, shapes=None, meshes=(False, True),
            method: str = "layered") -> list:
    """A subprocess per combination (one failure does not end the sweep);
    a report that exists is skipped, a failure leaves ``<tag>.FAILED``.
    Returns the failed tags."""
    archs = archs or configs.list_archs()
    shapes = shapes or list(SHAPES)
    src = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    os.makedirs(out_dir, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape}_{'pod2' if mp else 'pod1'}"
                if method != "layered" and SHAPES[shape]["kind"] == "train":
                    tag += f"_{method}"
                outf = os.path.join(out_dir, tag + ".json")
                if os.path.exists(outf):
                    print(f"[skip existing] {tag}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--method", method,
                       "--save", out_dir]
                if mp:
                    cmd.append("--multi-pod")
                print(f"[run] {tag}", flush=True)
                r = subprocess.run(cmd, capture_output=True, text=True, timeout=3600, env=env)
                if r.returncode != 0:
                    failures.append(tag)
                    with open(os.path.join(out_dir, tag + ".FAILED"), "w") as f:
                        f.write(r.stdout[-5000:] + "\n" + r.stderr[-10000:])
                    print(f"[FAIL] {tag}: see {tag}.FAILED")
    print(f"done; {len(failures)} failures: {failures}")
    return failures


def apply_plan(args, passed: set[str]) -> None:
    """Adopt a plan's execution section (``launch.plan``'s output, either
    package's): arch, method, partition and, when its mesh splits the 256
    ranks, the mesh shape.  Flags given on the command line win; the
    workload shapes and the micro-batch sizing stay the dry run's own."""
    from repro_torch.planner.plan import execution_of, load_plan

    ex = execution_of(load_plan(args.plan))
    args.arch = args.arch or ex.get("arch")
    if "method" in ex and "--method" not in passed:
        args.method = ex["method"]
    if "partitioned" in ex and "--no-partition" not in passed:
        args.no_partition = not ex["partitioned"]
    d, m = (int(v) for v in ex.get("mesh", "1x1").split("x"))
    if "--mesh-shape" in passed:
        pass
    elif d * m == 256:
        args.mesh_shape = ex["mesh"]
    elif "mesh" in ex:
        print(f"[plan] mesh {ex['mesh']} is not a 256-rank split; "
              f"keeping the default production grid")


def main(argv=None) -> dict | list | None:
    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--plan", default=None,
                    help="JSON plan from `python -m repro_torch.launch.plan`")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--method", default="layered", choices=["layered", "standard"])
    ap.add_argument("--no-partition", action="store_true")
    ap.add_argument("--mesh-shape", default=None,
                    help="another data x model split of 256 ranks, e.g. 32x8")
    ap.add_argument("--expert-parallel", action="store_true")
    ap.add_argument("--reduce-dtype", default="float32")
    ap.add_argument("--fused", action="store_true",
                    help="paper §C.3: per-layer fused optimizer update")
    ap.add_argument("--tag", default="")
    ap.add_argument("--save", default=None)
    ap.add_argument("--all", action="store_true",
                    help="the full (arch x shape x grid) sweep, a subprocess each")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)
    if args.plan:
        argv = sys.argv[1:] if argv is None else argv
        apply_plan(args, {a.split("=")[0] for a in argv if a.startswith("--")})
    if args.all:
        return run_all(args.out, method=args.method)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape required (or --all)")
    return run_one(args.arch, args.shape, multi_pod=args.multi_pod,
                   method=args.method, partitioned=not args.no_partition,
                   save=args.save, mesh_shape=args.mesh_shape,
                   expert_parallel=args.expert_parallel,
                   reduce_dtype=args.reduce_dtype, tag_extra=args.tag,
                   fused=args.fused)


if __name__ == "__main__":
    main()
