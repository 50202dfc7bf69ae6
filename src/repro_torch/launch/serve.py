"""Serving entry point: the continuous-batching engine over a synthetic trace
(counterpart of ``repro/launch/serve.py``).

Weights are random, drawn from ``--seed``, or read from ``--checkpoint-dir``:
a flat full-layout parameter checkpoint (``checkpointing/store.py``'s files,
the JAX package's ``layers__...`` leaves stacked ``[L, ...]``, one file per
layer), as the JAX server loads.  ``--trace`` writes a Chrome trace of the
engine's prefill and decode spans (their args: launch and wait, a prefill's
padding and its requests' queue waits, ``serving/engine.py``).  The result
line's ``ttft_ms``, ``itl_ms`` and ``queue_ms`` are wall-clock percentiles
over the finished requests (``ServingEngine.latency_summary``).  The run goes
on the card unless ``--device cpu`` is given (the plain PyTorch versions of
the kernels).

``--plan`` runs no engine: it ranks serving configurations (tensor-parallel
width x live batch x cache layout, at ``--plan-mean-ctx`` live tokens a
request and a dense cache of ``--plan-max-seq``) by simulated decode tok/s
with the planner's serving search, on the paper's A100 of its table A.1 as
the JAX package's does, prints the top 12 and returns them.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
      --requests 16 --prompt-lens 64,128,256,512 --max-new 32,64 \\
      --block-size 16 --num-blocks 2048
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke --device cpu \\
      --checkpoint-dir /tmp/params --trace serve_trace.json
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b --plan
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpointing import store
from repro_torch.convert import params_from_numpy
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.obs.trace import Tracer
from repro_torch.planner.search import search_serving
from repro_torch.resilience.reshard import MeshLayout, storage_template
from repro_torch.serving.cache import PagedCacheConfig
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import SchedulerConfig, poisson_trace


# the full parameter tree's layout (flat, replicated, one rank)
_FLAT_FULL = MeshLayout(partitioned=False)


def _ints(s: str) -> list[int]:
    return [int(p) for p in s.split(",")]


def main(argv=None, *, params: dict | None = None) -> dict:
    """The serving run; ``params`` (the model's parameter dict, on the card
    or the CPU), when a caller passes it, replaces the weights the flags
    name.  Returns the result line's keys and ``outputs`` (request id ->
    tokens)."""
    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--arch", default="yi-6b", choices=configs.list_archs())
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers at full width (0: the "
                         "config's depth)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=0.5,
                    help="Poisson arrivals per engine step")
    ap.add_argument("--prompt-lens", default="8,16,24")
    ap.add_argument("--max-new", default="8,16")
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--num-blocks", type=int, default=128)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--mode", default="continuous", choices=["continuous", "static"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="a flat full-layout parameter checkpoint (the JAX tree's leaves)")
    ap.add_argument("--trace", default=None,
                    help="write a Chrome-trace JSON of the engine's prefill/decode spans here")
    ap.add_argument("--plan", action="store_true",
                    help="rank serving configurations with the planner's serving search "
                         "and exit (no engine run)")
    ap.add_argument("--plan-mean-ctx", type=int, default=2048)
    ap.add_argument("--plan-max-seq", type=int, default=4096)
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch, smoke=args.smoke)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if args.plan:
        plans = search_serving(cfg, mean_ctx=args.plan_mean_ctx, max_seq=args.plan_max_seq)
        rows = [p.row() for p in plans[:12]]
        for r in rows:
            r.pop("sim")
            print(json.dumps(r))
        return {"plans": rows}

    if cfg.input_mode != "tokens":
        raise SystemExit(f"{args.arch}: paged serving needs token inputs (the "
                         f"{cfg.input_mode!r} input mode trains only, as in the JAX package)")
    if cfg.block_kind != "attn":
        raise SystemExit(f"{args.arch}: paged serving needs a token-input attention "
                         f"stack (the recurrent families serve through the dense-cache "
                         f"steps, core/stepfn.build_prefill_step / build_serve_step)")
    device = resolve_device(args.device)
    if params is None and args.checkpoint_dir:
        full, step = store.load_state(args.checkpoint_dir, storage_template(cfg, _FLAT_FULL))
        params = params_from_numpy(cfg, full, device)
        print(f"loaded checkpoint at step {step} from {args.checkpoint_dir}", flush=True)
    elif params is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = T.init_params(cfg, gen, device)

    prompt_lens, max_new = _ints(args.prompt_lens), _ints(args.max_new)
    max_tok = max(prompt_lens) + max(max_new)
    pcfg = PagedCacheConfig(num_blocks=args.num_blocks, block_size=args.block_size,
                            max_blocks_per_seq=-(-max_tok // args.block_size))
    tracer = Tracer() if args.trace else None
    engine = ServingEngine(cfg, params, SchedulerConfig(
        cache=pcfg, max_batch=args.max_batch, mode=args.mode), tracer=tracer)
    reqs = poisson_trace(np.random.default_rng(args.seed), n_requests=args.requests,
                         rate=args.rate, vocab=cfg.vocab_size,
                         prompt_lens=prompt_lens, max_new=max_new)
    engine.submit_all(reqs)

    t0 = time.perf_counter()
    outputs = engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    lat = [r.finish_step - r.arrival for r in engine.finished.values()]
    lsum = engine.latency_summary()
    result = {
        "arch": args.arch, "mode": args.mode, "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "requests": len(outputs),
        "emitted_tokens": engine.stats["emitted_tokens"],
        "engine_steps": engine.stats["engine_steps"],
        "prefill_calls": engine.stats["prefill_calls"],
        "decode_steps": engine.stats["decode_steps"],
        "preemptions": engine.stats["preemptions"],
        "tok_per_s": engine.stats["emitted_tokens"] / dt,
        "mean_latency_steps": float(np.mean(lat)),
        "ttft_ms": lsum["ttft_ms"], "itl_ms": lsum["itl_ms"], "queue_ms": lsum["queue_ms"],
        "seconds": dt,
    }
    if tracer is not None:
        tracer.save(args.trace)
        print(f"engine trace written to {args.trace}")
    for rid in sorted(outputs)[:4]:
        print(f"  req{rid}: {outputs[rid]}")
    print(json.dumps(result))
    return dict(result, outputs=outputs)


if __name__ == "__main__":
    main()
