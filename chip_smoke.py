#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root; needs nvcc

Phases, each printing its own lines and its seconds; any failure exits
nonzero and prints no result:

  1. the card (name and power limit from nvidia-smi) and the nvcc build of
     every kernel from the sources in the checkout, naming each instance
     that spills and the head-dim-256 instances' registers (a spill of one
     of those fails the run);
  2. each CUDA kernel against its plain PyTorch version on the card: the
     shapes the Yi-6B serving and training paths give it in bf16 and fp32,
     plus window, softcap, MQA, ragged-length, head-dim 64/256, idle-row and
     bf16-moment cases; at the path shapes, the kernel's time, the plain
     version's, one PyTorch library call's where one computes the same
     function (a yardstick the port never calls) and the card's bound;
  3. parity: Yi-6B at full width cut to 2 layers, fp32, one set of weights
     made on the CPU and copied to the card; 3 ragged prompts through prefill
     and 4 decode steps, and one layered, partitioned train step, each on the
     card (kernels) and on the CPU (plain versions);
  4. serving the full model: Yi-6B, 32 layers, bf16, weights made on the
     card, served by ``ServingEngine`` over a seeded Poisson trace, with the
     exact kernel launch counts of the run; then a ``torch.profiler`` window
     over decode steps and a prefill call (device busy share, device time by
     kernel group), which reports and never fails the run;
  5. training at full width: ``python -m repro_torch.launch.train`` on Yi-6B
     cut to 8 layers (bf16 compute over fp32 ZeRO-layout state, layered
     accumulation, fused AdamW), global batch 8 x 2048 tokens in 4
     micro-batches, with the exact launch counts of every step; then one
     profiled step, which reports and never fails the run;
  6. the process-group path on the card: phase 5's run again under a
     world-size-1 NCCL group (every collective issued), whose losses and grad
     norms must equal phase 5's to 1e-6 relative, with the exact per-step
     collective counts of the layered schedule (2 x 9 L + 3 all-gathers and
     9 L + 3 reduce-scatters over the data group) and of one standard step
     (M times those); then the §C.3 fused per-layer update against the
     classic step, 3 steps each at grad_clip=0: equal losses (1e-6), 9 L + 3
     K6 launches a step, both peak memories and step times;
  7. the pipeline (``core/pipeline.py``'s tick-table executor through
     ``stepfn.build_pipeline_train_step``) on phase 5's configuration, one
     stage on a world-size-1 NCCL stage x data x model group (NCCL refuses
     two ranks on one card, so every ring is a transfer to self).  First
     step 0's gradient of each schedule below, leaf by leaf, against the
     layered schedule's on the same weights and batch (relative L2 within
     1e-6).  Then 5 steps of ``modular`` and 3 of ``1f1b`` split into
     dgrad and wgrad ticks (the slice's path: the outer leaves take the
     tree-map AdamW), and 5 each of ``modular`` and ``1f1b`` with every leaf
     through K6 as in phase 5, which take the causes of the trajectories'
     drift apart.  Step 0's loss must equal phase 5's exactly and its grad
     norm to 1e-6; later losses and grad norms stay within each run's
     tolerance (``PIPE_RUNS``); the data-group gathers and reduce-scatters,
     the stage-group sends and receives and the K1-K6 launches must be the
     counts the tick table gives, every step; then one profiled step;
  8. the supervised run (checkpoints, faults, telemetry) on Yi-6B at full
     width cut to 2 layers, phase 5's batch, 6 steps, a checkpoint every 2
     (params + Adam moments, 10.4 GB; it fails when the filesystem has
     less than 3 bundles free): (a) ``launch.train`` with ``--metrics`` and
     ``--trace``, the reference history; (f) a flat params checkpoint of its
     final weights served by ``launch.serve --checkpoint-dir`` (4 requests),
     whose greedy tokens must equal the same engine's on the weights in
     memory; (b)-(d) ``--resume auto --faults``: a crash before step 3
     restarts from step 2 (one lost step), the step-4 checkpoint corrupted
     and a crash before step 4 give ``restore_rejected`` and a restart from
     step 2, step 5's NaN gradient is skipped with the state's digest
     unchanged, and every step taken equals (a)'s bit for bit; the write and
     read-and-verify rates and the recovery times are printed; (e) the tick
     profiler on phase 7's pipeline (modular, 64 ticks): every table unit
     timed, none missing or extra;
  9. plan-driven launch: ``python -m repro_torch.launch.plan`` ranks the
     one-card executions of phase 5's configuration (Yi-6B cut to 8 layers,
     8 x 2048 tokens, 1, 2, 4 or 8 micro-batches) at the H100's constants
     (``--devices`` left at 0: this machine's cards), and ``launch.train
     --plan`` runs the winner 5 steps: the resolved execution must be the
     plan's, every step finite, the K1-K5 launches exactly the planned
     method and micro-batch count's and K6 none (a one-card plan is
     unpartitioned: the tree-map AdamW); the plan's predicted step time is
     printed beside the measured one.  The same run given by flags must
     equal it bit for bit; K1-K5 at the planned micro-batch's shapes
     against their plain versions (phase 2's training-shape tolerances);
     then one profiled step of the plan's
     configuration, which reports and never fails the run.  On the host, the paper's X_160 document (the
     paper's A100): Table 6.1's winner, 38640 GPUs, ~1.9x its 3d baseline;
 10. the mixture-of-experts family, with the earlier phases' tensors freed
     first: (a) dbrx-132b at every published width (16 experts top 4, 48/8
     heads) cut to 8 layers, bf16, weights made on the card, served by
     ``ServingEngine`` over a seeded Poisson trace (16 requests) with exact
     K1/K3/K7 launch counts, then a profile of its decode steps (device
     time, GEMM time and the one-hot dispatch and combine's share of it);
     (b) arctic-480b at every published width (128 experts top 2, the dense
     residual FFN, 56/8 heads) cut to 2 layers, 4 requests, exact counts;
     (c) dbrx-132b's widths, 1 layer, fp32, on the card and on the CPU with
     the same weights: the router's expert ids and the greedy tokens of 3
     ragged prompts and 4 decode steps equal; (d) ``launch.train`` at
     dbrx-132b's widths, 1 layer, 8 of its 16 experts (the fp32 state of 16
     is more than a card holds), 8 x 2048 tokens in 4 micro-batches, 5 steps,
     exact K1-K6 counts, finite loss, grad norm and aux; (e) K1/K2 at
     d_model 6144 and 7168, K3-K5 at rep 6 and 7, K7 at both, against their
     plain versions with phase 2's tolerances;
 11. the recurrent families, with the earlier phases' tensors freed first:
     (a) rwkv6-3b (32 layers, 6.54 GB) and zamba2-7b (81 layers, 13
     shared-block slots, 26.04 GB) at full width and depth in bf16, weights
     made on the card, through ``stepfn.build_prefill_step`` (8 prompts of 512
     tokens) and 64 greedy ``build_serve_step`` steps over the dense cache:
     prefill ms, decode ms a step, tok/s, peak memory, exact K1/K3 counts, a
     profile of 4 decode steps; (b) every published width cut in depth (2 and
     6 layers), fp32, card against CPU: prefill logits, the greedy tokens of
     4 decode steps and the final recurrent state; (c) ``launch.train`` at
     full width, layered and partitioned, 8 x 2048 tokens in 4 micro-batches,
     5 steps, exact K1-K6 counts: rwkv6-3b at full depth (52.3 GB of fp32
     state), zamba2-7b cut to 12 layers (the shared block twice, its gradient
     summed over both); (d) the §C.3 fused step on that cut, its first loss
     equal to (c)'s, then one fused step profiled; (e) K1/K2 at rwkv6-3b's
     training rows [4096, 2560] and both archs' decode rows [8, d_model]
     against their plain versions.  Phase 2 also holds K1-K5 at zamba2-7b's
     shapes (K1/K2 on [4096, 3584]; K3-K5 at head dim 112: the training
     shape [2, 2048, 32, 112], the prefill shape [8, 512, 32, 112], GQA at
     rep 4, fp32) with K3-K5's times, bounds and SDPA's;
 12. the pipeline for every family and the two input modes, with the
     earlier phases' tensors freed first: (a) the pipeline at one stage on a
     world-size-1 NCCL group for zamba2-7b cut to 12 layers (the shared block
     twice) and dbrx-132b at phase 10's training cut (1 layer, 8 of 16
     experts), the router's aux weight 0 (the pipeline drops the aux loss):
     at each of 3 steps of the layered trajectory, on that step's storage,
     the gradient of modular and split 1f1b, leaf by leaf, against the
     layered schedule's (relative L2 1e-6, the loss equal), and the
     pipelined update against the layered one on the same gradient (the
     global norm, every weight and moment to 1e-6); then one whole pipelined
     step of each, exact K1-K6 launches; (b)
     ``launch.train`` at full width: musicgen-large at full depth (48 layers,
     frame embeddings, 8 x 2048) and llava-next-mistral-7b cut to 8 layers
     (a 2880-position vision prefix and 1216 text tokens, 4 x 4096), 5
     steps, exact K1-K6 launches, tok/s and MFU over every position; (c)
     both archs at full width, 2 layers, fp32, one gradient pass on the card
     and on the CPU (llava's prefix cut to 64 positions); (d) K1-K5 at both
     archs' training micro-batches against their plain versions (musicgen's
     MHA at head dim 64, rep 1; llava's GQA at rep 4), K3-K5's times beside
     SDPA's and the bound;
 13. serving over a group, on a world-size-1 NCCL group (every collective
     issued), each run against the one-rank steps on the same weights and
     inputs, the two called in turns: (a) Yi-6B at full depth, bf16, phase
     4's weights, 8 ragged prompts through the paged prefill and 32 greedy
     decode steps of ``build_paged_serve_step``; (b) dbrx-132b at phase 10's
     cut in the serving layout (``transformer.init_params`` on the group), prefill and 8
     steps; (c) rwkv6-3b and zamba2-7b at full depth through the dense-cache
     ``build_prefill_step`` / ``build_serve_step`` over the group, 8 x 128
     prefill and 8 steps, and the caches they leave; (d) a sequence-sharded
     dense cache (one shard, ``stepfn.shard_cache``) of a 4000-token Yi-6B
     prefix, 16 steps against the unsharded cache.  Greedy tokens equal and
     logits within 1e-5 of their scale at every call, exact collectives
     (2 L + 1 model all-reduces and one logits all-gather a call for an
     attention stack; 3 L seq all-reduces a sequence-sharded step) and exact
     K1/K3/K7 launches of the group's calls; decode ms a step of both;
 14. the ``kernels`` line (launches over phases 4-13, 15, 17 and 18), and as the last
     line ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``;
 15. (run before 14's lines) the pod axis and what one card shows of the
     failure-shrink, on a world-size-1 NCCL grid with pod, data and model
     groups of one: (a) Yi-6B at phase 5's cut (8 layers, bf16, layered,
     partitioned, 8 x 2048 tokens in 4 micro-batches), 3 steps each of the
     group step without pods, with ``span_pods`` (the partition over pod x
     data) and without it (the gradients summed over pod): losses, grad
     norms and final state bit for bit the group step's, which are phase 6's
     run's; exact calls and bytes of every (group, op) and K1-K6 launches;
     (b) the survivors' grid built and the state drained onto its own layout
     (no rank leaves): digest unchanged, the gathers counted and timed; a
     ``lose_replica`` fault at data 1 refused with the JAX package's message
     and the state as an unfaulted run leaves it (2-layer cut);
 16. (run before 14's lines) the dry run: (a) ``core/roofline.py:analyze``
     of phase 5's own step (``stepfn.build_train_step`` at phase 5's
     configuration, one rank) on ``meta`` tensors: the predicted peak memory
     against phase 5's ``max_memory_allocated``, the dot flops against 6ND,
     and the roofline bound (the larger of the compute and memory terms)
     against phase 5's steady step time; it fails when the bound exceeds
     the measured step, when the predicted peak lies outside 0.5-2x the
     measured one, or when a term is not finite; (b) ``python -m
     repro_torch.launch.dryrun --arch yi-6b --shape train_4k`` in a
     subprocess: one rank of the 16 x 16 production grid on a fake process
     group, its roofline, memory and seconds under this machine's torch.
 17. (run before 14's lines) the gemma family trained on the card: ``python -m
     repro_torch.launch.train`` on gemma-2b at full depth (8 x 2048 tokens in
     4 micro-batches, 5 steps) and gemma2-9b cut to 6 layers (4 x 8192 in 4
     micro-batches, 3 steps: its window cuts every local layer, softcap 50),
     both at full width, bf16 compute over fp32 state, layered +
     partitioned: step time, tok/s, MFU, peak memory, exact launch counts,
     then one profiled step (device ms of GEMM, K3, K4, K5 and the rest,
     the idle share) whose K3, K4 and K5 launches must be the head-dim-256
     tensor-core instances.
 18. (run before 14's lines) granite-20b (48 query heads on one KV head of
     128, LayerNorm, plain GELU): K3-K5 and K7 at its shapes against their
     plain versions as phase 2 holds the gemma shapes (K5 split over
     ``GRANITE_SPLIT`` blocks, its bits equal over repeated calls), with
     each kernel's time, bound and SDPA's time; served at full depth through
     ``launch.serve.main`` (bf16 weights made on the card from the seed,
     exact K3/K7 launches and no K1, every request's budget, finite logits,
     TTFT, ITL, tok/s, peak memory), 10 decode steps profiled; then the dry
     run's peak for its 6-layer training cut and ``launch.train`` at that
     cut (8 x 2048 in 4 micro-batches, 3 steps): exact launches, finite
     losses, the peak within 0.5-2x of the dry run's, one profiled step whose
     K5 launches run the grouped instance at the split ``dkv_split`` keeps
     for granite's micro-batch (``GRANITE_SPLIT``) beside its partial sum.
Phase 2 also holds K3-K5 at head dim 256 at gemma-2b's training shape (q [2,
2048, 8, 256], k/v [2, 2048, 1, 256]) and gemma2-9b's (q [1, 8192, 16, 256],
k/v [.., 8, 256], softcap 50, window 4096), bf16 on the tensor cores, with
K4's bits equal over repeated calls at both shapes and K5's at gemma-2b's,
and times them beside their bound and SDPA's time.  Wherever bf16 K4 is
held, every dq row is also held to the plain version with ds rounded to
bf16 (``check_dq_rows``); at both gemma shapes a control, a K4 that skipped
a key tile, must fail that check.  It also times K3-K5 in fp32 at the
training shape beside SDPA in fp32 and the bound at the fp32 rate.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import socket
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12,          # dense bf16 tensor-core rate
              "float32": 67e12}            # fp32 off the tensor cores
FP32_TOL = 1e-4                            # kernel vs plain: summation order only
# bf16 K3 and K4/K5 on the tensor cores (every head dim) vs plain, times the
# output scale: the JAX package's own bf16 tolerances, forward
# (tests/test_kernels.py::test_flash_attention_dtypes) and backward
# (::test_flash_attention_grads_bf16).  The tensor-core products take p (and
# ds) rounded to bf16, as SDPA's do, where the plain version keeps them fp32.
BF16_FWD_TOL = 2e-2
BF16_BWD_TOL = 2e-2
# bf16 K3 on the tensor cores against the plain version that rounds p to bf16
# as the kernel does (round_p): every row within this many bf16 ulps of its
# own scale (the row's largest |out|).  Both sides round out to bf16 (up to
# one ulp apart) and round p against a different running max.
K3_ROW_ULPS = 2
# bf16 K4 on the tensor cores against the plain version that rounds ds to
# bf16 as the kernel does (round_ds): every row within this many bf16 ulps of
# its own scale (the row's largest |dq|).  Both sides round dq to bf16, and a
# ds that lies near a rounding edge may round to neighbours on the two sides.
# A row's scale is taken at least K4_ROW_FLOOR times the output's scale (at
# least 1): below that a row is a cancellation, as the first query row, whose
# one key gives dP = delta and ds made of fp32 rounding alone (the plain
# version's may be exactly zero, the kernel's not).
K4_ROW_ULPS = 4
K4_ROW_FLOOR = 2.0 ** -10
# K6's fp32 outputs, element by element: |kernel - plain| <= atol + rtol |plain|
# (where v is near zero the update is large, and so is p's fp32 spacing)
K6_RTOL, K6_ATOL = 1e-5, 1e-6


def say(*parts) -> None:
    print(*parts, flush=True)


def ptxas_report(log: str) -> dict:
    """The build log's ``-Xptxas -v`` lines by kernel instance, demangled
    with ``c++filt`` (mangled, with a warning, where that fails): registers,
    stack frame and spill bytes."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", ln)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", ln)
        if m and name:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    names = list(out)
    try:
        plain = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True, check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        plain = []
    if len(plain) != len(names):
        say("  warning: c++filt could not demangle the build log's kernel names")
        plain = names
    return {re.sub(r"^(?:void )?(?:\(anonymous namespace\)::)?", "", p).split("(")[0]: out[n]
            for n, p in zip(names, plain) if n.startswith("_Z")}


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean time of ``fn`` on the card: CUDA events around ``iters`` calls
    after a warm-up (inputs stay as the path leaves them, in L2 or not)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def in_turns(torch, fns: dict, iters: int, rounds: int) -> dict:
    """``cuda_ms`` of each function, taken in turns: each round runs them in
    order and then in reverse (a, b, b, a), so that a drifting clock weighs
    on each alike.  ``fns`` maps a name to ``(fn, calls)``: ``fn`` makes
    ``calls`` calls (a graph's replay), and a reading is the time of one of
    ``iters`` calls.  Returns every reading, by name."""
    out = {k: [] for k in fns}
    order = list(fns) + list(reversed(fns))
    for _ in range(rounds):
        for k in order:
            fn, calls = fns[k]
            out[k].append(cuda_ms(torch, fn, max(1, iters // calls)) / calls)
    return out


def smi_clocks() -> str:
    """The card's SM clock (and its maximum), power draw, temperature and
    active throttle reasons, read beside a measurement; never fails the run."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu,"
             "clocks_throttle_reasons.active", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({type(e).__name__})"


def graphed(torch, fn, n: int = 50):
    """A CUDA graph of ``n`` calls of ``fn``, captured after three calls on a
    side stream (allocations and autograd's set-up before capture); returns
    its replay, which launches them with no host cost (the wrapper's
    Python) between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return graph.replay


def graph_ms(torch, fn, n: int = 50) -> float:
    """Device time of one call of ``fn``: a CUDA graph of ``n`` calls,
    replayed and timed with CUDA events."""
    return cuda_ms(torch, graphed(torch, fn, n), 10) / n


def bf16_ulp(scale: float) -> float:
    """One bf16 ulp at the output's scale (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(scale, 2.0 ** -100))) - 7)


def tolerance(torch, ref, rel: bool = False, bf16_rel: float = 0.0) -> float:
    """bf16: one ulp of the output's scale, or ``bf16_rel`` times the scale
    (at least 1) where given.  fp32: FP32_TOL, times the output's scale when
    ``rel`` (the backward kernels' outputs are sums of up to thousands of
    terms, so their summation-order error scales with them)."""
    scale = ref.float().abs().max().item()
    if ref.dtype == torch.bfloat16:
        return bf16_rel * max(1.0, scale) if bf16_rel else bf16_ulp(scale)
    return FP32_TOL * max(1.0, scale) if rel else FP32_TOL


def row_ulps(torch, got, want, floor: float = 0.0) -> float:
    """The worst row's largest |got - want|, in bf16 ulps of that row's scale
    (its largest |want| over the last dim, at least ``floor`` times the whole
    output's scale, itself at least 1).  With no floor, a row whose ``want``
    is all zero must be exactly zero (inf otherwise)."""
    err = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    if floor:
        scale = scale.clamp(min=floor * max(1.0, scale.max().item()))
    ulp = torch.ldexp(torch.ones_like(scale), torch.frexp(scale).exponent - 8)
    ratio = torch.where(scale > 0, err / ulp, err * math.inf).nan_to_num(0.0, math.inf)
    return ratio.max().item()


def elem_ratio(torch, got, want, rtol: float, atol: float) -> float:
    """max |got - want| / (atol + rtol |want|) over the elements."""
    return ((got.float() - want.float()).abs() / (atol + rtol * want.float().abs())).max().item()


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_case(torch, name, got, want, failures, parts=("", " [lse]"),
               rel: bool = False, bf16_rel: float = 0.0, fp32_elem=None) -> float:
    """``fp32_elem`` = (rtol, atol): fp32 outputs element by element instead."""
    torch.cuda.synchronize()
    outs = got if isinstance(got, tuple) else (got,)
    refs = want if isinstance(want, tuple) else (want,)
    errs = []
    for part, g, w in zip(parts, outs, refs):
        if g.shape != w.shape or g.dtype != w.dtype:
            failures.append(f"{name}: {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
            return float("inf")
        err = (g.float() - w.float()).abs().max().item()
        errs.append(err)
        finite = bool(torch.isfinite(g.float()).all())
        if fp32_elem and w.dtype == torch.float32:
            r = elem_ratio(torch, g, w, *fp32_elem)
            ok = r <= 1 and finite
            say(f"  {name}{part}: max_abs_err={err:.3e}, worst |err| / ({fp32_elem[1]:g} + "
                f"{fp32_elem[0]:g} |plain|) = {r:.3f} (limit 1) {'ok' if ok else 'FAIL'}")
        else:
            tol = tolerance(torch, w, rel, bf16_rel)
            ok = err <= tol and finite
            say(f"  {name}{part}: max_abs_err={err:.3e} tol={tol:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(name + part)
    return max(errs)


def check_rows(torch, name, got, want_r, failures) -> None:
    """bf16 K3 on the tensor cores against the plain version with p rounded
    to bf16 (``want_r``): every row within K3_ROW_ULPS of its scale."""
    r = row_ulps(torch, got, want_r)
    ok = r <= K3_ROW_ULPS
    say(f"  {name} [out vs plain with p rounded to bf16]: worst row {r:.2f} bf16 ulps of "
        f"its scale (limit {K3_ROW_ULPS}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(name + " [out, by row]")


def check_dq_rows(torch, name, dq, q, k, v, out, lse, do, kw, failures,
                  control: bool = False) -> None:
    """bf16 K4 on the tensor cores against the plain version with ds rounded
    to bf16: every row within K4_ROW_ULPS of its scale (``row_ulps`` with
    K4_ROW_FLOOR).  ``control``: the plain dq of a K4 that skipped the
    diagonal key tile of the last query tile (its last 64 keys) must fail
    the same check; its error against the scale-wide limit is printed
    beside it."""
    from repro_torch.kernels import flash_attention as fa
    want_r = fa.plain_bwd_dq(q, k, v, out, lse, do, round_ds=True, **kw)[0]
    r = row_ulps(torch, dq, want_r, K4_ROW_FLOOR)
    ok = r <= K4_ROW_ULPS
    say(f"  {name} [dq vs plain with ds rounded to bf16]: worst row {r:.2f} bf16 ulps of "
        f"its scale (limit {K4_ROW_ULPS}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(name + " [dq, by row]")
    if control:
        S = q.shape[1]
        bad = fa.plain_bwd_dq(q, k, v, out, lse, do, round_ds=True, kv_len=S - 64, **kw)[0]
        r_bad = row_ulps(torch, bad, want_r, K4_ROW_FLOOR)
        bad_err = (bad.float() - want_r.float()).abs().max().item()
        scale_tol = BF16_BWD_TOL * max(1.0, want_r.float().abs().max().item())
        say(f"  control (the last query tile's diagonal key tile skipped): worst row "
            f"{r_bad:.1f} bf16 ulps of its scale, limit {K4_ROW_ULPS}: "
            f"{'rejected' if r_bad > K4_ROW_ULPS else 'NOT REJECTED'}; max abs err "
            f"{bad_err:.3e}, {bad_err / scale_tol:.2f}x the {BF16_BWD_TOL:g}-of-scale limit "
            f"{scale_tol:.3e}")
        if r_bad <= K4_ROW_ULPS:
            failures.append(name + ": the dq row check did not reject its control")
        del bad
    del want_r


def phase_kernels(torch, F):
    from repro_torch import configs
    from repro_torch.kernels import adamw as aw
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    failures, rows = [], {}

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    # -- K1 RMSNorm: prefill rows B*S = 8*512, decode rows 8, d_model 4096
    say("K1 rmsnorm (eps 1e-6; fp32 tol 1e-4, bf16 tol one ulp of the output scale)")
    main = None
    for rows_, D, dtype, p1 in [(4096, 4096, torch.bfloat16, False),
                                (4096, 4096, torch.float32, False),
                                (8, 4096, torch.bfloat16, False),
                                (37, 3584, torch.bfloat16, True),
                                (5, 2048, torch.float32, True)]:
        x, s = randn(rows_, D, dtype=dtype), randn(D)
        err = check_case(torch, f"rows={rows_} D={D} {str(dtype)[6:]} plus_one={p1}",
                         rn.rmsnorm_cuda(x, s, plus_one=p1), rn.plain(x, s, plus_one=p1),
                         failures)
        main = main or (x, s, err)
    x, s, err = main
    sb = s.to(x.dtype)
    es = x.element_size()
    rows["rmsnorm"] = dict(
        shape=f"x [{x.shape[0]}, {x.shape[1]}] bf16", max_abs_err=err,
        ms=cuda_ms(torch, lambda: rn.rmsnorm_cuda(x, s), 200),
        plain_ms=cuda_ms(torch, lambda: rn.plain(x, s), 50),
        library_ms=cuda_ms(torch, lambda: F.rms_norm(x, (x.shape[1],), sb, 1e-6), 200),
        bound=bound(2 * x.numel() * es + 4 * x.shape[1], 4 * x.numel(), "bfloat16"))

    # -- K3 flash forward: prefill bucket B=8, S=512, 32 q heads, 4 KV heads, hd 128
    say(f"K3 flash_attention_fwd (out and lse; lse tol 1e-4; out: fp32 tol 1e-4; bf16 (tensor "
        f"cores) {BF16_FWD_TOL:g} of the output scale (at least 1), and every row within "
        f"{K3_ROW_ULPS} bf16 ulps of its scale of the plain version with p rounded to bf16 "
        "before P*V, as the kernel rounds it)")
    from torch.profiler import ProfilerActivity, profile
    main, n_tc = None, 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for (B, S, Hq, Hkv, D), dtype, kw in [
                ((8, 512, 32, 4, 128), torch.bfloat16, dict(causal=True)),
                ((8, 512, 32, 4, 128), torch.float32, dict(causal=True)),
                ((2, 512, 32, 4, 128), torch.bfloat16, dict(causal=True, window=128, softcap=50.0)),
                ((2, 300, 16, 1, 128), torch.bfloat16, dict(causal=True)),            # MQA
                ((3, 77, 8, 2, 128), torch.float32, dict(causal=True, kv_len=70)),   # odd S, pad keys
                ((3, 77, 6, 2, 128), torch.bfloat16, dict(causal=True, kv_len=70)),  # rep 3
                ((2, 300, 8, 2, 64), torch.bfloat16, dict(causal=True, window=40)),
                ((2, 50, 4, 2, 64), torch.bfloat16, dict(causal=False, kv_len=41)),
                ((2, 256, 8, 4, 256), torch.bfloat16, dict(causal=True, window=64, softcap=50.0)),
                ((2, 50, 4, 2, 64), torch.float32, dict(causal=False, kv_len=41))]:
            q, k, v = randn(B, S, Hq, D, dtype=dtype), randn(B, S, Hkv, D, dtype=dtype), \
                randn(B, S, Hkv, D, dtype=dtype)
            tc = dtype == torch.bfloat16                  # every bf16 head dim
            n_tc += tc
            name = f"q={[B, S, Hq, D]} kv_heads={Hkv} {str(dtype)[6:]} {kw}"
            got = fa.flash_attention_fwd_cuda(q, k, v, **kw)
            err = check_case(torch, name, got, fa.plain(q, k, v, **kw), failures,
                             bf16_rel=BF16_FWD_TOL if tc else 0.0)
            if tc:
                check_rows(torch, name, got[0], fa.plain(q, k, v, round_p=True, **kw)[0],
                           failures)
            main = main or (q, k, v, err)
        torch.cuda.synchronize()
    launched = profiled_instances(prof)
    say(f"  launched as: {launched}")
    if sum(c for name, c in launched.items() if "flash_fwd_kernel_tc" in name) != n_tc:
        failures.append(f"K3: {n_tc} bf16 cases did not all run flash_fwd_kernel_tc")
    q, k, v, err = main
    B, S, Hq, D = q.shape
    es = q.element_size()
    pairs = S * (S + 1) // 2                                  # causal, live (q, k) pairs
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    rows["flash_attention_fwd"] = dict(
        shape=f"q [{B}, {S}, {Hq}, {D}] k/v [{B}, {S}, {k.shape[2]}, {D}] bf16 causal",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: fa.flash_attention_fwd_cuda(q, k, v), 20),
        plain_ms=cuda_ms(torch, lambda: fa.plain(q, k, v), 3),
        library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 20),
        bound=bound(es * (2 * q.numel() + 2 * k.numel()) + 4 * B * Hq * S,
                    4 * B * Hq * D * pairs, "bfloat16"))

    # the training path's micro-batch: correctness against the plain version,
    # with SDPA's own error against the same plain output beside the kernel's
    B, S, Hq, Hkv, D = 2, 2048, 32, 4, 128
    q, k, v = (randn(*shape, dtype=torch.bfloat16)
               for shape in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    want = fa.plain(q, k, v)
    name = f"training shape q={[B, S, Hq, D]} kv_heads={Hkv} bfloat16 causal"
    got = fa.flash_attention_fwd_cuda(q, k, v)
    err = check_case(torch, name, got, want, failures, bf16_rel=BF16_FWD_TOL)
    want_r = fa.plain(q, k, v, round_p=True)[0]
    check_rows(torch, name, got[0], want_r, failures)
    # control: a kernel whose last V tile had one of its two 64-column TMA
    # boxes from the previous ring stage must fail the row check; the line
    # also gives its error against the scale-wide 2e-2 limit, for comparison
    v_bad = v.clone()
    v_bad[:, S - 64:, :, 64:] = v[:, S - 128:S - 64, :, 64:]
    bad = fa.plain(q, k, v_bad, round_p=True)[0]
    r_bad = row_ulps(torch, bad, want_r)
    bad_err = (bad.float() - want_r.float()).abs().max().item()
    scale_tol = BF16_FWD_TOL * max(1.0, want[0].float().abs().max().item())
    say(f"  control (the last V tile's second 64-column box from the previous stage): worst "
        f"row {r_bad:.1f} bf16 ulps of its scale, limit {K3_ROW_ULPS}: "
        f"{'rejected' if r_bad > K3_ROW_ULPS else 'NOT REJECTED'}; max abs err {bad_err:.3e}, "
        f"{bad_err / scale_tol:.2f}x the {BF16_FWD_TOL:g}-of-scale limit {scale_tol:.3e}")
    if r_bad <= K3_ROW_ULPS:
        failures.append("K3: the row check did not reject its control")
    del got, v_bad, bad
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    lib = sdpa().transpose(1, 2)
    sdpa_err = (lib.float() - want[0].float()).abs().max().item()
    say(f"  training shape: max abs err of out against the plain version: kernel {err:.3e}, "
        f"SDPA {sdpa_err:.3e} (output scale {want[0].float().abs().max().item():.3f}); SDPA "
        f"against the plain version with p rounded: worst row "
        f"{row_ulps(torch, lib, want_r):.2f} bf16 ulps of its scale")
    del want, want_r, lib
    pairs = B * Hq * S * (S + 1) // 2
    k3_train_ms = cuda_ms(torch, lambda: fa.flash_attention_fwd_cuda(q, k, v), 20)
    sdpa_fwd_ms = cuda_ms(torch, sdpa, 20)
    k3_bound = bound(2 * (2 * q.numel() + 2 * k.numel()) + 4 * B * Hq * S,
                     4 * D * pairs, "bfloat16")
    say(f"  time flash_attention_fwd at the training shape q [{B}, {S}, {Hq}, {D}] bf16 "
        f"causal: kernel_ms={k3_train_ms:.4f} library_ms={sdpa_fwd_ms:.4f} bound_ms="
        f"{k3_bound[0]:.4f} ({k3_bound[1]}); {4 * D * pairs / k3_train_ms / 1e9:.1f} TFLOP/s, "
        f"{k3_train_ms / sdpa_fwd_ms:.2f}x SDPA")
    del q, k, v, qt, kt, vt

    # -- K7 paged decode: 8 slots, 32 q / 4 KV heads, hd 128, 16-token blocks, 2048+1 pool
    say(f"K7 paged_attention_decode ({pa.KEYS_PER_SPLIT}-key splits merged in one launch; "
        "fp32 tol 1e-4, bf16 tol one ulp; ctx == 0 rows exactly zero; two calls bitwise equal)")
    main = None
    for R, Hq, Hkv, D, bs, dtype, kw, ctx in [
            (8, 32, 4, 128, 16, torch.bfloat16, {}, [577, 65, 301, 512, 130, 449, 96, 260]),
            (8, 32, 4, 128, 16, torch.float32, {}, [577, 65, 301, 512, 130, 449, 96, 260]),
            (6, 32, 4, 128, 16, torch.bfloat16, {}, [0, 1, 17, 0, 333, 5]),        # idle rows
            (5, 32, 4, 128, 8, torch.bfloat16, {}, [9, 23, 57, 101, 287]),         # odd, bs 8
            (4, 16, 8, 256, 16, torch.bfloat16, dict(window=100, softcap=50.0), [31, 150, 400, 513]),
            (4, 8, 1, 256, 16, torch.float32, {}, [40, 257, 3, 199]),              # MQA, hd 256
            (3, 48, 1, 128, 16, torch.bfloat16, {}, [70, 300, 16]),                # rep 48
            (4, 8, 2, 64, 16, torch.float32, dict(window=20), [1, 44, 90, 210]),
            # long contexts (up to 128 splits), a context shorter than one
            # split, idle rows; with and without window and softcap
            (4, 32, 4, 128, 16, torch.bfloat16, {}, [8191, 4096, 0, 40]),
            (3, 32, 4, 128, 16, torch.float32, {}, [4096, 63, 0]),
            (5, 32, 4, 128, 16, torch.bfloat16, dict(window=1000, softcap=50.0),
             [8191, 2000, 64, 65, 0])]:
        maxb = -(-max(ctx) // bs) + 1
        N = max(2049, R * maxb + 1)
        qd = randn(R, Hq, D, dtype=dtype)
        kp, vp = randn(N, Hkv, bs, D, dtype=dtype), randn(N, Hkv, bs, D, dtype=dtype)
        perm = torch.randperm(N - 1, generator=g, device=dev)[:R * maxb]
        bt = perm.view(R, maxb).to(torch.int32).contiguous()
        cl = torch.tensor(ctx, dtype=torch.int32, device=dev)
        got = pa.paged_attention_cuda(qd, kp, vp, bt, cl, **kw)
        err = check_case(torch, f"R={R} q_heads={Hq} kv_heads={Hkv} D={D} bs={bs} "
                         f"{str(dtype)[6:]} {kw} ctx={ctx}", got,
                         pa.plain(qd, kp, vp, bt, cl, **kw), failures)
        if any(c == 0 for c in ctx) and not bool((got[cl == 0] == 0).all()):
            failures.append("paged: ctx == 0 rows are not zero")
        if not torch.equal(got, pa.paged_attention_cuda(qd, kp, vp, bt, cl, **kw)):
            failures.append(f"paged: two calls differ, ctx={ctx}")
        main = main or (err,)
    rows["paged_attention_decode"] = dict(
        paged_times(torch, configs.get_config("yi-6b"), "the phase-2 shape"),
        shape="q [8, 32, 128] pools [2049, 4, 16, 128] bf16, ctx "
              "[577, 65, 301, 512, 130, 449, 96, 260]",
        max_abs_err=main[-1])
    # -- K2 RMSNorm backward: training rows mb*S = 2*2048, d_model 4096
    say("K2 rmsnorm_bwd (dx and dscale; fp32 tol 1e-4 of the output scale, bf16 one ulp)")
    main = None
    for rows_, D, dtype, p1 in [(4096, 4096, torch.bfloat16, False),
                                (4096, 4096, torch.float32, False),
                                (8, 4096, torch.bfloat16, False),
                                (37, 3584, torch.bfloat16, True),
                                (5, 2048, torch.float32, True)]:
        x, dy, s = randn(rows_, D, dtype=dtype), randn(rows_, D, dtype=dtype), randn(D)
        err = check_case(torch, f"rows={rows_} D={D} {str(dtype)[6:]} plus_one={p1}",
                         rn.rmsnorm_bwd_cuda(x, s, dy, plus_one=p1),
                         rn.plain_bwd(x, s, dy, plus_one=p1), failures,
                         parts=(" [dx]", " [dscale]"), rel=True)
        main = main or (x, dy, s, err)
    x, dy, s, err = main
    xr, sr = x.detach().requires_grad_(), s.to(x.dtype).requires_grad_()

    def lib_fwd():
        return F.rms_norm(xr, (x.shape[1],), sr, 1e-6)

    def lib_fwd_bwd():
        torch.autograd.grad(lib_fwd(), [xr, sr], dy)

    def k2():
        rn.rmsnorm_bwd_cuda(x, s, dy)

    es = x.element_size()
    # K2 and its library call timed in turns (K2, library, ..., library, K2),
    # each reading the mean of 200 calls, the medians kept: launched back to
    # back from Python, and as CUDA graphs of 50 calls, whose replays carry
    # no host cost, so that the device's time is told from the host's
    # (K2's graph holds its wrapper's two launches: K2 and the sum of its
    # dscale partials)
    turns = in_turns(torch, {
        "k2": (k2, 1), "lib_fwd_bwd": (lib_fwd_bwd, 1), "lib_fwd": (lib_fwd, 1),
        "k2_graph": (graphed(torch, k2), 50),
        "lib_fwd_bwd_graph": (graphed(torch, lib_fwd_bwd), 50),
        "lib_fwd_graph": (graphed(torch, lib_fwd), 50)}, 200, rounds=5)
    med = {k: sorted(v)[len(v) // 2] for k, v in turns.items()}
    k2_bound = bound(3 * x.numel() * es + 8 * x.shape[1], 10 * x.numel(), "bfloat16")
    for what, sfx in (("back to back", ""), ("device time (graphs)", "_graph")):
        k2_ms = turns["k2" + sfx]
        say(f"  K2 in turns with its library call, {what}, {len(k2_ms)} readings each: K2 ms "
            f"min {min(k2_ms):.4f} median {med['k2' + sfx]:.4f} max {max(k2_ms):.4f} "
            f"({100 * k2_bound[0] / med['k2' + sfx]:.0f}% of its bound {k2_bound[0]:.4f}); "
            f"library (backward less forward) median "
            f"{med['lib_fwd_bwd' + sfx] - med['lib_fwd' + sfx]:.4f}")
    rows["rmsnorm_bwd"] = dict(
        shape=f"x, dy [{x.shape[0]}, {x.shape[1]}] bf16", max_abs_err=err, ms=med["k2"],
        device_ms=med["k2_graph"],
        plain_ms=cuda_ms(torch, lambda: rn.plain_bwd(x, s, dy), 20),
        library_ms=med["lib_fwd_bwd"] - med["lib_fwd"], bound=k2_bound)

    # -- K4/K5 flash backward: training micro-batch 2 x 2048, 32 q heads, 4 KV heads
    say("K4 flash_attention_bwd_dq (dq, delta) and K5 flash_attention_bwd_dkv (dk, dv), "
        "fed the K3 forward's out and lse; fp32 outputs (delta included) tol 1e-4 of the "
        "output scale; bf16 on the tensor cores (K4 and K5 at every head dim) "
        f"{BF16_BWD_TOL:g} of the output scale (at least 1), their products taking p and ds "
        f"rounded to bf16, and K4's every dq row within {K4_ROW_ULPS} bf16 ulps of its scale "
        "of the plain version with ds rounded to bf16")
    main = None
    for (B, S, Hq, Hkv, D), dtype, kw in [
            ((2, 2048, 32, 4, 128), torch.bfloat16, dict(causal=True)),
            ((1, 1024, 32, 4, 128), torch.float32, dict(causal=True)),
            ((2, 512, 32, 4, 128), torch.bfloat16, dict(causal=True, window=128, softcap=50.0)),
            ((2, 300, 16, 1, 128), torch.bfloat16, dict(causal=True)),            # MQA, ragged
            ((3, 77, 8, 2, 128), torch.float32, dict(causal=True, kv_len=70)),
            ((2, 300, 8, 2, 64), torch.bfloat16, dict(causal=True, window=40)),
            ((2, 256, 8, 4, 256), torch.bfloat16, dict(causal=True, window=64, softcap=50.0)),
            ((2, 50, 4, 2, 64), torch.float32, dict(causal=False, kv_len=41))]:
        q, k, v = randn(B, S, Hq, D, dtype=dtype), randn(B, S, Hkv, D, dtype=dtype), \
            randn(B, S, Hkv, D, dtype=dtype)
        do = randn(B, S, Hq, D, dtype=dtype)
        out, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
        name = f"q={[B, S, Hq, D]} kv_heads={Hkv} {str(dtype)[6:]} {kw}"
        # bf16 runs the tensor-core instances of K4 and K5 at every head dim
        bf16 = dtype == torch.bfloat16
        dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, out, lse, do, **kw)
        dq_p, delta_p = fa.plain_bwd_dq(q, k, v, out, lse, do, **kw)
        err4 = check_case(torch, "K4 " + name, (dq, delta), (dq_p, delta_p), failures,
                          parts=(" [dq]", " [delta]"), rel=True,
                          bf16_rel=BF16_BWD_TOL if bf16 else 0.0)
        if bf16:
            check_dq_rows(torch, "K4 " + name, dq, q, k, v, out, lse, do, kw, failures)
        got = fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
        want = fa.plain_bwd_dkv(q, k, v, do, lse, delta_p, **kw)
        err5 = check_case(torch, "K5 " + name, got, want, failures,
                          parts=(" [dk]", " [dv]"), rel=True,
                          bf16_rel=BF16_BWD_TOL if bf16 else 0.0)
        main = main or (q, k, v, do, out, lse, delta, err4, err5, (dq_p, *want))
        del out, lse, dq, delta, dq_p, delta_p, got, want
    q, k, v, do, out, lse, delta, err4, err5, plain_grads = main
    B, S, Hq, D = q.shape
    es = q.element_size()
    pairs = B * Hq * S * (S + 1) // 2                       # causal, live (q, k) pairs
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), [qt, kt, vt], dot)

    sdpa_bwd_ms = cuda_ms(torch, sdpa_fwd_bwd, 10) - cuda_ms(torch, sdpa, 10)
    # the library rounds as the kernels do: SDPA's bf16 gradients against the
    # same fp32-internal plain version
    sdpa_grads = [t.transpose(1, 2) for t in torch.autograd.grad(sdpa(), [qt, kt, vt], dot)]
    sdpa_errs = [(a.float() - w.float()).abs().max().item()
                 for a, w in zip(sdpa_grads, plain_grads)]
    say(f"  training shape q [{B}, {S}, {Hq}, {D}] bf16 causal, max abs err against the plain "
        f"version (dq, dk, dv): SDPA's backward {[f'{e:.3e}' for e in sdpa_errs]}, K4/K5 "
        f"(dq, delta) {err4:.3e}, (dk, dv) {err5:.3e}; output scales "
        f"{[round(w.float().abs().max().item(), 3) for w in plain_grads]}")
    del sdpa_grads, plain_grads
    shape = (f"q [{B}, {S}, {Hq}, {D}] k/v [{B}, {S}, {k.shape[2]}, {D}] bf16 causal; "
             f"library: SDPA's backward, dq, dk and dv together")
    rows["flash_attention_bwd_dq"] = dict(
        shape=shape, max_abs_err=err4,
        ms=cuda_ms(torch, lambda: fa.flash_attention_bwd_dq_cuda(q, k, v, out, lse, do), 20),
        plain_ms=cuda_ms(torch, lambda: fa.plain_bwd_dq(q, k, v, out, lse, do), 2),
        library_ms=sdpa_bwd_ms,
        bound=bound(es * (4 * q.numel() + 2 * k.numel()) + 8 * B * Hq * S,
                    6 * D * pairs, "bfloat16"))
    rows["flash_attention_bwd_dkv"] = dict(
        shape=shape, max_abs_err=err5,
        ms=cuda_ms(torch, lambda: fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta), 20),
        plain_ms=cuda_ms(torch, lambda: fa.plain_bwd_dkv(q, k, v, do, lse, delta), 2),
        library_ms=sdpa_bwd_ms,
        bound=bound(es * (2 * q.numel() + 4 * k.numel()) + 8 * B * Hq * S,
                    8 * D * pairs, "bfloat16"))
    bwd_ms = rows["flash_attention_bwd_dq"]["ms"] + rows["flash_attention_bwd_dkv"]["ms"]
    say(f"  time K4 + K5 at the training shape: {bwd_ms:.4f} ms, {bwd_ms / sdpa_bwd_ms:.2f}x "
        f"SDPA's backward ({sdpa_bwd_ms:.4f} ms)")
    del main, q, k, v, do, out, lse, delta, qt, kt, vt, dot
    torch.cuda.empty_cache()

    # -- K3-K5 at head dim 112 (zamba2-7b's shared attention)
    for name, r in hd112_checks(torch, F, failures).items():
        rows[name]["hd112"] = r
    torch.cuda.empty_cache()

    # -- K3-K5 at head dim 256 (gemma-2b's and gemma2-9b's training shapes)
    for key, by_kernel in hd256_checks(torch, F, failures).items():
        for name, r in by_kernel.items():
            rows[name][key] = r
    torch.cuda.empty_cache()

    # -- K3-K5 in fp32 (the CUDA-core kernels) at the training shape, beside
    # SDPA in fp32 and the bound at the fp32 rate
    say("K3-K5 in fp32 at the training shape (the CUDA-core kernels; fp32 tolerances)")
    errs = {}
    yi = configs.get_config("yi-6b")
    failures += shape_checks(torch, yi, 2, 2048, "training shape", dtype=torch.float32,
                             errs=errs)
    for name, r in attention_times(torch, F, yi, 2, 2048, errs, "the training shape",
                                   dtype=torch.float32).items():
        rows[name]["fp32"] = r
    torch.cuda.empty_cache()

    # -- K6 AdamW: the largest storage leaf of the 8-layer Yi-6B, the stacked w_up
    say(f"K6 adamw (in place; fp32 outputs element by element within {K6_ATOL:g} + "
        f"{K6_RTOL:g} |plain|, bf16 moments one ulp of their scale)")
    hyper = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)
    sc = torch.tensor([3e-3, 1 - 0.9 ** 3, 1 - 0.95 ** 3, 0.7], device=dev)
    main = None
    for shape, mdt in [((8, 1, 1, 4096 * 11008), torch.float32),
                       ((3, 1, 1, 4099), torch.bfloat16),
                       ((1, 1, 1000003), torch.bfloat16),
                       ((5,), torch.float32)]:
        p_, g_ = randn(*shape), randn(*shape) * 0.3
        m_, v_ = (randn(*shape) * 0.1).to(mdt), (randn(*shape) * 0.01).square().to(mdt)
        want = aw.plain(p_, m_, v_, g_, sc, **hyper)
        got = [t.clone() for t in (p_, m_, v_)]
        aw.adamw_cuda(*got, g_, sc, **hyper)
        err = check_case(torch, f"leaf {list(shape)} moments {str(mdt)[6:]}", tuple(got),
                         want, failures, parts=(" [p]", " [m]", " [v]"),
                         fp32_elem=(K6_RTOL, K6_ATOL))
        main = main or (p_, m_, v_, g_, err)
        del got, want
    p_, m_, v_, g_, err = main
    # control: an update that dropped the second moment's bias correction
    # must fail the same check
    sc_bad = sc.clone()
    sc_bad[2] = 1.0
    want_p = aw.plain(p_, m_, v_, g_, sc, **hyper)[0]
    bad_p = aw.plain(p_, m_, v_, g_, sc_bad, **hyper)[0]
    r_bad = elem_ratio(torch, bad_p, want_p, K6_RTOL, K6_ATOL)
    say(f"  control (1 - b2^t taken as 1): worst |err| / ({K6_ATOL:g} + {K6_RTOL:g} |plain|) "
        f"on p {r_bad:.3g}, {'rejected' if r_bad > 1 else 'NOT REJECTED'}")
    if not r_bad > 1:
        failures.append("K6: the elementwise check did not reject its control")
    del want_p, bad_p
    n = p_.numel()
    lib_ms = None
    try:
        steps_ = [torch.tensor(3.0, device=dev)]
        lib_ms = cuda_ms(torch, lambda: torch._fused_adamw_(
            [p_], [g_], [m_], [v_], [], steps_, lr=3e-3, beta1=0.9, beta2=0.95,
            weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False), 20)
    except (RuntimeError, TypeError) as e:   # the yardstick only; say why it is missing
        say(f"  torch._fused_adamw_ not timed: {type(e).__name__}: {e}")
    rows["adamw"] = dict(
        shape=f"stacked w_up leaf [8, 1, 1, {4096 * 11008}] fp32, fp32 moments",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: aw.adamw_cuda(p_, m_, v_, g_, sc, **hyper), 20),
        plain_ms=cuda_ms(torch, lambda: aw.plain(p_, m_, v_, g_, sc, **hyper), 5),
        library_ms=lib_ms, bound=bound(28 * n, 15 * n, "float32"))
    del main, p_, m_, v_, g_
    torch.cuda.empty_cache()

    for name, r in rows.items():
        say(f"  time {name} at {r['shape']}: kernel_ms={r['ms']:.4f} plain_ms="
            f"{r['plain_ms']:.4f} library_ms={r['library_ms']} bound_ms="
            f"{r['bound'][0]:.4f} ({r['bound'][1]})")
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: {failures}")
    return rows


# ---------------------------------------------------------------------------
# Phase 3: card against CPU at full width
# ---------------------------------------------------------------------------
def phase_parity(torch, np):
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.serving import steps
    from repro_torch.serving.cache import PagedCacheConfig, init_paged_cache

    cfg = dataclasses.replace(configs.get_config("yi-6b"), num_layers=2, dtype="float32")
    params = {"cpu": T.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")}
    params["cuda"] = T.to_device(params["cpu"], "cuda")
    lens = [256, 131, 77]
    bs, maxb = 16, 17
    rng = np.random.default_rng(SEED)
    toks = np.zeros((3, 256), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    tables = np.arange(3 * maxb, dtype=np.int32).reshape(3, maxb)
    pcfg = PagedCacheConfig(num_blocks=3 * maxb, block_size=bs, max_blocks_per_seq=maxb)
    logits, tokens = {}, {}
    for dev in ("cpu", "cuda"):
        t = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)  # noqa: E731
        cache = init_paged_cache(cfg, pcfg, dev)
        lg, cache = steps.paged_prefill_step(cfg, params[dev], cache,
                                             {"tokens": t(toks), "lens": t(lens)}, t(tables))
        logits[dev], tokens[dev] = [lg.cpu()], [lg.argmax(-1).cpu()]
        cur = t(lens)
        for _ in range(4):
            lg, cache = steps.paged_decode_step(cfg, params[dev], cache, t(tables), cur,
                                                tokens[dev][-1].to(dev).int())
            cur = cur + 1
            logits[dev].append(lg.cpu())
            tokens[dev].append(lg.argmax(-1).cpu())
    ref = torch.stack(logits["cpu"])
    err = (torch.stack(logits["cuda"]) - ref).abs().max().item()
    tol = 1e-3 * max(1.0, ref.abs().max().item())
    same = all(bool((a == b).all()) for a, b in zip(tokens["cpu"], tokens["cuda"]))
    finite = bool(torch.isfinite(torch.stack(logits["cuda"])).all())
    say(f"  Yi-6B width 4096, 2 layers, fp32, prompts {lens}, prefill + 4 decode steps: "
        f"logits max_abs_err={err:.3e} tol={tol:.3e} (1e-3 of the logit scale; cuBLAS "
        f"vs CPU BLAS and kernel vs plain differ in summation order) greedy_tokens_equal="
        f"{same} tokens={[t.tolist() for t in tokens['cuda']]}")
    if not (err <= tol and same and finite):
        raise AssertionError("card and CPU disagree at full width")
    return err


def phase_train_parity(torch):
    """One layered, partitioned train step of Yi-6B at full width (2 layers,
    fp32, M = 2 micro-batches of 1 x 128 tokens) on the card and on the CPU
    from the same weights."""
    from repro_torch import configs, tree
    from repro_torch.core import stepfn
    from repro_torch.core.accumulation import AccumConfig
    from repro_torch.data.synthetic import DataConfig, make_batch
    from repro_torch.optim.adam import AdamConfig, adam_init

    cfg = dataclasses.replace(configs.get_config("yi-6b"), num_layers=2, dtype="float32")
    opt_cfg = AdamConfig(lr=1e-3, warmup_steps=1, decay_steps=4)
    step = stepfn.build_train_step(cfg, AccumConfig("layered", True, 2), opt_cfg)
    batch = make_batch(DataConfig(cfg.vocab_size, 128, 2, 2, seed=SEED), 0)
    state = {"cpu": stepfn.init_storage(cfg, SEED, partitioned=True, device="cpu")}
    state["cuda"] = tree.tree_map(lambda t: t.to("cuda", copy=True), state["cpu"])
    out = {}
    for dev in ("cpu", "cuda"):
        storage = state.pop(dev)
        opt = adam_init(storage)
        storage, opt, m = step(storage, opt, batch)
        out[dev] = dict(loss=m["loss"].item(), gnorm=m["grad_norm"].item(), lr=m["lr"].item(),
                        p=tree.leaves_with_path(storage), mu=tree.leaves(opt["mu"]),
                        nu=tree.leaves(opt["nu"]))
        del storage, opt
    c, g = out["cpu"], out["cuda"]
    problems, worst = [], {}
    if not (math.isfinite(g["loss"]) and abs(g["loss"] - c["loss"]) <= 1e-5 * abs(c["loss"])
            and abs(g["gnorm"] - c["gnorm"]) <= 1e-4 * abs(c["gnorm"])):
        problems.append(f"loss {g['loss']} vs {c['loss']}, grad norm {g['gnorm']} vs {c['gnorm']}")
    lr = c["lr"]

    def ratio(mu, nu):
        # Adam's first step: m/(1-b1) and v/(1-b2) are the clipped g and g^2
        return (mu / (1 - opt_cfg.b1)) / (torch.sqrt(nu / (1 - opt_cfg.b2)) + opt_cfg.eps)

    for i, ((path, p_g), (_, p_c)) in enumerate(zip(g["p"], c["p"])):
        name = ".".join(path)
        for kind, a, b in (("mu", g["mu"][i].cpu(), c["mu"][i]), ("nu", g["nu"][i].cpu(), c["nu"][i])):
            # (1 - b1) g and (1 - b2) g^2: fp32 sums of thousands of products
            # taken in another order
            d = (a - b).abs().max().item()
            worst[kind] = max(worst.get(kind, 0.0), d)
            if d > 1e-4 * b.abs().max().item() + 1e-12:
                problems.append(f"{kind} {name} max diff {d:.3e}")
        # the weights: Adam's update lr * g / (|g| + eps) amplifies a gradient
        # difference of d by up to lr * d / eps near g = 0, so the weights must
        # differ by exactly what each side's own moments predict, to fp32 noise
        pred = -lr * (ratio(g["mu"][i].cpu(), g["nu"][i].cpu()) - ratio(c["mu"][i], c["nu"][i]))
        resid = ((p_g.cpu() - p_c) - pred).abs()
        worst["p"] = max(worst.get("p", 0.0), (p_g.cpu() - p_c).abs().max().item())
        worst["p - predicted"] = max(worst.get("p - predicted", 0.0), resid.max().item())
        if bool((resid > 1e-6 + 1e-5 * p_c.abs()).any()):
            problems.append(f"p {name} off its predicted update by {resid.max().item():.3e}")
    say(f"  Yi-6B width 4096, 2 layers, fp32, one layered partitioned step, M=2 x 128 "
        f"tokens: loss card {g['loss']:.6f} cpu {c['loss']:.6f}, grad norm card "
        f"{g['gnorm']:.6f} cpu {c['gnorm']:.6f}; max abs diff of the updated leaves {worst} "
        f"(tol: loss 1e-5 and grad norm 1e-4 relative; moments 1e-4 of each leaf's scale; "
        f"weights 1e-6 + 1e-5 relative off the update each side's moments predict)")
    if problems:
        raise AssertionError("train step: card and CPU disagree: " + "; ".join(problems))


# ---------------------------------------------------------------------------
# Phase 4: the full model through the serving engine
# ---------------------------------------------------------------------------
def warm_engine(cfg, params) -> None:
    """One short request through an engine on a small pool (cuBLAS handles,
    the allocator) before a counted run."""
    from repro_torch.serving.cache import PagedCacheConfig
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import Request, SchedulerConfig
    warm = ServingEngine(cfg, params, SchedulerConfig(
        cache=PagedCacheConfig(num_blocks=64, block_size=16, max_blocks_per_seq=8),
        max_batch=2))
    warm.submit(Request(rid=0, prompt=tuple(range(1, 65)), max_new_tokens=4))
    warm.run()


@contextlib.contextmanager
def finite_logits(torch):
    """Inside the block every paged prefill and decode call's logits are
    checked finite on the card; yields the list of those checks, read once
    at the end."""
    from repro_torch.serving import steps
    finite = []
    wrapped = {n: getattr(steps, n) for n in ("paged_prefill_step", "paged_decode_step")}

    def probe(fn):
        def step(*a, **kw):
            logits, cache = fn(*a, **kw)
            finite.append(torch.isfinite(logits).all())
            return logits, cache
        return step

    for n, fn in wrapped.items():
        setattr(steps, n, probe(fn))
    try:
        yield finite
    finally:
        for n, fn in wrapped.items():
            setattr(steps, n, fn)


def phase_engine(torch, np, smi):
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models import transformer as T
    from repro_torch.serving.cache import PagedCacheConfig
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import SchedulerConfig, poisson_trace

    cfg = configs.get_config("yi-6b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for _, p in T.named_parameters(params))
    say(f"  Yi-6B: {cfg.num_layers} layers, d_model {cfg.d_model}, {n_params / 1e9:.3f} B "
        f"parameters in bf16, made on the card in {time.perf_counter() - t0:.1f} s")

    warm_engine(cfg, params)

    reqs = poisson_trace(np.random.default_rng(SEED), n_requests=16, rate=0.5,
                         vocab=cfg.vocab_size,
                         prompt_lens=[64, 512, 128, 320, 256, 96, 448, 200],
                         max_new=[32, 48, 64])
    pcfg = PagedCacheConfig(num_blocks=2048, block_size=16, max_blocks_per_seq=36)
    eng = ServingEngine(cfg, params, SchedulerConfig(cache=pcfg, max_batch=8))
    eng.submit_all(reqs)
    with finite_logits(torch) as finite:
        torch.cuda.synchronize()
        rn.launches = fa.launches = pa.launches = 0
        t0 = time.perf_counter()
        out = eng.run(max_steps=2000)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {"rmsnorm": rn.launches, "flash_attention_fwd": fa.launches,
                  "paged_attention_decode": pa.launches}
    st = eng.stats
    want = {"rmsnorm": (2 * cfg.num_layers + 1) * (st["prefill_calls"] + st["decode_steps"]),
            "flash_attention_fwd": cfg.num_layers * st["prefill_calls"],
            "paged_attention_decode": cfg.num_layers * st["decode_steps"]}
    lat = eng.latency_summary()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    say(f"  engine on {smi}: {len(out)} requests, {st['emitted_tokens']} tokens, "
        f"{st['prefill_calls']} prefill calls, {st['decode_steps']} decode steps, "
        f"{st['preemptions']} preemptions in {dt:.3f} s -> {st['emitted_tokens'] / dt:.1f} tok/s; "
        f"TTFT ms p50 {lat['ttft_ms']['p50']:.2f} p99 {lat['ttft_ms']['p99']:.2f}; "
        f"ITL ms p50 {lat['itl_ms']['p50']:.2f} p99 {lat['itl_ms']['p99']:.2f}; "
        f"peak memory {peak_gb:.2f} GB")
    say(f"  launches {counts} expected {want}")
    say(f"  card after the run (SM clock, max SM clock, power, temperature, throttle "
        f"reasons): {smi_clocks()}")
    problems = []
    if sorted(out) != list(range(len(reqs))):
        problems.append("not every request finished")
    if any(len(out[r.rid]) != r.max_new_tokens for r in reqs):
        problems.append("a request stopped short of its budget")
    if any(not 0 <= t < cfg.vocab_size for toks in out.values() for t in toks):
        problems.append("token outside the vocabulary")
    if eng.sched.alloc.used != 0 or eng.sched.alloc.available != pcfg.num_blocks:
        problems.append("the allocator did not drain")
    if not bool(torch.stack(finite).all()):
        problems.append("non-finite logits")
    if counts != want:
        problems.append(f"launch counts {counts} != {want}")
    if problems:
        raise AssertionError("; ".join(problems))
    del eng
    try:
        phase_profile(torch, np, params)
    except Exception as e:  # noqa: BLE001 — the breakdown is optional; say why it is missing
        say(f"  profile: not measured ({type(e).__name__}: {e})")
    return counts


# ---------------------------------------------------------------------------
# Phase 4b: where a step's time goes (a measurement; it cannot fail the run)
# ---------------------------------------------------------------------------
def phase_profile(torch, np, params):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.serving import steps
    from repro_torch.serving.cache import PagedCacheConfig
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import Request, SchedulerConfig

    cfg = configs.get_config("yi-6b")
    rng = np.random.default_rng(SEED)
    eng = ServingEngine(cfg, params, SchedulerConfig(
        cache=PagedCacheConfig(num_blocks=512, block_size=16, max_blocks_per_seq=36),
        max_batch=8))
    eng.submit_all([Request(rid=i, prompt=tuple(int(t) for t in rng.integers(0, 64000, 256)),
                            max_new_tokens=40) for i in range(8)])
    eng.step()                                        # prefill of all 8, first decode
    eng.step()

    def window(label, fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            n = fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        dev_us = sum(e.self_device_time_total for e in kern)
        groups = {"port kernels": 0.0, "gemm": 0.0, "other": 0.0}
        for e in kern:
            name = e.key.lower()
            if any(k in name for k in ("rmsnorm_kernel", "flash_fwd_kernel",
                                       "paged_decode_kernel")):
                groups["port kernels"] += e.self_device_time_total
            elif any(k in name for k in ("gemm", "xmma", "cutlass", "nvjet", "gemv")):
                groups["gemm"] += e.self_device_time_total
            else:
                groups["other"] += e.self_device_time_total
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
        say(f"  profile {label}: wall {wall_us / n / 1e3:.3f} ms per call, device busy "
            f"{dev_us / n / 1e3:.3f} ms ({100 * dev_us / wall_us:.1f}% of wall, idle "
            f"{100 - 100 * dev_us / wall_us:.1f}%), kernel launches {sum(e.count for e in kern) // n} "
            f"per call; device ms per call by group "
            f"{ {k: round(v / n / 1e3, 3) for k, v in groups.items()} }")
        for e in top:
            say(f"    {e.self_device_time_total / n / 1e3:8.3f} ms x{e.count // n:<4d} {e.key[:90]}")

    def decode_steps():
        for _ in range(10):
            eng.step()
        return 10

    toks = torch.from_numpy(rng.integers(0, 64000, (4, 512)).astype(np.int32)).cuda()
    lens = torch.full((4,), 512, dtype=torch.int32, device="cuda")
    tables = torch.arange(4 * 36, dtype=torch.int32, device="cuda").view(4, 36)

    def prefill():
        steps.paged_prefill_step(cfg, params, eng.cache, {"tokens": toks, "lens": lens}, tables)
        return 1

    prefill()                                         # warm this bucket
    window("decode step, 8 slots, contexts ~260", decode_steps)
    window("prefill call, 4 x 512 tokens", prefill)


# ---------------------------------------------------------------------------
# Phase 5: training at full width through the entry point
# ---------------------------------------------------------------------------
TRAIN_LAYERS, TRAIN_MB, TRAIN_STEPS = 8, 4, 5
TRAIN_ARGV = ["--arch", "yi-6b", "--layers", str(TRAIN_LAYERS), "--global-batch", "8",
              "--seq-len", "2048", "--microbatches", str(TRAIN_MB), "--steps",
              str(TRAIN_STEPS), "--lr", "3e-3", "--seed", str(SEED)]


def train_counters():
    """The training kernels' launch counters: name -> (module, attribute)."""
    from repro_torch.kernels import adamw as aw
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    return {"rmsnorm": (rn, "launches"), "rmsnorm_bwd": (rn, "bwd_launches"),
            "flash_attention_fwd": (fa, "launches"),
            "flash_attention_bwd_dq": (fa, "bwd_dq_launches"),
            "flash_attention_bwd_dkv": (fa, "bwd_dkv_launches"),
            "adamw": (aw, "launches")}


def reset_counts(counters) -> None:
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def read_counts(counters) -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}


def step_launches(L: int, M: int, adamw: int) -> dict:
    """K1-K6 launches of one step at L layers and M micro-batches, either
    accumulation method: the forward (2 norms, 1 attention per layer and
    micro-batch), the head (final norm forward and backward per micro-batch),
    the backward's recompute and its backward; ``adamw`` K6 launches."""
    return {"rmsnorm": 4 * L * M + M, "rmsnorm_bwd": 2 * L * M + M,
            "flash_attention_fwd": 2 * L * M, "flash_attention_bwd_dq": L * M,
            "flash_attention_bwd_dkv": L * M, "adamw": adamw}


# one layered step; AdamW (K6) once per storage leaf (9 stacked layer leaves,
# embed, head, final norm)
L_, M_ = TRAIN_LAYERS, TRAIN_MB
TRAIN_PER_STEP = step_launches(L_, M_, 12)


def phase_train(torch, smi):
    from repro_torch.launch import train

    L, M = TRAIN_LAYERS, TRAIN_MB
    counters = train_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts(counters)
    a0 = alloc_counts(torch)
    res = train.main(TRAIN_ARGV)
    torch.cuda.synchronize()
    res["alloc"] = {k: v - a0[k] for k, v in alloc_counts(torch).items()}
    counts = read_counts(counters)
    per_step = TRAIN_PER_STEP
    want = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    for r in res["records"]:
        say(f"  step {r['step']}: {r['step_time_s']:.3f} s, {r['tokens_per_s']:.0f} tok/s, "
            f"MFU {100 * r['mfu']:.2f}% of 989 TFLOP/s (6ND), loss {r['loss']:.4f}, "
            f"grad norm {r['grad_norm']:.4f}, max memory allocated {r['peak_mem_gb']:.2f} GB")
    steady = res["records"][1:]
    say(f"  training on {smi}: Yi-6B width 4096 cut to {L} layers, bf16 compute, fp32 state, "
        f"layered + partitioned, 8 x 2048 tokens in {M} micro-batches; steady steps "
        f"(after the first) mean {sum(r['step_time_s'] for r in steady) / len(steady):.3f} s, "
        f"{sum(r['tokens_per_s'] for r in steady) / len(steady):.0f} tok/s, MFU "
        f"{100 * sum(r['mfu'] for r in steady) / len(steady):.2f}%")
    say(f"  launches over {TRAIN_STEPS} steps {counts}; per step {per_step}")
    say(f"  card after the run (SM clock, max SM clock, power, temperature, throttle "
        f"reasons): {smi_clocks()}")
    problems = []
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in res["records"]):
        problems.append("non-finite loss or grad norm")
    if counts != want:
        problems.append(f"launch counts {counts} != {want}")
    if problems:
        raise AssertionError("; ".join(problems))
    try:
        res["profile"] = phase_train_profile(torch)
    except Exception as e:  # noqa: BLE001 — the breakdown is optional; say why it is missing
        say(f"  profile: not measured ({type(e).__name__}: {e})")
    return counts, res


def phase_train_profile(torch, axis=None, label="train step", acc=None):
    """Device time by group over one steady train step (after one warm-up
    step) at the phase's configuration (``acc``: phase 5's schedule unless
    given), on ``axis``'s groups when given."""
    from repro_torch import configs
    from repro_torch.core import dist, stepfn
    from repro_torch.core.accumulation import AccumConfig
    from repro_torch.data.synthetic import DataConfig, batch_for
    from repro_torch.optim.adam import AdamConfig, adam_init

    axis = axis or dist.LOCAL
    acc = acc or AccumConfig("layered", True, TRAIN_MB)
    cfg = dataclasses.replace(configs.get_config("yi-6b"), num_layers=TRAIN_LAYERS)
    step = stepfn.build_train_step(cfg, acc, AdamConfig(lr=3e-3, warmup_steps=1, decay_steps=5),
                                   axis=axis)
    storage = stepfn.init_storage(cfg, SEED, partitioned=acc.partitioned, device="cuda",
                                  axis=axis)
    opt = adam_init(storage)
    data = DataConfig(cfg.vocab_size, 2048, 8, acc.n_microbatches, seed=SEED)
    storage, opt, _ = step(storage, opt, batch_for(cfg, data, 0, axis))
    return profile_step(torch, step, storage, opt, batch_for(cfg, data, 1, axis), label)


def profile_step(torch, step, storage, opt, batch, label: str) -> dict:
    """Device time by group over one call of ``step`` (warmed up by the
    caller): kernel name -> (device ms, launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        storage, opt, m = step(storage, opt, batch)
        m["loss"].item()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kern)
    names = ("rmsnorm_kernel", "rmsnorm_bwd_kernel", "flash_fwd_kernel",
             "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel", "adamw_kernel")
    groups = dict.fromkeys((*names, "gemm", "nccl", "other"), 0.0)
    for e in kern:
        key = e.key.lower()
        hit = next((n for n in names if n in key), None)
        if hit is None and "nccl" in key:
            hit = "nccl"
        if hit is None:
            hit = "gemm" if any(k in key for k in ("gemm", "xmma", "cutlass", "nvjet",
                                                    "gemv")) else "other"
        groups[hit] += e.self_device_time_total
    say(f"  profile {label}: wall {wall_us / 1e3:.1f} ms, device busy {dev_us / 1e3:.1f} ms "
        f"({100 * dev_us / wall_us:.1f}% of wall, idle {100 - 100 * dev_us / wall_us:.1f}%), "
        f"kernel launches {sum(e.count for e in kern)}; device ms by group "
        f"{ {k: round(v / 1e3, 2) for k, v in groups.items()} }")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        say(f"    {e.self_device_time_total / 1e3:9.2f} ms x{e.count:<5d} {e.key[:90]}")
    host = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    say(f"  host ops of the {label} by self CPU time (ms, calls), of "
        f"{sum(e.self_cpu_time_total for e in host) / 1e3:.1f} ms in all:")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        say(f"    {e.self_cpu_time_total / 1e3:9.2f} ms x{e.count:<5d} {e.key[:90]}")
    return {e.key: (e.self_device_time_total / 1e3, e.count) for e in kern}


# ---------------------------------------------------------------------------
# Phase 6: the process-group path, and the fused per-layer update
# ---------------------------------------------------------------------------
# Yi-6B's leaves: ln1, ln2, wq, wk, wv, wo, w_gate, w_up, w_down in each layer;
# embed, head and the final norm outside
N_LAYER_LEAVES, N_OUTER_LEAVES = 9, 3
FUSED_STEPS = 3


@contextlib.contextmanager
def one_rank_launch():
    """The environment ``torch.distributed.run`` gives a group of one
    process (rank 0 of 1 on this host, a free port), removed on exit."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(port)}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


ALLOC_KEYS = ("num_alloc_retries", "num_sync_all_streams", "num_device_alloc",
              "num_device_free")


def alloc_counts(torch) -> dict:
    """The caching allocator's counters that mark a device synchronisation
    or a cudaMalloc / cudaFree (each stalls the host behind the device)."""
    st = torch.cuda.memory_stats()
    return {k: st.get(k, 0) for k in ALLOC_KEYS}


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def phase_group(torch, smi, phase5):
    """(a) phase 5's run again under a world-size-1 NCCL group: the same
    losses and grad norms, and exact per-step collective counts of both
    schedules; (b) the fused per-layer update against the classic step at
    grad_clip=0, and the classic step without a group: the same losses,
    9 L + 3 K6 launches a step, and the peak memories, host enqueue times
    and allocator counters of all three."""
    import torch.distributed as tdist

    from repro_torch import configs
    from repro_torch.core import dist, stepfn
    from repro_torch.core.accumulation import AccumConfig
    from repro_torch.data.synthetic import DataConfig, batch_for
    from repro_torch.launch import train
    from repro_torch.optim.adam import AdamConfig, adam_init

    L, M = TRAIN_LAYERS, TRAIN_MB
    counters = train_counters()
    problems = []
    total = dict.fromkeys(counters, 0)

    # (a) the layered schedule through the entry point, on a group of one
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    reset_counts(counters)
    a0 = alloc_counts(torch)
    with one_rank_launch():
        res = train.main(TRAIN_ARGV)
    torch.cuda.synchronize()
    alloc = {k: v - a0[k] for k, v in alloc_counts(torch).items()}
    counts = read_counts(counters)
    total = {k: total[k] + counts[k] for k in total}
    want_coll = {"data all_gather": 2 * N_LAYER_LEAVES * L + N_OUTER_LEAVES,
                 "data reduce_scatter": N_LAYER_LEAVES * L + N_OUTER_LEAVES}
    for r, r5 in zip(res["records"], phase5["records"]):
        coll = {k: r["collectives"].get(k, [0, 0])[0] for k in want_coll}
        say(f"  group of one, step {r['step']}: {r['step_time_s']:.3f} s (phase 5 "
            f"{r5['step_time_s']:.3f} s), loss {r['loss']:.6f} (rel diff "
            f"{rel(r['loss'], r5['loss']):.1e}), grad norm {r['grad_norm']:.6f} (rel diff "
            f"{rel(r['grad_norm'], r5['grad_norm']):.1e}); collectives [calls, bytes] "
            f"{r['collectives']}")
        if rel(r["loss"], r5["loss"]) > 1e-6 or rel(r["grad_norm"], r5["grad_norm"]) > 1e-6:
            problems.append(f"step {r['step']}: loss or grad norm differs from phase 5's")
        if coll != want_coll:
            problems.append(f"step {r['step']}: layered collectives {coll} != {want_coll}")
    mean = lambda recs: sum(r["step_time_s"] for r in recs[1:]) / (len(recs) - 1)  # noqa: E731
    t_grp, t_p5 = mean(res["records"]), mean(phase5["records"])
    say(f"  group of one on {smi}: steady step {t_grp:.4f} s against phase 5's {t_p5:.4f} s "
        f"({100 * (t_grp / t_p5 - 1):+.2f}%); launches {counts}; allocator over the run "
        f"{alloc} (phase 5's {phase5.get('alloc')})")
    if counts != {k: v * TRAIN_STEPS for k, v in TRAIN_PER_STEP.items()}:
        problems.append(f"group-of-one launch counts {counts}")

    # the standard schedule, one step: 3 collectives per layer leaf, layer
    # and micro-batch
    i = TRAIN_ARGV.index("--steps")
    argv = TRAIN_ARGV[:i + 1] + ["1"] + TRAIN_ARGV[i + 2:] + ["--method", "standard"]
    reset_counts(counters)
    with one_rank_launch():
        res_s = train.main(argv)
    torch.cuda.synchronize()
    counts = read_counts(counters)
    total = {k: total[k] + counts[k] for k in total}
    (r,) = res_s["records"]
    want_std = {k: v * M for k, v in want_coll.items()}
    coll = {k: r["collectives"].get(k, [0, 0])[0] for k in want_std}
    layer_coll = sum(coll.values()) - 2 * M * N_OUTER_LEAVES
    say(f"  standard schedule, one step: {r['step_time_s']:.3f} s, loss {r['loss']:.6f}; "
        f"data-group layer collectives {layer_coll} (3 x {N_LAYER_LEAVES} leaves x L {L} x "
        f"M {M} = {3 * N_LAYER_LEAVES * L * M}; layered {3 * N_LAYER_LEAVES * L}); "
        f"collectives {r['collectives']}")
    if coll != want_std or layer_coll != 3 * N_LAYER_LEAVES * L * M:
        problems.append(f"standard collectives {coll} != {want_std}")

    # (b) the fused per-layer update against the classic step, both on a
    # group of one, grad_clip=0
    cfg = dataclasses.replace(configs.get_config("yi-6b"), num_layers=L)
    acc = AccumConfig("layered", True, M)
    opt_cfg = AdamConfig(lr=3e-3, warmup_steps=1, decay_steps=FUSED_STEPS, grad_clip=0.0)
    data = DataConfig(cfg.vocab_size, 2048, 8, M, seed=SEED)
    out = {}
    with one_rank_launch():
        axis = dist.from_env(1, 1, torch.device("cuda"))
        try:
            try:
                prof = phase_train_profile(torch, axis, "train step on a group of one")
                base = phase5.get("profile", {})
                grew = sorted(((ms - base.get(k, (0.0, 0))[0], k, n, base.get(k, (0.0, 0)))
                               for k, (ms, n) in prof.items()), reverse=True)[:8]
                say("  kernels that take longer on the group of one than in phase 5's profile "
                    "(ms more, launches here / there):")
                for d, k, n, (_, n0) in grew:
                    say(f"    {d:+9.2f} ms x{n}/{n0} {k[:90]}")
            except Exception as e:  # noqa: BLE001 — the breakdown is optional
                say(f"  profile on a group of one: not measured ({type(e).__name__}: {e})")
            # the classic step without a group too: its host enqueue time
            # and memory, on the same card in the same process
            for name, build, ax in (("classic, no group", stepfn.build_train_step, dist.LOCAL),
                                    ("classic", stepfn.build_train_step, axis),
                                    ("fused", stepfn.build_fused_train_step, axis)):
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                reset_counts(counters)
                a0 = alloc_counts(torch)
                step = build(cfg, acc, opt_cfg, axis=ax)
                storage = stepfn.init_storage(cfg, SEED, partitioned=True, device="cuda",
                                              axis=ax)
                opt = adam_init(storage)
                losses, times, host = [], [], []
                for i in range(FUSED_STEPS):
                    batch = batch_for(cfg, data, i, ax)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    storage, opt, m = step(storage, opt, batch)
                    host.append(time.perf_counter() - t0)   # enqueued, not yet run
                    losses.append(m["loss"].item())
                    times.append(time.perf_counter() - t0)
                torch.cuda.synchronize()
                counts = read_counts(counters)
                total = {k: total[k] + counts[k] for k in total}
                out[name] = dict(losses=losses, times=times, host=host, counts=counts,
                                 peak=torch.cuda.max_memory_allocated() / 1e9,
                                 alloc={k: v - a0[k] for k, v in alloc_counts(torch).items()})
                del storage, opt, step
            # the host's cost of one collective call on the group of one (1024
            # fp32, so the device's share is nil): enqueue time over 200 calls
            x = torch.zeros(1024, device="cuda")
            big = torch.empty(1024, device="cuda")
            calls = {"all_reduce": lambda: axis.all_reduce(x, "model"),
                     "all_gather": lambda: axis.all_gather(big, x, "data"),
                     "reduce_scatter": lambda: axis.reduce_scatter(big, x, "data")}
            host_us = {}
            for op, fn in calls.items():
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    fn()
                host_us[op] = round((time.perf_counter() - t0) / 200 * 1e6, 1)
                torch.cuda.synchronize()
            say(f"  host time per collective call on the group of one (us, 200 calls "
                f"each): {host_us}")
        finally:
            tdist.destroy_process_group()
    c, f, n = out["classic"], out["fused"], out["classic, no group"]
    for name, o in out.items():
        say(f"  {name} step (grad_clip=0): losses "
            f"{[round(x, 6) for x in o['losses']]}, step times "
            f"{[round(t, 4) for t in o['times']]} s (host enqueue "
            f"{[round(t, 4) for t in o['host']]} s), max memory allocated {o['peak']:.2f} GB, "
            f"K6 launches {o['counts']['adamw']}, allocator {o['alloc']}")
    worst = max(rel(a, b) for a, b in zip(f["losses"], c["losses"]))
    if max(rel(a, b) for a, b in zip(n["losses"], c["losses"])) > 1e-6:
        problems.append(f"classic losses with a group {c['losses']} != without {n['losses']}")
    k6 = (N_LAYER_LEAVES * L + N_OUTER_LEAVES) * FUSED_STEPS
    say(f"  fused against classic on {smi}: losses max rel diff {worst:.1e} (tol 1e-6); peak "
        f"memory {f['peak']:.2f} GB against {c['peak']:.2f} GB; steady step "
        f"{sum(f['times'][1:]) / (FUSED_STEPS - 1):.4f} s against "
        f"{sum(c['times'][1:]) / (FUSED_STEPS - 1):.4f} s; K6 launches {f['counts']['adamw']} "
        f"(want {k6})")
    if worst > 1e-6:
        problems.append(f"fused losses {f['losses']} != classic {c['losses']}")
    if f["counts"]["adamw"] != k6 or c["counts"]["adamw"] != 12 * FUSED_STEPS \
            or n["counts"]["adamw"] != 12 * FUSED_STEPS:
        problems.append(f"K6 launches fused {f['counts']['adamw']} (want {k6}), classic "
                        f"{c['counts']['adamw']}")
    if problems:
        raise AssertionError("; ".join(problems))
    return total, t_grp, res["records"]


# ---------------------------------------------------------------------------
# Phase 7: the pipeline (one stage on a group of one)
# ---------------------------------------------------------------------------
# (label, schedule, split backward, steps, outer leaves through K6, later
# steps' loss and grad-norm tolerances against phase 5's).  The first two
# are the slice's path: K6 on the layer chunks and the tree-map AdamW on
# the outer leaves (JAX's fused=is_stacked_path).  The last two send every
# leaf through K6, as phase 5 does, to take the two causes of drift apart:
# "modular, all K6" keeps modular's reversed micro-batch order of the fp32
# gradient sums, "1f1b, all K6" has phase 5's order (at one stage 1f1b runs
# F(mb) B(mb) in turn) and reproduces phase 5 bit for bit.  The runs are
# deterministic; the grad-norm tolerances are about 2.5x the worst reading
# on the H100 (modular 2.1e-3, split 1.2e-3, modular all K6 3.2e-4), the
# loss ones the CPU tests' 2e-4 (readings 1.1e-4, 2.4e-5, 7.4e-5).
PIPE_RUNS = (("modular", "modular", False, TRAIN_STEPS, False, 2e-4, 5e-3),
             ("1f1b split", "1f1b", True, 3, False, 2e-4, 3e-3),
             ("modular, all K6", "modular", False, TRAIN_STEPS, True, 2e-4, 1e-3),
             ("1f1b, all K6", "1f1b", False, TRAIN_STEPS, True, 1e-6, 1e-6))
# step 0 against phase 5: the loss exactly, the grad norm to phase 6's 1e-6,
# and each leaf's gradient (relative L2) against the layered schedule's on
# the same weights and batch; modular's reversed fp32 sums differ by an ulp
PIPE_GNORM0_RTOL, PIPE_GRAD_RTOL = 1e-6, 1e-6


def layer_launches(cfg, l: int) -> tuple[int, int]:
    """(K1 calls, K3 calls) of global layer ``l``'s forward on one
    micro-batch, each with its backward in a backward pass: an attention
    layer's two norms and attention, a Mamba layer's one norm, none in RWKV
    (its block norms are plain), and after a flagged layer the shared
    block's two norms and attention; LayerNorm has no kernel."""
    flag = cfg.attn_layer_flags()[l]
    norms, attn = {"attn": (2, 1), "mamba": (1, 0), "rwkv": (0, 0)}[cfg.block_kind]
    norms, attn = norms + 2 * flag, attn + flag
    return (0 if cfg.norm == "layernorm" else norms), attn


def pipeline_launches(cfg, table, M: int, n_adamw: int) -> dict:
    """K1-K6 launches of one pipelined step at one stage from the table:
    every F, B, Bd and Bw unit runs its chunk's layers forward, B, Bd and Bw
    their backward too (``layer_launches``); the head runs the final norm
    and its backward once per micro-batch; K6 updates ``n_adamw`` leaves."""
    k_c = table.layers_per_chunk
    out = dict.fromkeys(("rmsnorm", "rmsnorm_bwd", "flash_attention_fwd",
                         "flash_attention_bwd_dq", "flash_attention_bwd_dkv"), 0)
    for t in range(table.n_ticks):
        kind, v = table.kind[t][0], table.unit_v[t][0]
        if kind == 0:
            continue
        for l in range(v * k_c, (v + 1) * k_c):
            n, a = layer_launches(cfg, l)
            out["rmsnorm"] += n
            out["flash_attention_fwd"] += a
            if kind != 1:
                out["rmsnorm_bwd"] += n
                out["flash_attention_bwd_dq"] += a
                out["flash_attention_bwd_dkv"] += a
    head = 0 if cfg.norm == "layernorm" else M
    out["rmsnorm"] += head
    out["rmsnorm_bwd"] += head
    return dict(out, adamw=n_adamw)


def on_card(batch: dict) -> dict:
    return {k: v.to("cuda", non_blocking=True) for k, v in batch.items()}


def pipeline_step(cfg, spec, opt_cfg, axis, all_k6: bool):
    """The pipelined train step; with ``all_k6`` its outer leaves go
    through K6 too (the layered step's update)."""
    from repro_torch.core import pipeline as pp
    from repro_torch.core import stepfn
    from repro_torch.optim.adam import adam_step

    if not all_k6:
        return stepfn.build_pipeline_train_step(cfg, spec, opt_cfg, partitioned=True, axis=axis)
    grad_fn = pp.make_pipeline_grad_fn(cfg, spec, stepfn.full_template(cfg), partitioned=True,
                                       axis=axis)
    reduce = stepfn.make_pipeline_sq_reduce(cfg, axis, True)

    def step(storage, opt, batch):
        grads, metrics = grad_fn(storage, on_card(batch))
        storage, opt, om = adam_step(opt_cfg, storage, opt, grads, sq_reduce=reduce,
                                     fused=True)
        return storage, opt, dict(metrics, **om)

    return step


def pipeline_grads_check(torch, cfg, axis, data, problems) -> None:
    """Step 0's gradient of every run's schedule against the layered
    schedule's (phase 5's ``grad_fn``) on the same weights and batch, leaf by
    leaf: at one stage the layouts map one to one."""
    from repro_torch import tree
    from repro_torch.core import pipeline as pp
    from repro_torch.core import stepfn
    from repro_torch.core.accumulation import AccumConfig, make_grad_fn
    from repro_torch.core.schedules import PipeSpec
    from repro_torch.data.synthetic import batch_for

    L, M = TRAIN_LAYERS, TRAIN_MB
    template = stepfn.full_template(cfg)
    batch = on_card(batch_for(cfg, data, 0, axis))
    st = stepfn.init_storage(cfg, SEED, partitioned=True, device="cuda", axis=axis)
    ref, ref_m = make_grad_fn(cfg, AccumConfig("layered", True, M), template, axis=axis)(st, batch)
    ref = dict(tree.leaves_with_path(ref))
    spec = PipeSpec(n_stages=1, layers_per_stage=L, n_microbatches=M)
    pst = stepfn.init_pipeline_storage(cfg, SEED, spec, partitioned=True, device="cuda",
                                       axis=axis)
    flat = dict(tree.leaves_with_path(st))
    if any(not torch.equal(p.reshape(-1), flat[k].reshape(-1))
           for k, p in tree.leaves_with_path(pst)):
        problems.append("pipeline storage differs from init_storage's at one stage")
    del st, flat
    for label, sched, split, *_ in PIPE_RUNS:
        spec = PipeSpec(n_stages=1, layers_per_stage=L, n_microbatches=M, schedule=sched,
                        split_backward=split)
        grads, m = pp.make_pipeline_grad_fn(cfg, spec, template, partitioned=True,
                                            axis=axis)(pst, batch)
        errs = {}
        for k, g in tree.leaves_with_path(grads):
            r = ref[k].reshape(-1)
            errs["/".join(k)] = ((g.reshape(-1) - r).norm() / r.norm()).item()
        worst = max(errs, key=errs.get)
        exact = sum(e == 0.0 for e in errs.values())
        say(f"  {label}: step 0's gradient against the layered schedule's, leaf by leaf: "
            f"{exact} of {len(errs)} leaves bitwise equal, worst relative L2 "
            f"{errs[worst]:.2e} ({worst}); loss {m['loss'].item():.6f} against "
            f"{ref_m['loss'].item():.6f}")
        if errs[worst] > PIPE_GRAD_RTOL or m["loss"].item() != ref_m["loss"].item():
            problems.append(f"{label}: step 0's gradient off the layered one ({worst} "
                            f"{errs[worst]:.2e} > {PIPE_GRAD_RTOL})")
        del grads
    del pst, ref


def phase_pipeline(torch, smi, phase5, t_group):
    """Phase 5's configuration through the pipelined train step at one
    stage, on a world-size-1 NCCL group: step 0's gradients leaf by leaf
    against the layered schedule's, then every run of ``PIPE_RUNS``."""
    import torch.distributed as tdist

    from repro_torch import configs
    from repro_torch.core import dist, stepfn
    from repro_torch.core.schedules import PipeSpec
    from repro_torch.data.synthetic import DataConfig, batch_for
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.optim.adam import AdamConfig, adam_init

    L, M = TRAIN_LAYERS, TRAIN_MB
    cfg = dataclasses.replace(configs.get_config("yi-6b"), num_layers=L)
    opt_cfg = AdamConfig(lr=3e-3, warmup_steps=max(TRAIN_STEPS // 10, 1),
                         decay_steps=TRAIN_STEPS)
    data = DataConfig(cfg.vocab_size, 2048, 8, M, seed=SEED)
    counters = train_counters()
    total = dict.fromkeys(counters, 0)
    problems = []
    with one_rank_launch():
        axis = dist.from_env(1, 1, torch.device("cuda"), nstage=1)
        try:
            pipeline_grads_check(torch, cfg, axis, data, problems)
            for name, sched, split, steps, all_k6, loss_tol, gnorm_tol in PIPE_RUNS:
                spec = PipeSpec(n_stages=1, layers_per_stage=L, n_microbatches=M,
                                schedule=sched, split_backward=split)
                table = spec.tick_table()
                pred = table.predicted_collectives(partitioned=True,
                                                   n_layer_leaves=N_LAYER_LEAVES)
                rings = sum(table.frecv_valid[t][0] + table.brecv_valid[t][0]
                            + table.hrecv_valid[t][0] for t in range(table.n_ticks))
                want_coll = {"data all_gather": pred["all_gather_data"],
                             "data reduce_scatter": pred["psum_scatter_data"],
                             "stage send": rings, "stage recv": rings}
                want_k = pipeline_launches(cfg, table, M,
                                           N_LAYER_LEAVES + all_k6 * N_OUTER_LEAVES)
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                step = pipeline_step(cfg, spec, opt_cfg, axis, all_k6)
                storage = stepfn.init_pipeline_storage(cfg, SEED, spec, partitioned=True,
                                                       device="cuda", axis=axis)
                opt = adam_init(storage)
                reset_counts(counters)
                recs = []
                for i in range(steps):
                    batch = batch_for(cfg, data, i, axis)
                    axis.reset_counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    storage, opt, m = step(storage, opt, batch)
                    loss = m["loss"].item()
                    dt = time.perf_counter() - t0
                    coll = {f"{g} {op}": c for (g, op), c in axis.counts.items()}
                    r5 = phase5["records"][i]
                    r = dict(loss=loss, grad_norm=m["grad_norm"].item(), dt=dt,
                             peak=torch.cuda.max_memory_allocated() / 1e9)
                    r["dl"], r["dg"] = rel(loss, r5["loss"]), rel(r["grad_norm"], r5["grad_norm"])
                    recs.append(r)
                    say(f"  {name} step {i}: {dt:.3f} s, {8 * 2048 / dt:.0f} tok/s, MFU "
                        f"{100 * obs_metrics.mfu_estimate(cfg, global_batch=8, seq_len=2048, step_time_s=dt):.2f}%, "
                        f"loss {loss:.6f} (phase 5 {r5['loss']:.6f}, rel diff {r['dl']:.1e}), "
                        f"grad norm {r['grad_norm']:.6f} (rel diff {r['dg']:.1e}), max memory "
                        f"allocated {r['peak']:.2f} GB; collectives [calls, bytes] {coll}")
                    if not (math.isfinite(loss) and math.isfinite(r["grad_norm"])):
                        problems.append(f"{name} step {i}: non-finite loss or grad norm")
                    if i == 0 and (loss != r5["loss"] or r["dg"] > PIPE_GNORM0_RTOL):
                        problems.append(f"{name}: step 0 loss {loss!r} or grad norm "
                                        f"{r['grad_norm']!r} off phase 5's")
                    if i > 0 and (r["dl"] > loss_tol or r["dg"] > gnorm_tol):
                        problems.append(f"{name} step {i}: loss or grad norm off phase 5's "
                                        f"(rel {r['dl']:.1e} > {loss_tol} or {r['dg']:.1e} > "
                                        f"{gnorm_tol})")
                    got = {k: coll.get(k, [0, 0])[0] for k in want_coll}
                    if got != want_coll:
                        problems.append(f"{name} step {i}: collectives {got} != {want_coll}")
                torch.cuda.synchronize()
                counts = read_counts(counters)
                total = {k: total[k] + counts[k] for k in total}
                want = {k: v * steps for k, v in want_k.items()}
                steady = sum(r["dt"] for r in recs[1:]) / (steps - 1)
                say(f"  pipeline {name} on {smi}: one stage, {table.n_ticks} ticks, V "
                    f"{table.n_chunks} chunks of {table.layers_per_chunk} layers, residual "
                    f"slots {table.residual_depth()}; steady step {steady:.4f} s against "
                    f"phase 6's group step {t_group:.4f} s ({100 * (steady / t_group - 1):+.2f}%)"
                    f", {8 * 2048 / steady:.0f} tok/s; max memory allocated "
                    f"{max(r['peak'] for r in recs):.2f} GB; after step 0, against phase 5, "
                    f"loss max rel diff {max(r['dl'] for r in recs[1:]):.1e} (tol {loss_tol}), "
                    f"grad norm {max(r['dg'] for r in recs[1:]):.1e} (tol {gnorm_tol}); "
                    f"launches {counts} (want {want})")
                if counts != want:
                    problems.append(f"{name}: launch counts {counts} != {want}")
                if name == "modular":
                    try:
                        prof = profile_step(torch, step, storage, opt,
                                            batch_for(cfg, data, steps, axis),
                                            f"pipeline {name} step")
                        base = phase5.get("profile", {})
                        grew = sorted(((ms - base.get(k, (0.0, 0))[0], k, n,
                                        base.get(k, (0.0, 0))[1])
                                       for k, (ms, n) in prof.items()), reverse=True)[:8]
                        say("  kernels that take longer in the pipelined step than in phase 5's "
                            "profile (ms more, launches here / there):")
                        for d, k, n, n0 in grew:
                            say(f"    {d:+9.2f} ms x{n}/{n0} {k[:90]}")
                    except Exception as e:  # noqa: BLE001 — the breakdown is optional
                        say(f"  profile of the pipeline: not measured ({type(e).__name__}: {e})")
                del storage, opt, step
        finally:
            tdist.destroy_process_group()
    if problems:
        raise AssertionError("; ".join(problems))
    return total


# ---------------------------------------------------------------------------
# Phase 8: the supervised run on the card (checkpoints, faults, telemetry)
# ---------------------------------------------------------------------------
# full-width Yi-6B cut to 2 layers (870 M parameters: a params + mu + nu
# bundle is 10.4 GB a save, 8 layers' would be 22.9 GB), phase 5's batch
SUP_LAYERS, SUP_STEPS = 2, 6
SUP_ARGV = ["--arch", "yi-6b", "--layers", str(SUP_LAYERS), "--global-batch", "8",
            "--seq-len", "2048", "--microbatches", str(TRAIN_MB), "--steps", str(SUP_STEPS),
            "--lr", "3e-3", "--seed", str(SEED), "--checkpoint-every", "2",
            "--keep-checkpoints", "2", "--log-every", "100"]
# a crash before step 3 (restart from step_00000002, one lost step); after
# step 3's save the step-4 checkpoint corrupted, then a crash before step 4
# (restore_rejected, back to step_00000002); step 5's gradient NaN (skipped)
SUP_FAULTS = [{"kind": "crash", "step": 3},
              {"kind": "corrupt_checkpoint", "step": 3, "file_index": 0, "byte_offset": 4096},
              {"kind": "crash", "step": 4}, {"kind": "nan_grad", "step": 5}]
SERVE_ARGV = ["--arch", "yi-6b", "--layers", str(SUP_LAYERS), "--requests", "4",
              "--prompt-lens", "64,200,512", "--max-new", "16,32", "--block-size", "16",
              "--num-blocks", "512", "--seed", str(SEED)]
CKPT_ROOT = os.path.join(ROOT, "build", "phase8")


def phase_supervised(torch, smi):
    """(a) ``launch.train`` with ``--metrics`` and ``--trace``: the
    reference history; (f) a flat params checkpoint of its final
    weights, served by ``launch.serve --checkpoint-dir``, against the same
    engine on the weights in memory; (b)-(d) the supervised run under a
    fault plan: restarts from the right steps, a rejected corrupt
    checkpoint, a skipped NaN step that leaves the state unchanged, and
    every step bit for bit (a)'s; (e) the tick profiler of phase 7's
    pipeline and its drift against the table.  Returns the launches."""
    import shutil

    import torch.distributed as tdist

    from repro_torch import configs, tree
    from repro_torch.checkpointing import store
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import dist, stepfn
    from repro_torch.core.schedules import PipeSpec
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import serve, train
    from repro_torch.obs import drift as obs_drift
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    from repro_torch.resilience import faults as flt
    from repro_torch.resilience import reshard

    cfg = dataclasses.replace(configs.get_config("yi-6b"), num_layers=SUP_LAYERS)
    layout = reshard.MeshLayout(n_microbatches=TRAIN_MB)
    bundle = 3 * 4 * cfg.param_count()
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    os.makedirs(CKPT_ROOT)
    free = shutil.disk_usage(CKPT_ROOT).free
    say(f"  checkpoint directory build/phase8: {free} bytes free on its filesystem; one "
        f"bundle (params, mu, nu in fp32, {cfg.param_count() / 1e9:.3f} B parameters) "
        f"{bundle} bytes")
    if free < 3 * bundle:
        raise AssertionError(f"{free} bytes free for checkpoints, under 3 bundles "
                             f"({3 * bundle} bytes)")
    counters = dict(train_counters(), paged_attention_decode=(pa, "launches"))
    problems = []
    path = lambda *p: os.path.join(CKPT_ROOT, *p)  # noqa: E731
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    reset_counts(counters)
    try:
        # (a) the reference run through the entry point
        res = train.main(SUP_ARGV + ["--metrics", path("a.jsonl"), "--trace",
                                     path("a.trace.json")], keep_state=True)
        state = res.pop("state")
        recs = obs_metrics.read_jsonl(path("a.jsonl"))
        steps = [r for r in recs if r["event"] == "step"]
        ref = {r["step"]: (r["loss"], r["grad_norm"]) for r in steps}
        trace_bad = obs_trace.validate_chrome(obs_trace.load_chrome(path("a.trace.json")))
        say(f"  (a) {len(steps)} steps, losses {[round(r['loss'], 6) for r in steps]}, step "
            f"times {[round(r['step_time_s'], 4) for r in steps]} s; JSONL events "
            f"{[r['event'] for r in recs]}; trace problems {trace_bad}")
        if (sorted(ref) != list(range(SUP_STEPS)) or recs[0]["event"] != "meta"
                or recs[-1]["event"] != "summary" or trace_bad
                or not all(math.isfinite(x) for v in ref.values() for x in v)):
            problems.append("(a) the reference run's JSONL or trace is not as it should be")
        full_mem = reshard.to_full_state(tree.tree_map(lambda t: t.detach().cpu(),
                                                       state["storage"]), cfg, layout)
        del state, res
        torch.cuda.empty_cache()

        # (f) a flat params checkpoint of (a)'s final weights, served
        store.save_state(path("flat"), full_mem, step=SUP_STEPS)
        out_disk = serve.main(SERVE_ARGV + ["--checkpoint-dir", path("flat")])["outputs"]
        out_mem = serve.main(SERVE_ARGV, params=params_from_numpy(cfg, full_mem, "cuda"))[
            "outputs"]
        del full_mem
        torch.cuda.empty_cache()
        say(f"  (f) served from the flat checkpoint and from memory: {len(out_disk)} "
            f"requests, tokens equal: {out_disk == out_mem}; request 0 {out_disk[0][:8]}")
        if out_disk != out_mem or len(out_disk) != 4:
            problems.append("(f) tokens from the checkpoint differ from the in-memory ones")

        # (b)-(d) the supervised run under the fault plan
        flt.FaultPlan.from_json({"faults": SUP_FAULTS}).save(path("faults.json"))
        t0 = time.perf_counter()
        sup = train.main(SUP_ARGV + ["--checkpoint-dir", path("b"), "--resume", "auto",
                                     "--faults", path("faults.json"), "--metrics",
                                     path("b.jsonl")])
        t_sup = time.perf_counter() - t0
        ev = [r for r in obs_metrics.read_jsonl(path("b.jsonl"))
              if r["event"] not in ("meta", "step", "summary")]
        restarts = [(e["crash_step"], e["resume_step"], e["lost_steps"]) for e in ev
                    if e["event"] == "restart"]
        rejected = [os.path.basename(e["dir"]) for e in ev if e["event"] == "restore_rejected"]
        anomalies = [e["step"] for e in ev if e["event"] == "anomaly"]
        off = [(h["step"], h["loss"], h["grad_norm"], ref[h["step"]]) for h in sup["history"]
               if (h["loss"], h["grad_norm"]) != ref[h["step"]]]
        say(f"  (b)-(d) events {[e['event'] for e in ev]}; restarts (crash step, resume "
            f"step, lost steps) {restarts}; rejected {rejected}; anomalies {anomalies}; "
            f"{len(sup['history'])} steps taken, {len(off)} off (a)'s; skipped-step state "
            f"digests {sup['skipped_state']}")
        if restarts != [(3, 2, 1), (4, 2, 2)]:
            problems.append(f"(b) restarts {restarts}")
        if rejected != [store.step_dir_name(4)]:
            problems.append(f"(c) rejected {rejected}")
        if anomalies != [5] or [s["step"] for s in sup["skipped_state"]] != [5] or any(
                s["digest_before"] != s["digest_after"] for s in sup["skipped_state"]):
            problems.append(f"(d) anomalies {anomalies}, skipped {sup['skipped_state']}")
        if off or sorted({h["step"] for h in sup["history"]}) != list(range(5)):
            problems.append(f"(b)-(c) history off (a)'s: {off[:3]}")
        io = sup["checkpoint_io"]
        rates = {op: [round(x["bytes"] / x["seconds"] / 1e9, 3) for x in io if x["op"] == op]
                 for op in ("save", "restore")}
        rec_s = [round(e["recovery_time_s"], 3) for e in ev if e["event"] == "restart"]
        say(f"  checkpoints on {smi}: {io[0]['bytes']} bytes a bundle; write GB/s "
            f"{rates['save']} (device to host, .npy and sha256 streamed); read-and-verify GB/s "
            f"{rates['restore']} (checksums, read, copy into the card's tensors); "
            f"recovery_time_s {rec_s}; the supervised run {t_sup:.1f} s")
        shutil.rmtree(path("b"))

        # (e) the tick profiler on phase 7's pipeline: one stage, modular
        L, M = TRAIN_LAYERS, TRAIN_MB
        cfg8 = dataclasses.replace(configs.get_config("yi-6b"), num_layers=L)
        spec = PipeSpec(n_stages=1, layers_per_stage=L, n_microbatches=M)
        with one_rank_launch():
            axis = dist.from_env(1, 1, torch.device("cuda"), nstage=1)
            try:
                storage = stepfn.init_pipeline_storage(cfg8, SEED, spec, partitioned=True,
                                                       device="cuda", axis=axis)
                events = train.profile_ticks(cfg8, spec, True, axis, storage,
                                             DataConfig(cfg8.vocab_size, 2048, 8, M, seed=SEED),
                                             torch.device("cuda"), None)
                del storage
            finally:
                tdist.destroy_process_group()
        table = spec.tick_table()
        rep = obs_drift.drift_report(events, table.timeline())
        kinds = {k: round(sum(e[5] - e[4] for e in events if e[1] == k) * 1e3, 2)
                 for k in ("F", "B")}
        say(f"  (e) {table.n_ticks} ticks, {len(events)} units timed on the card, makespan "
            f"{1e3 * max(e[5] for e in events):.1f} ms, unit ms by kind {kinds}")
        for line in obs_drift.format_report(rep).splitlines():
            say(f"    {line}")
        if rep["overall"]["missing"] or rep["overall"]["extra"] or \
                rep["overall"]["matched"] != len(table.timeline()):
            problems.append(f"(e) drift report {rep['overall']}")
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    torch.cuda.synchronize()
    counts = read_counts(counters)
    say(f"  phase 8 launches {counts}")
    if problems:
        raise AssertionError("; ".join(problems))
    return counts


# ---------------------------------------------------------------------------
# Phase 9: plan-driven launch
# ---------------------------------------------------------------------------
PLAN_DIR = os.path.join(ROOT, "build", "phase9")
PLAN_STEPS = 5
PLAN_ARGV = ["--arch", "yi-6b", "--layers", str(TRAIN_LAYERS), "--global-batch", "8",
             "--seq-len", "2048"]
PAPER_ARGV = ["--arch", "paper-x", "--size", "160", "--grid", "reduced", "--simulate-top", "8",
              "--max-sims", "24"]


def shape_checks(torch, cfg, mb: int, S: int, label: str, *, attention: bool = True,
                 dtype=None, errs: dict | None = None, window: int = 0,
                 softcap: float = 0.0, dq_control: bool = False) -> list:
    """K1-K5 at a micro-batch of mb x S tokens of ``cfg`` (in ``dtype``, bf16
    unless given) against their plain versions, with phase 2's training-shape
    tolerances: K1/K2 on [mb * S, d_model] rows, K3 and K4 (and in bf16 their
    row checks) and K5 on q [mb, S, num_heads, head_dim], k/v [mb, S,
    num_kv_heads, head_dim], causal (with ``window`` and ``softcap`` where
    given); K1/K2 alone when ``attention`` is false.  ``dq_control`` also
    runs K4's row check on its control (``check_dq_rows``).  ``errs``
    collects each kernel's max_abs_err.  Returns the failures."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    g = torch.Generator(device="cuda").manual_seed(SEED)
    dtype = dtype or torch.bfloat16
    errs = {} if errs is None else errs

    def randn(*shape, dtype=dtype):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    failures = []
    D = cfg.d_model
    x, dy, s = randn(mb * S, D), randn(mb * S, D), randn(D, dtype=torch.float32)
    name = f"{label} rows={mb * S} D={D} {str(dtype)[6:]}"
    errs["rmsnorm"] = check_case(torch, "K1 " + name, rn.rmsnorm_cuda(x, s), rn.plain(x, s),
                                 failures)
    errs["rmsnorm_bwd"] = check_case(torch, "K2 " + name, rn.rmsnorm_bwd_cuda(x, s, dy),
                                     rn.plain_bwd(x, s, dy), failures,
                                     parts=(" [dx]", " [dscale]"), rel=True)
    del x, dy
    if attention:
        Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q, do = randn(mb, S, Hq, hd), randn(mb, S, Hq, hd)
        k, v = randn(mb, S, Hkv, hd), randn(mb, S, Hkv, hd)
        kw = dict(window=window, softcap=softcap)
        name = (f"{label} q={[mb, S, Hq, hd]} kv_heads={Hkv} {str(dtype)[6:]} causal"
                + (f" window={window} softcap={softcap:g}" if window or softcap else ""))
        out, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
        errs["flash_attention_fwd"] = check_case(torch, "K3 " + name, (out, lse),
                                                 fa.plain(q, k, v, **kw), failures,
                                                 bf16_rel=BF16_FWD_TOL)
        if dtype == torch.bfloat16:
            check_rows(torch, "K3 " + name, out, fa.plain(q, k, v, round_p=True, **kw)[0],
                       failures)
        dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, out, lse, do, **kw)
        dq_p, delta_p = fa.plain_bwd_dq(q, k, v, out, lse, do, **kw)
        errs["flash_attention_bwd_dq"] = check_case(
            torch, "K4 " + name, (dq, delta), (dq_p, delta_p), failures,
            parts=(" [dq]", " [delta]"), rel=True, bf16_rel=BF16_BWD_TOL)
        del dq_p
        if dtype == torch.bfloat16:
            check_dq_rows(torch, "K4 " + name, dq, q, k, v, out, lse, do, kw, failures,
                          control=dq_control)
        del dq
        errs["flash_attention_bwd_dkv"] = check_case(
            torch, "K5 " + name, fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw),
            fa.plain_bwd_dkv(q, k, v, do, lse, delta_p, **kw), failures,
            parts=(" [dk]", " [dv]"), rel=True, bf16_rel=BF16_BWD_TOL)
    torch.cuda.empty_cache()
    return failures


def phase_plan(torch, smi):
    """(a) ``launch.plan`` ranks the one-card executions of 8-layer Yi-6B at
    the H100's constants (``--devices`` left at 0: this machine's cards);
    (b) ``launch.train --plan`` runs the winner: its resolved execution is
    the plan's, every step finite, K1-K5 launches exactly the planned method
    and M's, no K6 (a one-card plan is unpartitioned), the plan's score
    beside the measured step; (c) the same run given by flags, bit for bit
    (b)'s, K1-K5 at the planned micro-batch's shapes against their plain
    versions, then a profile of one step of it; (d) on the host, the paper's X_160 document: Table 6.1's winner
    and the ~1.9x speedup."""
    from repro_torch import configs
    from repro_torch.launch import plan as plan_cli
    from repro_torch.launch import train

    os.makedirs(PLAN_DIR, exist_ok=True)
    path = os.path.join(PLAN_DIR, "plan.json")
    doc = plan_cli.main([*PLAN_ARGV, "--microbatches", "1,2,4,8", "--out", path])
    ex = doc["execution"]
    for r in doc["plans"]:
        say(f"  planned (H100 constants): {r['method']} partitioned={r['partitioned']} "
            f"M={r['microbatches']} score {r['score_step_s']:.4f} s (compute "
            f"{r['compute_s']:.4f}, data {r['data_coll_s']:.4f})")
    win = doc["plans"][0]
    if ex["partitioned"] or doc["devices"] != 1:
        raise AssertionError(f"a one-card plan should be unpartitioned on 1 device: {ex}")
    counters = train_counters()

    def run(argv):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_counts(counters)
        res = train.main(argv)
        torch.cuda.synchronize()
        return res, read_counts(counters)

    planned, counts = run(["--plan", path, "--steps", str(PLAN_STEPS)])
    flags = [*PLAN_ARGV, "--microbatches", str(ex["microbatches"]), "--method", ex["method"],
             "--no-partition", "--steps", str(PLAN_STEPS)]
    given, counts_c = run(flags)
    # the full-leaf layout of a one-card plan takes the tree-map AdamW: no K6
    want = {k: v * PLAN_STEPS
            for k, v in step_launches(TRAIN_LAYERS, ex["microbatches"], 0).items()}
    steady = [r["step_time_s"] for r in planned["records"][1:]]
    mean = sum(steady) / len(steady)
    for r in planned["records"]:
        say(f"  plan step {r['step']}: {r['step_time_s']:.3f} s, loss {r['loss']:.4f}, "
            f"grad norm {r['grad_norm']:.4f}, max memory allocated {r['peak_mem_gb']:.2f} GB")
    say(f"  planner on {smi}: predicted {win['score_step_s']:.4f} s a step "
        f"({ex['method']}, M={ex['microbatches']}), measured steady mean {mean:.4f} s, "
        f"predicted/measured {win['score_step_s'] / mean:.3f}; launches over "
        f"{PLAN_STEPS} steps {counts}")
    problems = []
    if planned["execution"] != dict(ex, steps=PLAN_STEPS):
        problems.append(f"resolved execution {planned['execution']} != the plan's {ex}")
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in planned["records"]):
        problems.append("non-finite loss or grad norm")
    for name, c in (("plan", counts), ("flags", counts_c)):
        if c != want:
            problems.append(f"{name} run launch counts {c} != {want}")
    hist = [(r["loss"], r["grad_norm"]) for r in planned["records"]]
    if hist != [(r["loss"], r["grad_norm"]) for r in given["records"]]:
        problems.append(f"the flag-given run differs from the plan's: {hist} against "
                        f"{[(r['loss'], r['grad_norm']) for r in given['records']]}")
    # the counts are read: these launches compare, they are not the path's
    problems += shape_checks(torch, configs.get_config("yi-6b"),
                             ex["global_batch"] // ex["microbatches"], ex["seq_len"],
                             "at the plan's")

    try:
        from repro_torch.core.accumulation import AccumConfig
        phase_train_profile(torch, label="planned step", acc=AccumConfig(
            ex["method"], ex["partitioned"], ex["microbatches"]))
    except Exception as e:  # noqa: BLE001 — the breakdown is optional; say why it is missing
        say(f"  profile: not measured ({type(e).__name__}: {e})")

    t0 = time.perf_counter()
    paper = plan_cli.main(PAPER_ARGV)
    w = paper["winner"]
    say(f"  paper X_160 (the paper's A100, table A.1): {w['family']} n_a={w['n_a']} "
        f"n_l={w['n_l']} n_mu={w['n_mu']} {w['n_gpu']} GPUs, "
        f"{w.get('sim_time_days', w['time_days'])} days, speedup over the 3d baseline "
        f"{paper['speedup_vs_3d_baseline']}; {time.perf_counter() - t0:.1f} s on the host")
    if w["n_gpu"] != 38640 or not 1.9 * 0.9 <= paper["speedup_vs_3d_baseline"] <= 1.9 * 1.1:
        problems.append(f"paper X_160: {w['n_gpu']} GPUs, speedup "
                        f"{paper['speedup_vs_3d_baseline']}")
    if problems:
        raise AssertionError("; ".join(problems))
    return counts


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# Phase 10: the mixture-of-experts family (dbrx-132b, arctic-480b)
# ---------------------------------------------------------------------------
def paged_checks(torch, cfg, label: str) -> list:
    """K7 at ``cfg``'s heads (bf16 and fp32, 8 slots of ragged contexts, an
    idle slot) against its plain version with phase 2's tolerances; idle
    rows exactly zero.  Returns the failures."""
    from repro_torch.kernels import paged_attention as pa

    g = torch.Generator(device="cuda").manual_seed(SEED)
    Hq, Hkv, hd, bs = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 16
    failures = []
    for dtype, ctx in ((torch.bfloat16, [577, 65, 301, 512, 0, 449, 96, 2100]),
                       (torch.float32, [40, 1, 300, 0, 8191, 17, 260, 513])):
        R = len(ctx)
        maxb = -(-max(ctx) // bs) + 1
        N = max(2049, R * maxb + 1)

        def randn(*shape):
            return torch.randn(*shape, generator=g, device="cuda").to(dtype)

        q, kp, vp = randn(R, Hq, hd), randn(N, Hkv, bs, hd), randn(N, Hkv, bs, hd)
        perm = torch.randperm(N - 1, generator=g, device="cuda")[:R * maxb]
        bt = perm.view(R, maxb).to(torch.int32).contiguous()
        cl = torch.tensor(ctx, dtype=torch.int32, device="cuda")
        got = pa.paged_attention_cuda(q, kp, vp, bt, cl)
        check_case(torch, f"K7 {label} q_heads={Hq} kv_heads={Hkv} D={hd} {str(dtype)[6:]} "
                   f"ctx={ctx}", got, pa.plain(q, kp, vp, bt, cl), failures)
        if not bool((got[cl == 0] == 0).all()):
            failures.append(f"K7 {label}: ctx == 0 rows are not zero")
    return failures


def moe_kernel_checks(torch) -> list:
    """Phase 10 (e): the kernels at the MoE configs' shapes, which no other
    phase gives them: K1/K2 at d_model 6144 and 7168, K3-K5 at rep 6
    (dbrx-132b, 48 q / 8 KV heads) and rep 7 (arctic-480b, 56 / 8: K3 pairs
    rep heads a warpgroup and duplicates the last of an odd rep), K7 at both.
    Returns the failures."""
    from repro_torch import configs

    failures = []
    for arch, mb, S in (("dbrx-132b", 2, 2048), ("arctic-480b", 1, 2048),
                        ("arctic-480b", 4, 512)):
        cfg = configs.get_config(arch)
        failures += shape_checks(torch, cfg, mb, S, f"{arch} at")
        torch.cuda.empty_cache()
    for arch in ("dbrx-132b", "arctic-480b"):
        failures += paged_checks(torch, configs.get_config(arch), arch)
    torch.cuda.empty_cache()
    return failures


MOE_SERVE = {
    # arch: (layers, requests, prompt lengths, output lengths); every published
    # width, depth cut so that the bf16 weights (6.52 GB a dbrx layer, 27.2 GB
    # an arctic layer) fit one card
    "dbrx-132b": (8, 16, [64, 512, 128, 320, 256, 96, 448, 200], [32, 48, 64]),
    "arctic-480b": (2, 4, [64, 512, 128, 320], [32, 48]),
}
MOE_TRAIN_EXPERTS = 8                        # of dbrx's 16: fp32 state of 16 B a parameter
MOE_TRAIN_ARGV = ["--arch", "dbrx-132b", "--layers", "1", "--global-batch", "8",
                  "--seq-len", "2048", "--microbatches", str(TRAIN_MB), "--steps",
                  str(TRAIN_STEPS), "--lr", "3e-3", "--seed", str(SEED)]
GEMM_NAMES = ("gemm", "xmma", "cutlass", "nvjet", "gemv")


def free_card(torch) -> str:
    """Collect garbage, return cached blocks; the allocator's state."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return (f"memory_allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB, "
            f"reserved {torch.cuda.memory_reserved() / 1e9:.2f} GB")


def decode_profile(torch, eng, label: str, skip=()):
    """A profiler window over 10 decode steps of a running engine: wall and
    device ms a step, the idle share, and GEMM against K7 by device ms
    (device events named in ``skip``, profiler ranges, are not kernels).
    Returns the profile and its number of steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = 0
        while n < 10 and eng.step():
            n += 1
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if n < 10:
        raise AssertionError(f"{label}: the engine ran {n} of 10 decode steps")
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in skip]
    dev = sum(e.self_device_time_total for e in kern) / 1e3
    gemm = sum(e.self_device_time_total for e in kern
               if any(k in e.key.lower() for k in GEMM_NAMES)) / 1e3
    k7 = sum(e.self_device_time_total for e in kern if "paged_decode_kernel" in e.key) / 1e3
    say(f"  profile {label}, {n} engine steps (decode, 8 slots): wall {wall_ms / n:.3f} ms, "
        f"device busy {dev / n:.3f} ms a step (idle {100 - 100 * dev / wall_ms:.1f}%), "
        f"launches {sum(e.count for e in kern) // n} a step; GEMM {gemm / n:.3f} ms, K7 "
        f"{k7 / n:.3f} ms, other {(dev - gemm - k7) / n:.3f} ms")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
        say(f"    {e.self_device_time_total / n / 1e3:8.3f} ms x{e.count // n:<4d} {e.key[:90]}")
    return prof, n


MOE_RANGES = ("moe.dispatch", "moe.combine", "moe.experts")


def moe_profile(torch, cfg, eng) -> None:
    """``decode_profile`` over 10 decode steps of a running engine, then the
    GEMM time inside the MoE block's ``moe.dispatch`` / ``moe.combine``
    ranges (the one-hot dispatch and combine) and ``moe.experts``."""
    prof, n = decode_profile(torch, eng, cfg.name, skip=MOE_RANGES)
    ranges = dict.fromkeys(MOE_RANGES, 0.0)

    def gemm_in(ev) -> float:
        us = sum(k.duration for k in ev.kernels if any(g in k.name.lower() for g in GEMM_NAMES))
        return us + sum(gemm_in(c) for c in ev.cpu_children)

    for ev in prof.events():
        if ev.name in ranges:
            ranges[ev.name] += gemm_in(ev) / 1e3
    dc = ranges["moe.dispatch"] + ranges["moe.combine"]
    say(f"  {cfg.name}: GEMM inside one-hot dispatch + combine {dc / n:.3f} ms a step, inside "
        f"the experts {ranges['moe.experts'] / n:.3f} ms")


def serve_moe(torch, np, smi, arch: str) -> dict:
    """``MOE_SERVE[arch]`` through ``ServingEngine``: weights made on the
    card in bf16, a seeded Poisson trace, exact K1/K3/K7 launch counts; for
    dbrx-132b then a profile of its decode steps."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models import transformer as T
    from repro_torch.serving.cache import PagedCacheConfig
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import Request, SchedulerConfig, poisson_trace

    layers, n_req, prompts, outs = MOE_SERVE[arch]
    cfg = dataclasses.replace(configs.get_config(arch), num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for _, p in T.named_parameters(params))
    say(f"  {arch}: {layers} layers, d_model {cfg.d_model}, {cfg.num_experts} experts top "
        f"{cfg.experts_per_token}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
        f"{n_params / 1e9:.3f} B parameters in bf16 (router fp32), made on the card in "
        f"{time.perf_counter() - t0:.1f} s; {free_card(torch)}")
    warm_engine(cfg, params)
    reqs = poisson_trace(np.random.default_rng(SEED), n_requests=n_req, rate=0.5,
                         vocab=cfg.vocab_size, prompt_lens=prompts, max_new=outs)
    pcfg = PagedCacheConfig(num_blocks=2048, block_size=16, max_blocks_per_seq=36)
    eng = ServingEngine(cfg, params, SchedulerConfig(cache=pcfg, max_batch=8))
    eng.submit_all(reqs)
    torch.cuda.synchronize()
    rn.launches = fa.launches = pa.launches = 0
    t0 = time.perf_counter()
    out = eng.run(max_steps=2000)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {"rmsnorm": rn.launches, "flash_attention_fwd": fa.launches,
              "paged_attention_decode": pa.launches}
    st = eng.stats
    want = {"rmsnorm": (2 * layers + 1) * (st["prefill_calls"] + st["decode_steps"]),
            "flash_attention_fwd": layers * st["prefill_calls"],
            "paged_attention_decode": layers * st["decode_steps"]}
    lat = eng.latency_summary()
    say(f"  {arch} engine on {smi}: {len(out)} requests, {st['emitted_tokens']} tokens, "
        f"{st['prefill_calls']} prefill calls, {st['decode_steps']} decode steps in {dt:.3f} s "
        f"-> {st['emitted_tokens'] / dt:.1f} tok/s; TTFT ms p50 {lat['ttft_ms']['p50']:.2f} "
        f"p99 {lat['ttft_ms']['p99']:.2f}; ITL ms p50 {lat['itl_ms']['p50']:.2f} p99 "
        f"{lat['itl_ms']['p99']:.2f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    say(f"  launches {counts} expected {want}")
    problems = []
    if sorted(out) != list(range(len(reqs))) or any(
            len(out[r.rid]) != r.max_new_tokens for r in reqs):
        problems.append(f"{arch}: not every request finished its budget")
    if any(not 0 <= t < cfg.vocab_size for toks in out.values() for t in toks):
        problems.append(f"{arch}: token outside the vocabulary")
    if eng.sched.alloc.used != 0:
        problems.append(f"{arch}: the allocator did not drain")
    if counts != want:
        problems.append(f"{arch}: launch counts {counts} != {want}")
    if problems:
        raise AssertionError("; ".join(problems))
    if arch == "dbrx-132b":
        try:
            rng = np.random.default_rng(SEED + 1)
            eng.submit_all([Request(rid=100 + i, prompt=tuple(
                int(t) for t in rng.integers(0, cfg.vocab_size, 256)), max_new_tokens=40,
                arrival=eng.t) for i in range(8)])
            eng.step()
            eng.step()
            moe_profile(torch, cfg, eng)
        except Exception as e:  # noqa: BLE001 — the breakdown is optional; say why it is missing
            say(f"  profile: not measured ({type(e).__name__}: {e})")
    del eng, params
    return counts


def moe_parity(torch, np) -> None:
    """dbrx-132b's widths, 1 layer, fp32, on the card (kernels) and on the CPU
    (plain versions) with the same weights: 3 ragged prompts through prefill
    and 4 decode steps.  The router's expert ids of every prompt position
    (pads included: they are routed too) and the greedy tokens must be
    equal; where an id differs, the top-k margin at that token is printed."""
    from repro_torch import configs
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.models.common import apply_norm
    from repro_torch.serving import steps
    from repro_torch.serving.cache import PagedCacheConfig, init_paged_cache

    cfg = dataclasses.replace(configs.get_config("dbrx-132b"), num_layers=1, dtype="float32")
    t0 = time.perf_counter()
    on_card = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    on_cpu = T.to_device(on_card, "cpu")
    say(f"  dbrx-132b widths, 1 layer, fp32: weights made on the card and copied to the CPU "
        f"in {time.perf_counter() - t0:.1f} s")
    lens = np.array([37, 64, 11], np.int32)
    B, S, bs, maxb = 3, 64, 16, 5
    toks = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    tables = np.arange(B * maxb, dtype=np.int32).reshape(B, maxb)
    pcfg = PagedCacheConfig(num_blocks=B * maxb, block_size=bs, max_blocks_per_seq=maxb)
    res = {}
    for dev, params in (("cuda", on_card), ("cpu", on_cpu)):
        t0 = time.perf_counter()
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        with torch.no_grad():
            x, pos = T.embed_inputs(cfg, params, {"tokens": t(toks)})
            lp = params["layers"][0]
            x = x + attn_mod.attention_train(cfg, lp["attn"], apply_norm(cfg, lp["ln1"], x),
                                             positions=pos, window=0)
            h = apply_norm(cfg, lp["ln2"], x).reshape(-1, cfg.d_model)
            logits = h.float() @ lp["moe"]["router"].float()
            _, ids, _ = moe._router(cfg, lp["moe"], h)
            cache = init_paged_cache(cfg, pcfg, dev)
            lg, cache = steps.paged_prefill_step(cfg, params, cache, {
                "tokens": t(toks), "lens": t(lens)}, t(tables))
            greedy = [lg.argmax(-1).cpu()]
            cur = lens.copy()
            for _ in range(4):
                lg, cache = steps.paged_decode_step(cfg, params, cache, t(tables), t(cur),
                                                    greedy[-1].to(dev).int())
                greedy.append(lg.argmax(-1).cpu())
                cur = cur + 1
        res[dev] = (ids.cpu(), torch.softmax(logits.cpu(), -1), torch.stack(greedy, 1))
        say(f"  {dev}: prefill and 4 decode steps in {time.perf_counter() - t0:.1f} s")
    (ids_g, _, tok_g), (ids_c, probs_c, tok_c) = res["cuda"], res["cpu"]
    bad = (ids_g != ids_c).any(-1).nonzero().flatten().tolist()
    for i in bad[:8]:
        top = probs_c[i].sort(descending=True).values
        k = cfg.experts_per_token
        say(f"  token {i}: ids card {ids_g[i].tolist()} cpu {ids_c[i].tolist()}; top-{k} "
            f"margin on the CPU {float(top[k - 1] - top[k]):.3e}")
    say(f"  router ids of {ids_g.shape[0]} positions x top {ids_g.shape[1]}: "
        f"{'equal' if not bad else f'{len(bad)} positions differ'}; greedy tokens card "
        f"{tok_g.tolist()} cpu {tok_c.tolist()}")
    if bad or not torch.equal(tok_g, tok_c):
        raise AssertionError("card and CPU disagree on expert ids or greedy tokens")
    del on_card, on_cpu


def train_moe(torch, smi) -> dict:
    """``launch.train`` at dbrx-132b's widths, 1 layer, ``MOE_TRAIN_EXPERTS``
    of its 16 experts (top 4 kept): layered, partitioned, 8 x 2048 tokens in
    4 micro-batches, 5 steps; exact K1-K6 launches (10 layer leaves, the
    router and 3 expert stacks among them, and 3 outer ones through K6 a
    step), finite loss, grad norm and aux."""
    from repro_torch.launch import train

    counters = train_counters()
    orig = train.configs.get_config

    def get_config(arch, *, smoke=False):
        return dataclasses.replace(orig(arch, smoke=smoke), num_experts=MOE_TRAIN_EXPERTS)

    say(f"  before training: {free_card(torch)}")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    train.configs.get_config = get_config
    try:
        res = train.main(MOE_TRAIN_ARGV)
    finally:
        train.configs.get_config = orig
    torch.cuda.synchronize()
    counts = read_counts(counters)
    want = {k: v * TRAIN_STEPS for k, v in step_launches(1, TRAIN_MB, 13).items()}
    for r in res["records"]:
        say(f"  step {r['step']}: {r['step_time_s']:.3f} s, {r['tokens_per_s']:.0f} tok/s, "
            f"MFU {100 * r['mfu']:.2f}% (6ND at active parameters), loss {r['loss']:.4f}, "
            f"grad norm {r['grad_norm']:.4f}, aux {r['aux']:.4f}, max memory allocated "
            f"{r['peak_mem_gb']:.2f} GB")
    steady = res["records"][1:]
    say(f"  MoE training on {smi}: dbrx-132b widths, 1 layer, {MOE_TRAIN_EXPERTS} of 16 "
        f"experts, layered + partitioned, 8 x 2048 tokens in {TRAIN_MB} micro-batches; steady "
        f"mean {sum(r['step_time_s'] for r in steady) / len(steady):.3f} s, "
        f"{sum(r['tokens_per_s'] for r in steady) / len(steady):.0f} tok/s, MFU "
        f"{100 * sum(r['mfu'] for r in steady) / len(steady):.2f}%")
    say(f"  launches over {TRAIN_STEPS} steps {counts} expected {want}")
    problems = []
    if not all(math.isfinite(r[k]) for r in res["records"] for k in ("loss", "grad_norm", "aux")):
        problems.append("non-finite loss, grad norm or aux")
    if counts != want:
        problems.append(f"launch counts {counts} != {want}")
    if problems:
        raise AssertionError("; ".join(problems))
    return counts


def phase_moe(torch, np, smi) -> dict:
    """(a) dbrx-132b served at full width (16 experts, 8 layers), (b)
    arctic-480b (128 experts and the dense residual, 2 layers), (c) card
    against CPU at dbrx's widths, (d) training at dbrx's widths, (e) the
    kernels at the family's shapes.  Returns the launches of (a), (b), (d)."""
    say(f"  at the start of phase 10: {free_card(torch)}")
    counts = {}
    for part, fn in (("a", lambda: serve_moe(torch, np, smi, "dbrx-132b")),
                     ("b", lambda: serve_moe(torch, np, smi, "arctic-480b")),
                     ("c", lambda: moe_parity(torch, np)),
                     ("d", lambda: train_moe(torch, smi))):
        t0 = time.perf_counter()
        for name, c in (fn() or {}).items():
            counts[name] = counts.get(name, 0) + c
        say(f"  ({part}) {time.perf_counter() - t0:.1f} s; {free_card(torch)}")
    t0 = time.perf_counter()
    failures = moe_kernel_checks(torch)
    say(f"  (e) {time.perf_counter() - t0:.1f} s")
    if failures:
        raise AssertionError(f"kernels at the MoE shapes: {failures}")
    return counts


# ---------------------------------------------------------------------------
# Phase 11: the recurrent families (rwkv6-3b, zamba2-7b)
# ---------------------------------------------------------------------------
RECURRENT_SERVE = ("rwkv6-3b", "zamba2-7b")                 # full width and depth
SERVE_B, SERVE_S, SERVE_STEPS = 8, 512, 64
RECURRENT_PARITY = {"rwkv6-3b": 2, "zamba2-7b": 6}         # layers (6: the shared block runs)
# launch.train at full width: rwkv6-3b at full depth (52.3 GB of fp32 state),
# zamba2-7b cut to 12 layers (the shared block after layers 5 and 11; 36.8 GB)
RECURRENT_TRAIN = {"rwkv6-3b": 0, "zamba2-7b": 12}
FUSED_FAMILY_STEPS = 2


def family_step_launches(cfg, M: int) -> dict:
    """K1-K6 launches of one layered step of any stack at M micro-batches:
    each layer's kernels (``layer_launches``) forward, recomputed and
    back-propagated per micro-batch, the final norm forward and backward per
    micro-batch (none with LayerNorm), K6 once per storage leaf."""
    from repro_torch import tree
    from repro_torch.core import stepfn
    n = a = 0
    for l in range(cfg.num_layers):
        dn, da = layer_launches(cfg, l)
        n, a = n + dn, a + da
    head = 0 if cfg.norm == "layernorm" else M
    return {"rmsnorm": 2 * M * n + head, "rmsnorm_bwd": M * n + head,
            "flash_attention_fwd": 2 * M * a, "flash_attention_bwd_dq": M * a,
            "flash_attention_bwd_dkv": M * a,
            "adamw": len(tree.leaves(stepfn.full_template(cfg)))}


def serve_launches(cfg, calls: int) -> dict:
    """K1/K3 launches of ``calls`` dense-cache prefill or decode calls: one
    K1 per Mamba layer, two per shared block and the final norm (RWKV's block
    norms are plain); K3 once per shared block in a prefill (the decode
    attends over the dense cache in plain PyTorch, as the JAX package does)."""
    n_sh = sum(cfg.attn_layer_flags())
    per = (cfg.num_layers if cfg.block_kind == "mamba" else 0) + 2 * n_sh + 1
    return {"rmsnorm": per * calls, "flash_attention_fwd": n_sh}


def live_pairs(S: int, window: int = 0) -> int:
    """Live (q, k) pairs of one causal head of length S (inside the window)."""
    if window <= 0 or S <= window:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def attention_times(torch, F, cfg, B: int, S: int, errs: dict, label: str,
                    window: int = 0, softcap: float = 0.0, dtype=None) -> dict:
    """K3, K4 and K5 at q [B, S, Hq, hd], k/v [B, S, Hkv, hd] of ``cfg``, in
    ``dtype`` (bf16 unless given), causal (with ``window`` and ``softcap``
    where given): each kernel's ms, its bound (the live pairs of the window,
    at the dtype's peak rate) and SDPA's ms (forward; backward dq, dk and dv
    together; causal, without softcap or window, which it does not take),
    with ``errs``' max_abs_err from ``shape_checks``; printed, one line a
    kernel."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(SEED)
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dtype = dtype or torch.bfloat16
    dt = str(dtype)[6:]
    q, do = (torch.randn(B, S, Hq, D, generator=g, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, S, Hkv, D, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    kw = dict(window=window, softcap=softcap)
    out, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
    _, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, out, lse, do, **kw)
    es = q.element_size()
    pairs = B * Hq * live_pairs(S, window)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    gqa = {"enable_gqa": True} if Hkv != Hq else {}

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, **gqa)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), [qt, kt, vt], dot)

    sdpa_fwd = cuda_ms(torch, sdpa, 20)
    sdpa_bwd = cuda_ms(torch, sdpa_fwd_bwd, 10) - cuda_ms(torch, sdpa, 10)
    io = 4 * B * Hq * S
    rows = {
        "flash_attention_fwd": dict(
            max_abs_err=errs["flash_attention_fwd"],
            ms=cuda_ms(torch, lambda: fa.flash_attention_fwd_cuda(q, k, v, **kw), 20),
            library_ms=sdpa_fwd,
            bound=bound(es * (2 * q.numel() + 2 * k.numel()) + io, 4 * D * pairs, dt)),
        "flash_attention_bwd_dq": dict(
            max_abs_err=errs["flash_attention_bwd_dq"],
            ms=cuda_ms(torch, lambda: fa.flash_attention_bwd_dq_cuda(q, k, v, out, lse, do,
                                                                     **kw), 20),
            library_ms=sdpa_bwd,
            bound=bound(es * (4 * q.numel() + 2 * k.numel()) + 2 * io, 6 * D * pairs, dt)),
        "flash_attention_bwd_dkv": dict(
            max_abs_err=errs["flash_attention_bwd_dkv"],
            ms=cuda_ms(torch, lambda: fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                                      **kw), 20),
            library_ms=sdpa_bwd,
            bound=bound(es * (2 * q.numel() + 4 * k.numel()) + 2 * io, 8 * D * pairs, dt))}
    for name, r in rows.items():
        say(f"  time {name} at {label}, q [{B}, {S}, {Hq}, {D}] k/v [{B}, {S}, {Hkv}, {D}] "
            f"{dt} causal{f' window {window} softcap {softcap:g}' if window or softcap else ''}"
            f": kernel_ms={r['ms']:.4f} bound_ms={r['bound'][0]:.4f} "
            f"({r['bound'][1]}, {100 * r['bound'][0] / r['ms']:.0f}%) library_ms (SDPA"
            f"{'' if name.endswith('fwd') else ' backward, dq dk dv together'})="
            f"{r['library_ms']:.4f} max_abs_err={r['max_abs_err']:.3e}")
    bwd = rows["flash_attention_bwd_dq"]["ms"] + rows["flash_attention_bwd_dkv"]["ms"]
    say(f"  {label}: K3 {rows['flash_attention_fwd']['ms'] / sdpa_fwd:.2f}x SDPA's forward, "
        f"K4 + K5 {bwd:.4f} ms, {bwd / sdpa_bwd:.2f}x SDPA's backward")
    del q, k, v, do, out, lse, delta, qt, kt, vt, dot
    torch.cuda.empty_cache()
    return rows


# K3-K5's kernel instances, and K5's partial sum, by device kernel name
ATTENTION_KERNEL = r"flash_\w*kernel\w*<[^>]*>|dkv_sum_kernel"


def instances(kernels) -> dict:
    """Launches by attention kernel instance (``ATTENTION_KERNEL``) of
    (device kernel name, launches) pairs."""
    out = {}
    for key, count in kernels:
        hit = re.search(ATTENTION_KERNEL, key)
        if hit:
            out[hit.group(0)] = out.get(hit.group(0), 0) + count
    return out


def profiled_instances(prof) -> dict:
    """``instances`` of a ``torch.profiler`` run's device kernels."""
    from torch.autograd import DeviceType
    return instances((e.key, e.count) for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA)


def hd112_checks(torch, F, failures) -> dict:
    """K3-K5 at head dim 112 (Zamba2-7B's shared attention: the head-dim-128
    instances compiled with the true head dim as a template parameter)
    through ``shape_checks`` at zamba2-7b's training micro-batch (2 x 2048,
    which also holds K1/K2 on its [4096, 3584] rows), its prefill (8 x 512),
    GQA at rep 4, and fp32 on the CUDA-core kernels; the bf16 cases must run
    the <128, 112> tensor-core instances.  At the training shape each
    kernel's time, bound and SDPA's time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    say("K3-K5 at head dim 112 (zamba2-7b's shared attention; the tensor-core instances in "
        "bf16, the CUDA-core ones in fp32; phase 2's tolerances)")
    cfg = configs.get_config("zamba2-7b")
    gqa = dataclasses.replace(cfg, num_kv_heads=8)
    errs = {}
    cases = [(cfg, 2, 2048, torch.bfloat16, errs),          # training micro-batch
             (cfg, 8, 512, torch.bfloat16, None),           # prefill
             (gqa, 2, 512, torch.bfloat16, None),           # GQA rep 4
             (gqa, 1, 300, torch.float32, None)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for c, mb, S, dtype, e in cases:
            failures += shape_checks(torch, c, mb, S, "zamba2-7b", dtype=dtype, errs=e)
        torch.cuda.synchronize()
    launched = profiled_instances(prof)
    say(f"  hd 112 launched as: {launched}")
    n_tc = sum(c for name, c in launched.items() if "_tc<128, 112>" in name)
    if n_tc != 3 * sum(dt == torch.bfloat16 for *_, dt, _ in cases):
        failures.append(f"hd 112: the bf16 cases ran {n_tc} tensor-core launches")
    return attention_times(torch, F, cfg, 2, 2048, errs, "hd 112")


# head dim 256 in bf16: K3, K4 and K5 on the tensor cores
HD256_INSTANCES = {"flash_attention_fwd": "flash_fwd_kernel_tc<256, 256>",
                   "flash_attention_bwd_dq": "flash_bwd_dq_kernel_tc_split<256>",
                   "flash_attention_bwd_dkv": "flash_bwd_dkv_kernel_tc_split<256>"}
BWD_REPEATS = 5


def hd256_checks(torch, F, failures) -> dict:
    """K3-K5 at head dim 256 (both gemma configs) against their plain
    versions with phase 2's training-shape tolerances, at gemma-2b's
    training micro-batch (q [2, 2048, 8, 256], k/v [.., 1, 256]: MQA, rep 8)
    and gemma2-9b's (q [1, 8192, 16, 256], k/v [.., 8, 256], softcap 50,
    window 4096).  The bf16 launches must be ``HD256_INSTANCES``; K4 must
    give the same bits over ``BWD_REPEATS`` calls at both shapes, and K5 at
    gemma-2b's, where it splits each KV head's query heads over blocks.
    Then each kernel's time, bound and SDPA's time at both shapes.  Returns
    {"hd256": rows at gemma-2b's shape, "gemma2": rows at gemma2-9b's}."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    say("K3-K5 at head dim 256 (both gemma configs; bf16 on the tensor cores; phase 2's "
        "training-shape tolerances)")
    g2b, g9b = configs.get_config("gemma-2b"), configs.get_config("gemma2-9b")
    w, cap = g9b.sliding_window, g9b.attn_logit_softcap
    errs, errs9 = {}, {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        failures += shape_checks(torch, g2b, 2, 2048, "gemma-2b", errs=errs, dq_control=True)
        failures += shape_checks(torch, g9b, 1, 8192, "gemma2-9b", errs=errs9, window=w,
                                 softcap=cap, dq_control=True)
        torch.cuda.synchronize()
    launched = profiled_instances(prof)
    say(f"  hd 256 launched as: {launched}")
    for kernel, inst in HD256_INSTANCES.items():
        n = sum(c for name, c in launched.items() if name.startswith(inst))
        if n != 2:
            failures.append(f"hd 256: {kernel} ran {n} of its 2 launches as {inst}")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for label, (B, S, Hq, Hkv), kw in (("gemma-2b", (2, 2048, 8, 1), {}),
                                       ("gemma2-9b", (1, 8192, 16, 8),
                                        dict(window=w, softcap=cap))):
        q, do = (torch.randn(B, S, Hq, 256, generator=g, device="cuda").bfloat16()
                 for _ in range(2))
        k, v = (torch.randn(B, S, Hkv, 256, generator=g, device="cuda").bfloat16()
                for _ in range(2))
        out, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
        runs = [fa.flash_attention_bwd_dq_cuda(q, k, v, out, lse, do, **kw)
                for _ in range(BWD_REPEATS)]
        same = all(torch.equal(a, b) for r in runs[1:] for a, b in zip(r, runs[0]))
        say(f"  K4 at {label}'s shape: {BWD_REPEATS} calls "
            f"{'bit for bit equal' if same else 'DIFFER'} (dq, delta)")
        if not same:
            failures.append(f"hd 256: K4's repeated calls differ at {label}'s shape")
        if label == "gemma-2b":
            delta = runs[0][1]
            split = fa.dkv_split(B, S, Hq, Hkv, 256, fa.DTYPES[torch.bfloat16])
            runs = [fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta)
                    for _ in range(BWD_REPEATS)]
            same = all(torch.equal(a, b) for r in runs[1:] for a, b in zip(r, runs[0]))
            say(f"  K5 at gemma-2b's shape, query heads split over {split} blocks a key "
                f"tile: {BWD_REPEATS} calls {'bit for bit equal' if same else 'DIFFER'}")
            if split < 2 or not same:
                failures.append(f"hd 256: K5 split {split}, repeated calls equal: {same}")
        del q, do, k, v, out, lse, runs
    return {"hd256": attention_times(torch, F, g2b, 2, 2048, errs, "hd 256 (gemma-2b)"),
            "gemma2": attention_times(torch, F, g9b, 1, 8192, errs9, "hd 256 (gemma2-9b)",
                                      window=w, softcap=cap)}


def recurrent_profile(torch, label: str, fn, n: int) -> None:
    """Device time over ``n`` calls of ``fn`` (a decode or a train step):
    busy share and the top kernels (device activity only: a train step
    launches a hundred thousand kernels).  Reports; never fails the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kern)
    gemm = sum(e.self_device_time_total for e in kern
               if any(k in e.key.lower() for k in GEMM_NAMES))
    say(f"  profile {label}: wall {wall_us / n / 1e3:.3f} ms per call, device busy "
        f"{dev_us / n / 1e3:.3f} ms ({100 * dev_us / wall_us:.1f}% of wall, idle "
        f"{100 - 100 * dev_us / wall_us:.1f}%), GEMM {gemm / n / 1e3:.3f} ms, kernel launches "
        f"{sum(e.count for e in kern) // n} per call")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:5]:
        say(f"    {e.self_device_time_total / n / 1e3:8.3f} ms x{e.count // n:<5d} {e.key[:90]}")


def serve_recurrent(torch, np, smi, arch: str) -> dict:
    """(a) ``arch`` at full width and depth, bf16, weights made on the card:
    ``stepfn.build_prefill_step`` over 8 prompts of 512 tokens, then 64
    greedy ``build_serve_step`` steps over the dense cache; exact K1/K3
    counts; then a profile of 4 decode steps."""
    from repro_torch import configs
    from repro_torch.core import stepfn
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models import transformer as T

    cfg = configs.get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for _, p in T.named_parameters(params))
    say(f"  {arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{sum(cfg.attn_layer_flags())} shared-block slots, {nbytes / 1e9:.2f} GB of weights "
        f"(bf16 matrices), made on the card in {time.perf_counter() - t0:.1f} s; "
        f"{free_card(torch)}")
    prefill, serve = stepfn.build_prefill_step(cfg), stepfn.build_serve_step(cfg)
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (SERVE_B, SERVE_S)).astype(
        np.int32)).cuda()
    warm = T.init_cache(cfg, 1, 80, device="cuda")                 # cuBLAS and allocator
    lg, warm = prefill(params, warm, {"tokens": toks[:1, :64]})
    serve(params, warm, lg.argmax(-1).int())
    del warm
    cache = T.init_cache(cfg, SERVE_B, SERVE_S + SERVE_STEPS, device="cuda")
    torch.cuda.synchronize()
    rn.launches = fa.launches = 0
    t0 = time.perf_counter()
    logits, cache = prefill(params, cache, {"tokens": toks})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    counts_p = {"rmsnorm": rn.launches, "flash_attention_fwd": fa.launches}
    out, finite = [], bool(torch.isfinite(logits).all())
    t0 = time.perf_counter()
    for _ in range(SERVE_STEPS):
        nxt = logits.argmax(-1).int()
        out.append(nxt)
        logits, cache = serve(params, cache, nxt)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    finite = finite and bool(torch.isfinite(logits).all())
    counts = {"rmsnorm": rn.launches, "flash_attention_fwd": fa.launches}
    want = serve_launches(cfg, 1 + SERVE_STEPS)
    toks_out = torch.stack(out, 1).cpu()
    say(f"  {arch} dense-cache serving on {smi}: prefill {SERVE_B} x {SERVE_S} tokens "
        f"{1e3 * t_prefill:.1f} ms ({SERVE_B * SERVE_S / t_prefill:.0f} tok/s); "
        f"{SERVE_STEPS} greedy decode steps {1e3 * t_decode / SERVE_STEPS:.2f} ms a step "
        f"({SERVE_B * SERVE_STEPS / t_decode:.1f} tok/s); overall "
        f"{SERVE_B * SERVE_STEPS / (t_prefill + t_decode):.1f} generated tok/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; cache pos {cache['pos']}")
    say(f"  launches: prefill {counts_p}, prefill + decode {counts}, expected {want}; first "
        f"tokens {toks_out[:, :8].tolist()}")
    problems = []
    if not finite:
        problems.append(f"{arch}: non-finite logits")
    if not bool(((toks_out >= 0) & (toks_out < cfg.vocab_size)).all()):
        problems.append(f"{arch}: token outside the vocabulary")
    if cache["pos"] != SERVE_S + SERVE_STEPS:
        problems.append(f"{arch}: cache position {cache['pos']}")
    if counts != want:
        problems.append(f"{arch}: launch counts {counts} != {want}")
    if problems:
        raise AssertionError("; ".join(problems))
    try:
        state = {"logits": logits}

        def one():
            state["logits"], _ = serve(params, cache, state["logits"].argmax(-1).int())

        cache["pos"] = SERVE_S + SERVE_STEPS - 4          # 4 more steps inside the cache
        recurrent_profile(torch, f"{arch} decode step, {SERVE_B} sequences", one, 4)
    except Exception as e:  # noqa: BLE001 — the breakdown is optional; say why it is missing
        say(f"  profile: not measured ({type(e).__name__}: {e})")
    del params, cache, logits
    return counts


def recurrent_parity(torch, np) -> None:
    """(b) Every published width, cut in depth, fp32, one set of weights made
    on the card and copied to the CPU: 2 prompts of 40 tokens through
    prefill and 4 greedy decode steps on each; the prefill logits (1e-3 of
    their scale), the greedy tokens (equal) and the final recurrent states
    (1e-3 of their scale)."""
    from repro_torch import configs, tree
    from repro_torch.core import stepfn
    from repro_torch.models import transformer as T

    for arch, layers in RECURRENT_PARITY.items():
        cfg = dataclasses.replace(configs.get_config(arch), num_layers=layers, dtype="float32")
        t0 = time.perf_counter()
        on_card = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
        params = {"cuda": on_card, "cpu": T.to_device(on_card, "cpu")}
        toks = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
        res = {}
        for dev in ("cuda", "cpu"):
            t1 = time.perf_counter()
            cache = T.init_cache(cfg, 2, 44, device=dev)
            lg, cache = stepfn.build_prefill_step(cfg)(params[dev], cache, {
                "tokens": torch.from_numpy(toks).to(dev)})
            first, greedy = lg.cpu(), [lg.argmax(-1).cpu()]
            for _ in range(4):
                lg, cache = stepfn.build_serve_step(cfg)(params[dev], cache,
                                                         greedy[-1].to(dev).int())
                greedy.append(lg.argmax(-1).cpu())
            res[dev] = (first, torch.stack(greedy, 1),
                        tree.tree_map(lambda t: t.float().cpu(), cache["ssm"]))
            say(f"  {arch} {dev}: prefill and 4 decode steps in {time.perf_counter() - t1:.1f} s")
        (lg_g, tok_g, st_g), (lg_c, tok_c, st_c) = res["cuda"], res["cpu"]
        err = (lg_g - lg_c).abs().max().item()
        tol = 1e-3 * max(1.0, lg_c.abs().max().item())
        st_err = max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
                     for a, b in zip(tree.leaves(st_g), tree.leaves(st_c)))
        same = torch.equal(tok_g, tok_c)
        say(f"  {arch} width {cfg.d_model}, {layers} layers, fp32: prefill logits max_abs_err="
            f"{err:.3e} tol={tol:.3e}; final recurrent state max err {st_err:.3e} of its scale "
            f"(tol 1e-3); greedy tokens equal={same} {tok_g.tolist()} (weights made in "
            f"{time.perf_counter() - t0:.1f} s)")
        if not (err <= tol and st_err <= 1e-3 and same):
            raise AssertionError(f"{arch}: card and CPU disagree")
        del on_card, params, res


def train_recurrent(torch, smi, arch: str, layers: int) -> tuple[dict, dict]:
    """(c) ``launch.train`` at ``arch``'s full width (``layers`` = 0: full
    depth), layered, partitioned, 8 x 2048 tokens in 4 micro-batches, 5
    steps: exact K1-K6 launches, finite loss and grad norm; at full depth,
    then one more step of the run's state profiled."""
    from repro_torch import configs
    from repro_torch.core import stepfn
    from repro_torch.core.accumulation import AccumConfig
    from repro_torch.data.synthetic import DataConfig, batch_for
    from repro_torch.launch import train
    from repro_torch.optim.adam import AdamConfig

    argv = ["--arch", arch, "--global-batch", "8", "--seq-len", "2048", "--microbatches",
            str(TRAIN_MB), "--steps", str(TRAIN_STEPS), "--lr", "3e-3", "--seed", str(SEED)]
    if layers:
        argv += ["--layers", str(layers)]
    cfg = configs.get_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=layers or cfg.num_layers)
    counters = train_counters()
    say(f"  before training {arch}: {free_card(torch)}")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    res = train.main(argv, keep_state=not layers)
    torch.cuda.synchronize()
    counts = read_counts(counters)
    per_step = family_step_launches(cfg, TRAIN_MB)
    want = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    for r in res["records"]:
        say(f"  step {r['step']}: {r['step_time_s']:.3f} s, {r['tokens_per_s']:.0f} tok/s, "
            f"MFU {100 * r['mfu']:.2f}% (6ND), loss {r['loss']:.4f}, grad norm "
            f"{r['grad_norm']:.4f}, max memory allocated {r['peak_mem_gb']:.2f} GB")
    steady = res["records"][1:]
    say(f"  {arch} training on {smi}: width {cfg.d_model}, {cfg.num_layers} layers, "
        f"{cfg.param_count() / 1e9:.3f} B parameters ({16 * cfg.param_count() / 1e9:.1f} GB of "
        f"fp32 state), layered + partitioned, 8 x 2048 tokens in {TRAIN_MB} micro-batches; "
        f"steady mean {sum(r['step_time_s'] for r in steady) / len(steady):.3f} s, "
        f"{sum(r['tokens_per_s'] for r in steady) / len(steady):.0f} tok/s, MFU "
        f"{100 * sum(r['mfu'] for r in steady) / len(steady):.2f}%")
    say(f"  launches over {TRAIN_STEPS} steps {counts}; per step {per_step}")
    problems = []
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in res["records"]):
        problems.append(f"{arch}: non-finite loss or grad norm")
    if counts != want:
        problems.append(f"{arch}: launch counts {counts} != {want}")
    if problems:
        raise AssertionError("; ".join(problems))
    if not layers:
        try:
            state = res.pop("state")
            step = stepfn.build_train_step(cfg, AccumConfig("layered", True, TRAIN_MB),
                                           AdamConfig(lr=3e-3, warmup_steps=1,
                                                      decay_steps=TRAIN_STEPS))
            data = DataConfig(cfg.vocab_size, 2048, 8, TRAIN_MB, seed=SEED)

            def one():
                state["storage"], state["opt"], m = step(state["storage"], state["opt"],
                                                         batch_for(cfg, data, TRAIN_STEPS))
                m["loss"].item()

            recurrent_profile(torch, f"{arch} train step", one, 1)
        except Exception as e:  # noqa: BLE001 — the breakdown is optional; say why it is missing
            say(f"  profile: not measured ({type(e).__name__}: {e})")
        res.pop("state", None)
        state = None
    return counts, res


def fused_recurrent(torch, smi, first_loss: float) -> None:
    """(d) The §C.3 fused step on (c)'s zamba2-7b cut (the shared block
    updated with the outer leaves after the step), from the same seed and
    batch: step 0's loss equal to (c)'s (1e-6), every step finite, K6 once
    per layer leaf and layer and per outer leaf a step; then one more fused
    step profiled."""
    from repro_torch import configs, tree
    from repro_torch.core import stepfn
    from repro_torch.core.accumulation import AccumConfig
    from repro_torch.data.synthetic import DataConfig, batch_for
    from repro_torch.kernels import adamw as aw
    from repro_torch.optim.adam import AdamConfig, adam_init

    cfg = dataclasses.replace(configs.get_config("zamba2-7b"),
                              num_layers=RECURRENT_TRAIN["zamba2-7b"])
    acc = AccumConfig("layered", True, TRAIN_MB)
    opt_cfg = AdamConfig(lr=3e-3, warmup_steps=max(TRAIN_STEPS // 10, 1), decay_steps=TRAIN_STEPS)
    say(f"  before the fused step: {free_card(torch)}")
    torch.cuda.reset_peak_memory_stats()
    storage = stepfn.init_storage(cfg, SEED, partitioned=True, device="cuda")
    opt = adam_init(storage)
    data = DataConfig(cfg.vocab_size, 2048, 8, TRAIN_MB, seed=SEED)
    step = stepfn.build_fused_train_step(cfg, acc, opt_cfg)
    tmpl = stepfn.full_template(cfg)
    n_layer = len(tree.leaves(tmpl["layers"]))
    want_k6 = n_layer * cfg.num_layers + len(tree.leaves(tmpl)) - n_layer
    losses = []
    for i in range(FUSED_FAMILY_STEPS):
        aw.launches = 0
        t0 = time.perf_counter()
        storage, opt, m = step(storage, opt, batch_for(cfg, data, i))
        losses.append(m["loss"].item())
        say(f"  fused step {i}: {time.perf_counter() - t0:.3f} s, loss {losses[-1]:.6f}, K6 "
            f"launches {aw.launches} (expected {want_k6}), max memory allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        if aw.launches != want_k6 or not math.isfinite(losses[-1]):
            raise AssertionError(f"fused step {i}: K6 {aw.launches} != {want_k6} or loss "
                                 f"{losses[-1]}")
    rel_ = abs(losses[0] - first_loss) / abs(first_loss)
    say(f"  fused step 0 loss {losses[0]:.6f} against (c)'s {first_loss:.6f}: rel {rel_:.2e} "
        f"(tol 1e-6)")
    if rel_ > 1e-6:
        raise AssertionError("the fused step's first loss differs from the classic run's")
    try:
        state = {"s": storage, "o": opt}

        def one():
            state["s"], state["o"], m = step(state["s"], state["o"], batch_for(cfg, data, 2))
            m["loss"].item()

        recurrent_profile(torch, "zamba2-7b 12-layer fused train step", one, 1)
    except Exception as e:  # noqa: BLE001 — the breakdown is optional; say why it is missing
        say(f"  profile: not measured ({type(e).__name__}: {e})")
    del storage, opt, state


def phase_recurrent(torch, np, smi) -> dict:
    """(a) both families served at full width and depth, (b) card against
    CPU at every width, (c) ``launch.train`` at full width, (d) the fused
    step, (e) K1/K2 at this phase's rows.  Returns the launches of (a) and
    (c)."""
    say(f"  at the start of phase 11: {free_card(torch)}")
    counts, first = {}, {}

    def add(c):
        for name, n in (c or {}).items():
            counts[name] = counts.get(name, 0) + n

    parts = [(f"a {a}", lambda a=a: add(serve_recurrent(torch, np, smi, a)))
             for a in RECURRENT_SERVE]
    parts.append(("b", lambda: recurrent_parity(torch, np)))
    for a, layers in RECURRENT_TRAIN.items():
        def run(a=a, layers=layers):
            c, res = train_recurrent(torch, smi, a, layers)
            add(c)
            first[a] = res["records"][0]["loss"]
        parts.append((f"c {a}", run))
    parts.append(("d", lambda: fused_recurrent(torch, smi, first["zamba2-7b"])))
    for part, fn in parts:
        t0 = time.perf_counter()
        fn()
        say(f"  ({part}) {time.perf_counter() - t0:.1f} s; {free_card(torch)}")
    recurrent_norm_checks(torch)          # after the counted runs: these do not count
    return counts


def recurrent_norm_checks(torch) -> None:
    """(e) K1/K2 at the rows of phase 11 that phase 2 does not hold (zamba2-7b's
    training and prefill rows [4096, 3584] are there): rwkv6-3b's final norm
    over a training micro-batch of 2 x 2048 (a prefill's 8 x 512 rows too)
    and both archs' decode rows, against their plain versions."""
    from repro_torch import configs
    failures = shape_checks(torch, configs.get_config("rwkv6-3b"), 8 // TRAIN_MB, 2048,
                            "rwkv6-3b training", attention=False)
    for arch in RECURRENT_SERVE:
        failures += shape_checks(torch, configs.get_config(arch), SERVE_B, 1,
                                 f"{arch} decode", attention=False)
    if failures:
        raise AssertionError(f"kernels at phase 11's shapes: {failures}")


# ---------------------------------------------------------------------------
# Phase 12: the pipeline for every family, and the two input modes
# ---------------------------------------------------------------------------
# (a) one stage on a world-size-1 NCCL group: zamba2-7b cut to 12 layers (the
# shared block after layers 5 and 11; one 12-layer chunk under 1f1b runs it
# twice) and dbrx-132b at phase 10's training cut (1 layer, 8 of its 16
# experts: the fp32 state of 16 is more than a card holds), the router's aux
# weight 0 in every run: the pipeline drops the aux loss, as the JAX
# executor does.  At each of FAMILY_PIPE_STEPS steps of the layered
# trajectory the pipelined step's parts are held on that step's state: each
# run's gradient against the layered one on the same storage and batch, and
# the pipelined update against the layered one on the same gradient, both to
# PIPE_GRAD_RTOL.  Each run's own trajectory is not compared: at lr 3e-3
# with one warm-up step these models carry a gradient's rounding into the
# next step's grad norm by percents (PERF.md, PR 21).
FAMILY_PIPE = {"zamba2-7b": dict(num_layers=12),
               "dbrx-132b": dict(num_layers=1, num_experts=MOE_TRAIN_EXPERTS,
                                 router_aux_weight=0.0)}
FAMILY_PIPE_RUNS = {"modular": ("modular", False), "1f1b split": ("1f1b", True)}
FAMILY_PIPE_STEPS = 3
# (b) launch.train at full width, layered and partitioned, 4 micro-batches:
# musicgen-large at full depth (48 layers, 2.424 B parameters) on 8 x 2048
# frames; llava-next-mistral-7b cut to 8 of its 32 layers (2.007 B; full
# depth's fp32 state, 115.9 GB, is more than a card holds) on 4 sequences
# of 4096 positions (the 2880-position vision prefix and 1216 text tokens)
MODES_TRAIN = {"musicgen-large": ["--global-batch", "8", "--seq-len", "2048"],
               "llava-next-mistral-7b": ["--layers", "8", "--global-batch", "4",
                                         "--seq-len", "4096"]}
# (c) card against CPU: 2 layers, fp32, 2 micro-batches of 1 x 128 positions;
# llava's vision prefix cut to 64 of them (the CPU's time)
MODES_PARITY = {"musicgen-large": {}, "llava-next-mistral-7b": {"vision_prefix_len": 64}}
# (d) K3-K5 at the two archs' training micro-batches (batch, positions)
MODES_ATTENTION = {"musicgen-large": (2, 2048), "llava-next-mistral-7b": (1, 4096)}


def family_pipeline(torch, smi, arch: str, axis) -> dict:
    """(a) ``arch``'s cut (``FAMILY_PIPE``) at one stage.  The pipeline
    storage ``init_pipeline_storage`` makes equals ``init_storage``'s, and
    is read from then on as a view of the layered storage.  Then
    ``FAMILY_PIPE_STEPS`` steps of the layered trajectory (its optimizer
    moments on the host between updates, for room), each holding on that
    step's state: every run's ``grad_fn`` against the layered one's, leaf by
    leaf (relative L2 within ``PIPE_GRAD_RTOL``, the loss equal, the hybrid's
    shared block non-zero); and, on the layered gradient, the pipelined
    update (its ``sq_reduce``: the global norm; its ``fused``: K6 on the
    layer chunks, the tree-map AdamW on the outer leaves) against the
    layered one (K6 on every leaf), leaf by leaf from the same weights and
    moments: the global norm, every weight and every moment within
    ``PIPE_GRAD_RTOL``.  The trajectory takes the layered update.  Last, one
    whole pipelined step of each run on the state reached, its K1-K6
    launches exactly the table's and its loss and grad norm finite.  Returns
    those steps' launches."""
    from repro_torch import configs, tree
    from repro_torch.core import stepfn
    from repro_torch.core.accumulation import AccumConfig
    from repro_torch.core.schedules import PipeSpec
    from repro_torch.data.synthetic import DataConfig, batch_for
    from repro_torch.optim.adam import AdamConfig, adam_update, global_norm

    cfg = dataclasses.replace(configs.get_config(arch), **FAMILY_PIPE[arch])
    L, M = cfg.num_layers, TRAIN_MB
    n_layer = len(tree.leaves(stepfn.full_template(cfg)["layers"]))
    opt_cfg = AdamConfig(lr=3e-3, warmup_steps=1, decay_steps=FAMILY_PIPE_STEPS)
    data = DataConfig(cfg.vocab_size, 2048, 8, M, seed=SEED)
    counters = train_counters()
    total = dict.fromkeys(counters, 0)
    problems = []
    specs = {label: PipeSpec(n_stages=1, layers_per_stage=L, n_microbatches=M, schedule=sc,
                             split_backward=sp) for label, (sc, sp) in FAMILY_PIPE_RUNS.items()}
    layered = stepfn.build_train_step(cfg, AccumConfig("layered", True, M), opt_cfg, axis=axis)
    piped = {label: stepfn.build_pipeline_train_step(cfg, spec, opt_cfg, partitioned=True,
                                                     axis=axis)
             for label, spec in specs.items()}
    update = next(iter(piped.values()))       # every run's update is the same
    say(f"  {arch}: width {cfg.d_model}, {L} layers, {cfg.param_count() / 1e9:.3f} B "
        f"parameters; {free_card(torch)}")

    st = stepfn.init_storage(cfg, SEED, partitioned=True, device="cuda", axis=axis)
    pst = stepfn.init_pipeline_storage(cfg, SEED, specs["modular"], partitioned=True,
                                       device="cuda", axis=axis)
    flat = dict(tree.leaves_with_path(st))
    if any(not torch.equal(p.reshape(-1), flat[k].reshape(-1))
           for k, p in tree.leaves_with_path(pst)):
        problems.append(f"{arch}: pipeline storage differs from init_storage's at one stage")
    shapes = {k: p.shape for k, p in tree.leaves_with_path(pst)}
    del pst, flat

    def pview(t: dict) -> dict:
        """A tree in the layered layout, read in the pipeline's (at one
        stage the layouts map one to one)."""
        return tree.tree_map_with_path(lambda k, x: x.view(shapes[k]), t)

    def nest(path, x) -> dict:
        for k in reversed(path):
            x = {k: x}
        return x

    def rel_l2(a, b) -> float:
        d, n = (a.reshape(-1) - b.reshape(-1)).norm().item(), b.norm().item()
        return d / n if n else d

    host = {k: tree.tree_map(lambda t: torch.zeros(t.shape, pin_memory=True), st)
            for k in ("mu", "nu")}
    opt_step = torch.zeros((), dtype=torch.int32, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    for i in range(FAMILY_PIPE_STEPS):
        t0 = time.perf_counter()
        batch = on_card(batch_for(cfg, data, i, axis))
        ref, ref_m = layered.grad_fn(st, batch)
        refs = dict(tree.leaves_with_path(ref))
        line = [f"step {i}: layered loss {ref_m['loss'].item():.6f}"]
        for label, step in piped.items():
            grads, m = step.grad_fn(pview(st), batch)
            errs = {"/".join(k): rel_l2(g, refs[k]) for k, g in tree.leaves_with_path(grads)}
            worst = max(errs, key=errs.get)
            shared = [e for k, e in errs.items() if k.startswith("shared/")]
            line.append(f"{label} {sum(e == 0.0 for e in errs.values())} of {len(errs)} leaves "
                        f"bitwise, worst {errs[worst]:.2e} ({worst})"
                        + (f", shared block's worst {max(shared):.2e}" if shared else ""))
            if errs[worst] > PIPE_GRAD_RTOL or m["loss"].item() != ref_m["loss"].item():
                problems.append(f"{arch} {label} step {i}: gradient off the layered one "
                                f"({worst} {errs[worst]:.2e} > {PIPE_GRAD_RTOL}) or loss "
                                f"{m['loss'].item()} != {ref_m['loss'].item()}")
            if any(g.abs().max().item() == 0 for k, g in tree.leaves_with_path(grads)
                   if k[0] == "shared"):
                problems.append(f"{arch} {label} step {i}: a shared-block gradient is zero")
            del grads
        # the two updates on the layered gradient, leaf by leaf from the same state
        gn_l, gs_l = global_norm(opt_cfg, ref, sq_reduce=layered.sq_reduce)
        gn_p, gs_p = global_norm(opt_cfg, pview(ref), sq_reduce=update.sq_reduce)
        g_err = rel(gn_p.item(), gn_l.item())
        w_err, m_err = {}, {}
        for (k, p), mh, vh in zip(tree.leaves_with_path(st), tree.leaves(host["mu"]),
                                  tree.leaves(host["nu"])):
            g, m, v = refs[k], mh.to("cuda"), vh.to("cuda")
            pp_, mp, vp = (x.view(shapes[k]).clone() for x in (p, m, v))
            adam_update(opt_cfg, nest(k, pp_), {"mu": nest(k, mp), "nu": nest(k, vp),
                                                "step": opt_step},
                        nest(k, g.view(shapes[k])), gs_p, fused=update.fused)
            adam_update(opt_cfg, nest(k, p), {"mu": nest(k, m), "nu": nest(k, v),
                                              "step": opt_step},
                        nest(k, g), gs_l, fused=layered.fused)
            name = "/".join(k)
            w_err[name] = rel_l2(pp_, p)
            m_err[name] = max(rel_l2(mp, m), rel_l2(vp, v))
            mh.copy_(m)
            vh.copy_(v)
            del m, v, pp_, mp, vp
        opt_step += 1
        del ref, refs, batch
        ww, wm = max(w_err, key=w_err.get), max(m_err, key=m_err.get)
        line.append(f"update on the layered gradient: grad norm {gn_l.item():.6f}, pipelined "
                    f"{g_err:.1e} off, weights' worst {w_err[ww]:.2e} ({ww}), moments' "
                    f"worst {m_err[wm]:.2e} ({wm}); {time.perf_counter() - t0:.1f} s")
        say(f"  {arch} " + "; ".join(line))
        if max(g_err, w_err[ww], m_err[wm]) > PIPE_GRAD_RTOL:
            problems.append(f"{arch} step {i}: the pipelined update off the layered one "
                            f"(grad norm {g_err:.1e}, {ww} {w_err[ww]:.2e}, {wm} "
                            f"{m_err[wm]:.2e} > {PIPE_GRAD_RTOL})")
    say(f"  {arch} checked steps: max memory allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # one whole pipelined step of each run, counted
    opt = {k: tree.tree_map(lambda t: t.to("cuda"), host[k]) for k in ("mu", "nu")}
    del host
    pst, popt = pview(st), dict({k: pview(opt[k]) for k in opt}, step=opt_step)
    for j, (label, step) in enumerate(piped.items()):
        want = pipeline_launches(cfg, specs[label].tick_table(), M, n_layer)
        b = batch_for(cfg, data, FAMILY_PIPE_STEPS + j, axis)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_counts(counters)
        t0 = time.perf_counter()
        pst, popt, m = step(pst, popt, b)
        loss, gnorm = m["loss"].item(), m["grad_norm"].item()
        dt = time.perf_counter() - t0
        counts = read_counts(counters)
        total = {k: total[k] + counts[k] for k in total}
        say(f"  {arch} pipeline {label} on {smi}: step {FAMILY_PIPE_STEPS + j} {dt:.3f} s, loss "
            f"{loss:.6f}, grad norm {gnorm:.6f}, max memory allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {counts} (want {want})")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            problems.append(f"{arch} {label}: non-finite loss or grad norm")
        if counts != want:
            problems.append(f"{arch} {label}: launch counts {counts} != {want}")
    del st, opt, pst, popt
    if problems:
        raise AssertionError("; ".join(problems))
    return total


def train_mode(torch, smi, arch: str) -> dict:
    """(b) ``launch.train`` of ``arch`` at full width (``MODES_TRAIN``),
    layered, partitioned, 4 micro-batches, 5 steps: exact K1-K6 launches,
    finite losses and grad norms, tok/s and MFU over every position."""
    from repro_torch import configs
    from repro_torch.launch import train

    argv = ["--arch", arch, "--microbatches", str(TRAIN_MB), "--steps", str(TRAIN_STEPS),
            "--lr", "3e-3", "--seed", str(SEED), *MODES_TRAIN[arch]]
    cfg = configs.get_config(arch)
    if "--layers" in argv:
        cfg = dataclasses.replace(cfg, num_layers=int(argv[argv.index("--layers") + 1]))
    B = int(argv[argv.index("--global-batch") + 1])
    S = int(argv[argv.index("--seq-len") + 1])
    counters = train_counters()
    say(f"  before training {arch}: {free_card(torch)}")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    res = train.main(argv)
    torch.cuda.synchronize()
    counts = read_counts(counters)
    per_step = family_step_launches(cfg, TRAIN_MB)
    want = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    for r in res["records"]:
        say(f"  step {r['step']}: {r['step_time_s']:.3f} s, {r['tokens_per_s']:.0f} tok/s, "
            f"MFU {100 * r['mfu']:.2f}% (6ND), loss {r['loss']:.4f}, grad norm "
            f"{r['grad_norm']:.4f}, max memory allocated {r['peak_mem_gb']:.2f} GB")
    steady = res["records"][1:]
    say(f"  {arch} training on {smi}: input mode {cfg.input_mode}, width {cfg.d_model}, "
        f"{cfg.num_layers} layers, {cfg.param_count() / 1e9:.3f} B parameters "
        f"({16 * cfg.param_count() / 1e9:.1f} GB of fp32 state), layered + partitioned, "
        f"{B} x {S} positions in {TRAIN_MB} micro-batches; steady mean "
        f"{sum(r['step_time_s'] for r in steady) / len(steady):.3f} s, "
        f"{sum(r['tokens_per_s'] for r in steady) / len(steady):.0f} tok/s, MFU "
        f"{100 * sum(r['mfu'] for r in steady) / len(steady):.2f}%, max memory allocated "
        f"{max(r['peak_mem_gb'] for r in res['records']):.2f} GB")
    say(f"  launches over {TRAIN_STEPS} steps {counts}; per step {per_step}")
    problems = []
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in res["records"]):
        problems.append(f"{arch}: non-finite loss or grad norm")
    if counts != want:
        problems.append(f"{arch}: launch counts {counts} != {want}")
    if problems:
        raise AssertionError("; ".join(problems))
    return counts


def modes_parity(torch) -> None:
    """(c) Both archs at full width, 2 layers, fp32 (``MODES_PARITY``), one
    set of weights made on the CPU and copied to the card: one layered,
    partitioned gradient pass on each; the loss to 1e-5 and the grad norm to
    1e-4 relative, every gradient leaf to 1e-4 of its scale (phase 3's
    tolerances of the loss, the grad norm and the moments, which hold the
    gradient); musicgen's embedding gradient zero on both."""
    from repro_torch import configs, tree
    from repro_torch.core import stepfn
    from repro_torch.core.accumulation import AccumConfig, make_grad_fn
    from repro_torch.data.synthetic import DataConfig, batch_for

    for arch, over in MODES_PARITY.items():
        t0 = time.perf_counter()
        cfg = dataclasses.replace(configs.get_config(arch), num_layers=2, dtype="float32",
                                  **over)
        grad_fn = make_grad_fn(cfg, AccumConfig("layered", True, 2), stepfn.full_template(cfg))
        batch = batch_for(cfg, DataConfig(cfg.vocab_size, 128, 2, 2, seed=SEED), 0)
        st = {"cpu": stepfn.init_storage(cfg, SEED, partitioned=True, device="cpu")}
        st["cuda"] = tree.tree_map(lambda t: t.to("cuda", copy=True), st["cpu"])
        out = {}
        for dev in ("cuda", "cpu"):
            grads, m = grad_fn(st.pop(dev), {k: v.to(dev) for k, v in batch.items()})
            grads = {k: g.float().cpu() for k, g in tree.leaves_with_path(grads)}
            out[dev] = (m["loss"].item(), math.sqrt(sum(g.square().sum().item()
                                                        for g in grads.values())), grads)
        (lg, ng, gg), (lc, nc, gc) = out["cuda"], out["cpu"]
        errs = {"/".join(k): (gg[k] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                for k, g in gc.items()}
        worst = max(errs, key=errs.get)
        unused = cfg.input_mode == "embeddings"        # the frames leave embed unused
        say(f"  {arch} width {cfg.d_model}, 2 layers, fp32, {dict(over) or 'as published'}, "
            f"2 x 1 x 128 positions, one layered partitioned gradient pass: loss card {lg:.6f} "
            f"cpu {lc:.6f}, grad norm card {ng:.6f} cpu {nc:.6f}; worst leaf {worst} "
            f"{errs[worst]:.2e} of its scale (tol 1e-4)"
            + (f"; embed gradient zero on both: "
               f"{all(not o[2][('embed',)].any() for o in out.values())}" if unused else "")
            + f"; {time.perf_counter() - t0:.1f} s")
        if not (math.isfinite(lg) and abs(lg - lc) <= 1e-5 * abs(lc)
                and abs(ng - nc) <= 1e-4 * abs(nc) and errs[worst] <= 1e-4):
            raise AssertionError(f"{arch}: card and CPU gradients disagree")
        if unused and any(o[2][("embed",)].any() for o in out.values()):
            raise AssertionError(f"{arch}: the unused embedding has a gradient")
        del st, out


def modes_kernel_checks(torch, F) -> None:
    """(d) K3-K5 (and K1/K2 on the rows) at both archs' training
    micro-batches against their plain versions with phase 2's
    training-shape tolerances: musicgen's MHA at head dim 64 (rep 1),
    llava's GQA at rep 4 and 4096 positions; then their times beside SDPA's
    and the bound."""
    from repro_torch import configs
    failures = []
    for arch, (B, S) in MODES_ATTENTION.items():
        cfg = configs.get_config(arch)
        errs = {}
        failures += shape_checks(torch, cfg, B, S, f"{arch} training", errs=errs)
        attention_times(torch, F, cfg, B, S, errs, f"{arch}'s training shape")
    if failures:
        raise AssertionError(f"kernels at phase 12's shapes: {failures}")


def phase_families(torch, F, smi) -> dict:
    """(a) the pipeline at one stage for zamba2-7b and dbrx-132b on a
    world-size-1 NCCL group, (b) ``launch.train`` of musicgen-large and
    llava-next-mistral-7b at full width, (c) card against CPU for both, (d)
    K3-K5 at their shapes.  Returns the launches of (a) and (b)."""
    import torch.distributed as tdist

    from repro_torch.core import dist
    say(f"  at the start of phase 12: {free_card(torch)}")
    counts = {}

    def add(c):
        for name, n in c.items():
            counts[name] = counts.get(name, 0) + n

    t0 = time.perf_counter()
    with one_rank_launch():
        axis = dist.from_env(1, 1, torch.device("cuda"), nstage=1)
        try:
            for arch in FAMILY_PIPE:
                add(family_pipeline(torch, smi, arch, axis))
                say(f"  (a) {arch} {time.perf_counter() - t0:.1f} s; {free_card(torch)}")
        finally:
            tdist.destroy_process_group()
    parts = [(f"b {a}", lambda a=a: add(train_mode(torch, smi, a))) for a in MODES_TRAIN]
    parts += [("c", lambda: modes_parity(torch)), ("d", lambda: modes_kernel_checks(torch, F))]
    for part, fn in parts:
        t0 = time.perf_counter()
        fn()
        say(f"  ({part}) {time.perf_counter() - t0:.1f} s; {free_card(torch)}")
    return counts


# ---------------------------------------------------------------------------
# Phase 13: serving over groups (a world-size-1 NCCL group)
# ---------------------------------------------------------------------------
GROUP_PAGED = {
    # arch: (layers (0: all), prompt lengths, greedy decode steps); (a) Yi-6B at
    # full depth on phase 4's weights, (b) dbrx-132b at phase 10's cut
    "yi-6b": (0, [512, 131, 256, 77, 400, 64, 300, 200], 32),
    "dbrx-132b": (8, [64, 512, 128, 320, 256, 96, 448, 200], 8),
}
GROUP_DENSE = (8, 128, 8)                    # (c): rows, prompt length, decode steps
SEQ_PREFIX, SEQ_CTX, SEQ_STEPS = 4000, 4096, 16      # (d): Yi-6B, one row
GROUP_TOL = 1e-5                             # logits, relative to their largest |value|


def kernel_launches():
    """The serving kernels' counters, K1, K3, K7."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    return {"rmsnorm": rn.launches, "flash_attention_fwd": fa.launches,
            "paged_attention_decode": pa.launches}


def group_turns(torch, axis, runs: dict, n_calls: int, counted: dict, want) -> dict:
    """Call ``runs[k](i, logits)`` for i in range(n_calls), the one-rank run
    and the group's in turns, each call synchronised and timed on the host;
    ``logits`` is that run's previous call's (None first).  The group's
    calls alone add their K1/K3/K7 launches to ``counted`` (every counter
    read just before and just after each call) and have their collective
    counts held to ``want(i)``.  Returns run -> (logits per call, ms per
    call); fails on a count."""
    out = {k: ([], []) for k in runs}
    for i in range(n_calls):
        for k, fn in runs.items():
            torch.cuda.synchronize()
            before = kernel_launches()
            axis.reset_counts()
            t0 = time.perf_counter()
            lg = fn(i, out[k][0][-1] if out[k][0] else None)
            torch.cuda.synchronize()
            out[k][1].append(1e3 * (time.perf_counter() - t0))
            out[k][0].append(lg.float())
            if k != "group":
                continue
            for name, n in kernel_launches().items():
                counted[name] = counted.get(name, 0) + n - before[name]
            got = {f"{g} {op}": v for (g, op), v in axis.counts.items()}
            if got != want(i):
                raise AssertionError(f"group call {i}: collectives {got} != {want(i)}")
    return out


def group_agreement(torch, smi, label: str, out: dict, first_decode: int) -> None:
    """The group's greedy tokens equal the one-rank run's at every call and
    its logits agree within ``GROUP_TOL`` of their scale; prints both runs'
    decode ms a step (calls from ``first_decode`` on, the first of them
    dropped: it warms the decode shapes) and the group's extra."""
    one, grp = (torch.stack(out[k][0]) for k in ("one rank", "group"))
    same = torch.equal(one.argmax(-1), grp.argmax(-1))
    err = ((grp - one).abs().max() / one.abs().max()).item()
    finite = bool(torch.isfinite(grp).all())
    ms = {k: out[k][1][first_decode + 1:] for k in out}
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    med = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
    say(f"  {label} on {smi}: {len(out['group'][1])} calls; greedy tokens equal {same}, "
        f"logits max rel err {err:.3e} (tol {GROUP_TOL:g}); decode ms a step "
        f"(mean / median over {len(ms['group'])}) one rank {mean['one rank']:.3f} / "
        f"{med['one rank']:.3f}, group {mean['group']:.3f} / {med['group']:.3f}, the group's "
        f"extra {mean['group'] - mean['one rank']:+.3f} ms "
        f"({100 * (mean['group'] / mean['one rank'] - 1):+.2f}%); "
        f"first calls ms one rank {[round(x, 1) for x in out['one rank'][1][:first_decode + 1]]}, "
        f"group {[round(x, 1) for x in out['group'][1][:first_decode + 1]]}")
    if not (same and err <= GROUP_TOL and finite):
        raise AssertionError(f"{label}: the group run left the one-rank run "
                             f"(tokens equal {same}, err {err:.3e}, finite {finite})")


def model_collectives(n_reduce: int, reduce_bytes: int, gather_bytes: int, **extra) -> dict:
    return {"model all_reduce": [n_reduce, n_reduce * reduce_bytes],
            "model all_gather": [1, gather_bytes], **extra}


def group_paged(torch, np, smi, arch: str, axis, counted: dict):
    """``GROUP_PAGED[arch]``: one set of weights (``transformer.init_params``
    on the group: at one rank every block is whole), the same ragged prompts
    and block tables through the one-rank paged steps and the group's
    (``build_paged_prefill_fn`` over ``stepfn.serve_axis``,
    ``build_paged_serve_step``), a prefill and greedy decode steps in turns;
    exact collectives and K1/K3/K7 launches a call.  Returns the weights
    (Yi-6B's are phase 4's: ``init_params``' for the seed)."""
    from repro_torch import configs
    from repro_torch.core import stepfn
    from repro_torch.core.dist import LOCAL
    from repro_torch.models import transformer as T
    from repro_torch.serving import steps
    from repro_torch.serving.cache import PagedCacheConfig, init_paged_cache

    layers, prompts, n_steps = GROUP_PAGED[arch]
    cfg = configs.get_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=layers or cfg.num_layers)
    sax = stepfn.serve_axis(cfg, axis)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda", sax)
    torch.cuda.synchronize()
    say(f"  {arch}, {cfg.num_layers} layers, bf16: weights in {time.perf_counter() - t0:.1f} s; "
        f"{free_card(torch)}")
    R, bs = len(prompts), 16
    S = -(-max(prompts) // bs) * bs
    maxb = -(-(S + n_steps) // bs)
    pcfg = PagedCacheConfig(num_blocks=R * maxb, block_size=bs, max_blocks_per_seq=maxb)
    rng = np.random.default_rng(SEED)
    toks = np.zeros((R, S), np.int32)
    for i, n in enumerate(prompts):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    toks = torch.from_numpy(toks).cuda()
    lens = torch.tensor(prompts, dtype=torch.int32, device="cuda")
    tables = torch.arange(R * maxb, dtype=torch.int32, device="cuda").view(R, maxb)
    caches = {"one rank": init_paged_cache(cfg, pcfg, "cuda"),
              "group": init_paged_cache(cfg, pcfg, "cuda", sax)}
    fns = {"one rank": (steps.build_paged_prefill_fn(cfg, LOCAL), steps.build_paged_decode_fn(cfg)),
           "group": (steps.build_paged_prefill_fn(cfg, sax),
                     steps.build_paged_serve_step(cfg, axis=axis))}

    def run(k):
        prefill, decode = fns[k]

        def call(i, prev):
            if i == 0:
                lg, caches[k] = prefill(params, caches[k], {"tokens": toks, "lens": lens}, tables)
            else:
                lg, caches[k] = decode(params, caches[k], tables, lens + i - 1,
                                       prev.argmax(-1).int())
            return lg
        return call

    L, D, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    elt = params["embed"].element_size()

    def want(i):
        rows = R * (S if i == 0 else 1)
        return model_collectives(2 * L + 1, rows * D * elt, R * V * 4)

    before = dict(counted)
    out = group_turns(torch, axis, {k: run(k) for k in fns}, n_steps + 1, counted, want)
    group_agreement(torch, smi, f"{arch} paged, {R} prompts {prompts}, prefill + {n_steps} "
                    f"decode steps", out, 1)
    got = {k: counted.get(k, 0) - before.get(k, 0) for k in counted}
    launches = {"rmsnorm": (2 * L + 1) * (n_steps + 1), "flash_attention_fwd": L,
                "paged_attention_decode": L * n_steps}
    say(f"  {arch} group launches {got} expected {launches}; collectives a decode step "
        f"{want(1)}, the prefill's {want(0)}"
        + ("; no all-to-all: at one data rank every expert is local" if cfg.is_moe else ""))
    if got != launches:
        raise AssertionError(f"{arch}: group launches {got} != {launches}")
    return params


def group_dense(torch, np, smi, arch: str, axis, counted: dict) -> None:
    """(c) ``arch`` at full width and depth through ``stepfn.build_prefill_step``
    and ``build_serve_step``, one rank and over the group, in turns: a
    prefill of ``GROUP_DENSE`` rows and greedy decode steps."""
    from repro_torch import configs, tree
    from repro_torch.core import stepfn
    from repro_torch.models import transformer as T

    B, S, n_steps = GROUP_DENSE
    cfg = configs.get_config(arch)
    sax = stepfn.serve_axis(cfg, axis)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda", sax)
    torch.cuda.synchronize()
    say(f"  {arch}, {cfg.num_layers} layers, bf16: weights in {time.perf_counter() - t0:.1f} s; "
        f"{free_card(torch)}")
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).cuda()
    caches = {"one rank": T.init_cache(cfg, B, S + n_steps, device="cuda"),
              "group": T.init_cache(cfg, B, S + n_steps, sax, device="cuda")}
    fns = {"one rank": (stepfn.build_prefill_step(cfg), stepfn.build_serve_step(cfg)),
           "group": (stepfn.build_prefill_step(cfg, axis=axis),
                     stepfn.build_serve_step(cfg, axis=axis))}

    def run(k):
        prefill, serve = fns[k]

        def call(i, prev):
            if i == 0:
                lg, caches[k] = prefill(params, caches[k], {"tokens": toks})
            else:
                lg, caches[k] = serve(params, caches[k], prev.argmax(-1).int())
            return lg
        return call

    L, D, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    n_sh = sum(cfg.attn_layer_flags()) if cfg.hybrid_attn_period > 0 else 0
    n_red = 1 + L + 2 * n_sh if cfg.block_kind == "mamba" else 1 + 2 * L
    elt = params["embed"].element_size()

    def want(i):
        return model_collectives(n_red, B * (S if i == 0 else 1) * D * elt, B * V * 4)

    before = dict(counted)
    out = group_turns(torch, axis, {k: run(k) for k in fns}, n_steps + 1, counted, want)
    group_agreement(torch, smi, f"{arch} dense cache, {B} x {S} prefill + {n_steps} decode "
                    f"steps", out, 1)
    # the recurrent states and KV slots the two runs leave behind
    one, grp = (tree.leaves({n: v for n, v in caches[k].items() if n != "pos"}) for k in fns)
    state_err = max(((b.float() - a.float()).abs().max() / a.float().abs().max().clamp(min=1e-30))
                    .item() for a, b in zip(one, grp))
    say(f"  {arch} caches after the run: max rel err {state_err:.3e} (tol {GROUP_TOL:g})")
    if not state_err <= GROUP_TOL:
        raise AssertionError(f"{arch}: the group's cache left the one-rank one ({state_err:.3e})")
    k1 = (L if cfg.block_kind == "mamba" else 0) + 2 * n_sh + 1
    launches = {"rmsnorm": k1 * (n_steps + 1), "flash_attention_fwd": n_sh}
    got = {k: counted.get(k, 0) - before.get(k, 0) for k in launches}
    say(f"  {arch} group launches {got} expected {launches}; collectives a decode step "
        f"{want(1)}, the prefill's {want(0)}")
    if got != launches:
        raise AssertionError(f"{arch}: group launches {got} != {launches}")


def group_seq(torch, np, smi, params, axis, counted: dict) -> None:
    """(d) Yi-6B (phase 4's weights), one row: a one-rank prefill of
    ``SEQ_PREFIX`` tokens into a dense cache of ``SEQ_CTX`` positions, that
    cache copied and cut by ``stepfn.shard_cache(seq_shard=True)`` (one
    shard over the group of one), then greedy decode steps against the
    unsharded cache (``build_serve_step``) and the sequence-sharded one
    (``build_serve_step(seq_shard=True)``: the softmax's max, sum and
    weighted sum reduced over the seq group), in turns."""
    from repro_torch import configs
    from repro_torch.core import stepfn
    from repro_torch.models import transformer as T

    cfg = configs.get_config("yi-6b")
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, SEQ_PREFIX)).astype(
        np.int32)).cuda()
    whole = T.init_cache(cfg, 1, SEQ_CTX, device="cuda")
    lg0, whole = stepfn.build_prefill_step(cfg)(params, whole, {"tokens": toks})
    caches = {"one rank": whole,
              "group": stepfn.shard_cache(cfg, {k: v if k == "pos" else v.clone()
                                                for k, v in whole.items()},
                                          axis, seq_shard=True)}
    fns = {"one rank": stepfn.build_serve_step(cfg),
           "group": stepfn.build_serve_step(cfg, axis=axis, seq_shard=True)}

    def run(k):
        def call(i, prev):
            lg, caches[k] = fns[k](params, caches[k], (lg0 if prev is None else prev)
                                   .argmax(-1).int())
            return lg
        return call

    L, D, V, H, hd = cfg.num_layers, cfg.d_model, cfg.vocab_size, cfg.num_heads, cfg.head_dim

    elt = params["embed"].element_size()

    def want(i):
        return model_collectives(2 * L + 1, D * elt, V * 4,
                                 **{"seq all_reduce": [3 * L, L * H * 4 * (2 + hd)]})

    before = dict(counted)
    out = group_turns(torch, axis, {k: run(k) for k in fns}, SEQ_STEPS, counted, want)
    group_agreement(torch, smi, f"yi-6b sequence-sharded dense cache (one shard), "
                    f"{SEQ_PREFIX}-token prefix in {SEQ_CTX} positions, {SEQ_STEPS} decode "
                    f"steps", out, 0)
    launches = {"rmsnorm": (2 * L + 1) * SEQ_STEPS}
    got = {k: counted.get(k, 0) - before.get(k, 0) for k in launches}
    say(f"  seq group launches {got} expected {launches}; collectives a step {want(0)}")
    if got != launches or caches["group"]["pos"] != SEQ_PREFIX + SEQ_STEPS:
        raise AssertionError(f"sequence-sharded decode: launches {got} != {launches} "
                             f"or position {caches['group']['pos']}")


def phase_group_serving(torch, np, smi) -> dict:
    """(a)-(d) on one world-size-1 NCCL group; returns the group calls' K1,
    K3 and K7 launches."""
    import torch.distributed as tdist

    from repro_torch.core import dist
    say(f"  at the start of phase 13: {free_card(torch)}")
    counted: dict = {}
    with one_rank_launch():
        axis = dist.from_env(1, 1, torch.device("cuda"))
        try:
            t0 = time.perf_counter()
            params = group_paged(torch, np, smi, "yi-6b", axis, counted)
            say(f"  (a) {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            group_seq(torch, np, smi, params, axis, counted)
            del params
            say(f"  (d) {time.perf_counter() - t0:.1f} s; {free_card(torch)}")
            t0 = time.perf_counter()
            group_paged(torch, np, smi, "dbrx-132b", axis, counted)
            say(f"  (b) {time.perf_counter() - t0:.1f} s; {free_card(torch)}")
            for arch in RECURRENT_SERVE:
                t0 = time.perf_counter()
                group_dense(torch, np, smi, arch, axis, counted)
                say(f"  (c) {arch} {time.perf_counter() - t0:.1f} s; {free_card(torch)}")
        finally:
            tdist.destroy_process_group()
    return counted


# ---------------------------------------------------------------------------
# Phase 15: the pod axis and what one card shows of the failure-shrink
# ---------------------------------------------------------------------------
POD_STEPS = 3
# the launch.train run of TRAIN_ARGV: its optimizer (warm-up max(steps // 10, 1))
POD_OPT = dict(lr=3e-3, warmup_steps=1, decay_steps=TRAIN_STEPS)


def pod_collectives(cfg, span: bool, pods: bool) -> dict:
    """The data, pod and partition groups' [calls, bytes] of one layered,
    partitioned step of ``cfg`` on a grid of one rank, reckoned from the
    code: 2 gathers (in ``cfg.dtype``) of each layer leaf a layer and one
    of each outer leaf, one fp32 reduce-scatter of each, over ``part`` under span, else
    over ``data`` (a chunk of one rank is the whole leaf); the token count
    and the metrics [nll, ntok, aux] (4 + 12 bytes) all-reduced over data,
    then pod; the grad norm's square (4 bytes) over data, and over pod too
    under span; without span every gradient's fp32 sum over pod before its
    reduce-scatter."""
    from repro_torch import tree
    from repro_torch.core import stepfn

    L = cfg.num_layers
    tmpl = stepfn.full_template(cfg)
    layer = sum(math.prod(s[1:]) for s in tree.leaves(tmpl["layers"]))
    outer = sum(math.prod(s) for k, v in tmpl.items() if k != "layers"
                for s in tree.leaves(v))
    n_ag, n_rs = 2 * N_LAYER_LEAVES * L + N_OUTER_LEAVES, N_LAYER_LEAVES * L + N_OUTER_LEAVES
    ag, rs = cfg.torch_dtype.itemsize * (2 * L * layer + outer), 4 * (L * layer + outer)
    g = "part" if span else "data"
    want = {f"{g} all_gather": (n_ag, ag), f"{g} reduce_scatter": (n_rs, rs),
            "data all_reduce": (3, 20)}
    if pods:
        want["pod all_reduce"] = (3, 20) if span else (2 + n_rs, 16 + rs)
    return want


def phase_pods(torch, smi, group_records: list, device: str = "cuda") -> dict:
    """(a) phase 6's group step and the pod axis on a world-size-1 NCCL grid
    with pod, data and model groups of one: Yi-6B at phase 5's cut, 3 steps
    each of the group step without pods, with the partition over (pod,
    data) (``span_pods``) and over data with the gradients summed over pod;
    every loss, grad norm and final state equal bit for bit to the group
    step's, whose losses and grad norms are phase 6's run's; exact
    collectives of every (group, op) and K1-K6 launches.  (b) the drain of
    a failure-shrink at one rank: the survivors' grid built, the last run's
    state drained onto the layout it is in (no rank leaves), its digest
    unchanged, the gathers counted; a ``lose_replica`` fault at data 1
    refused with the JAX package's message, the state as an unfaulted run
    leaves it."""
    import shutil

    import torch.distributed as tdist

    from repro_torch import configs, tree
    from repro_torch.core import dist, stepfn
    from repro_torch.core.accumulation import AccumConfig
    from repro_torch.data.synthetic import DataConfig, batch_for
    from repro_torch.optim.adam import AdamConfig, adam_init
    from repro_torch.resilience import faults as flt
    from repro_torch.resilience import reshard
    from repro_torch.resilience.supervisor import (Supervisor, SupervisorConfig,
                                                   SupervisorError, state_digest)

    L, M = TRAIN_LAYERS, TRAIN_MB
    cfg = dataclasses.replace(configs.get_config("yi-6b"), num_layers=L)
    opt_cfg = AdamConfig(**POD_OPT)
    data = DataConfig(cfg.vocab_size, 2048, 8, M, seed=SEED)
    lay = reshard.MeshLayout(1, 1, 1, partitioned=True, n_microbatches=M)
    counters = train_counters()
    total = dict.fromkeys(counters, 0)
    problems, runs = [], {}
    with one_rank_launch():
        axis = dist.from_env(1, 1, torch.device(device), npod=1)
        try:
            # (a) the same weights and batches on three grids of one rank
            flat = dataclasses.replace(axis, pod=None, part=None, counts={})
            for name, ax, span in (("group step", flat, False), ("span_pods", axis, True),
                                   ("pods, no span", axis, False)):
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                acc = AccumConfig("layered", True, M, span_pods=span)
                step = stepfn.build_train_step(cfg, acc, opt_cfg, axis=ax)
                storage = stepfn.init_storage(cfg, SEED, partitioned=True, device=device,
                                              axis=ax, span_pods=span)
                opt = adam_init(storage)
                reset_counts(counters)
                recs, times = [], []
                for i in range(POD_STEPS):
                    batch = batch_for(cfg, data, i, ax)
                    ax.reset_counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    storage, opt, m = step(storage, opt, batch)
                    recs.append((m["loss"].item(), m["grad_norm"].item(),
                                 {f"{g} {op}": tuple(c) for (g, op), c in ax.counts.items()}))
                    times.append(time.perf_counter() - t0)
                counts = read_counts(counters)
                total = {k: total[k] + counts[k] for k in total}
                bundle = {"params": storage, "mu": opt["mu"], "nu": opt["nu"],
                          "opt_step": opt["step"]}
                runs[name] = dict(recs=recs, times=times, counts=counts, span=span,
                                  pods=ax.pod is not None, digest=state_digest(bundle),
                                  peak=torch.cuda.max_memory_allocated() / 1e9,
                                  bundle=bundle if name == "pods, no span" else None)
                del storage, opt, step, bundle
            ref = runs["group step"]
            base = ref["recs"][0][2]
            want_launch = {k: v * POD_STEPS for k, v in TRAIN_PER_STEP.items()}
            for name, r in runs.items():
                want = pod_collectives(cfg, r["span"], r["pods"])
                say(f"  {name} on {smi}: losses {[x[0] for x in r['recs']]}, grad norms "
                    f"{[x[1] for x in r['recs']]}, step times "
                    f"{[round(t, 4) for t in r['times']]} s, max memory allocated "
                    f"{r['peak']:.2f} GB, state digest {r['digest'][:12]}; collectives of "
                    f"a step [calls, bytes] {r['recs'][0][2]}; launches {r['counts']}")
                if [x[:2] for x in r["recs"]] != [x[:2] for x in ref["recs"]] \
                        or r["digest"] != ref["digest"]:
                    problems.append(f"{name}: not the group step's losses, norms or state")
                for i, (_, _, coll) in enumerate(r["recs"]):
                    got = {k: v for k, v in coll.items() if not k.startswith("model ")}
                    model = {k: v for k, v in coll.items() if k.startswith("model ")}
                    if got != want or model != {k: v for k, v in base.items()
                                                if k.startswith("model ")}:
                        problems.append(f"{name} step {i}: collectives {coll}, want {want} "
                                        f"and the group step's model group")
                if r["counts"] != want_launch:
                    problems.append(f"{name}: launches {r['counts']} != {want_launch}")
            phase6 = [(rec["loss"], rec["grad_norm"]) for rec in group_records[:POD_STEPS]]
            if [x[:2] for x in ref["recs"]] != phase6:
                problems.append(f"the group step's losses and norms {ref['recs']} are not "
                                f"phase 6's {phase6}")

            # (b) the drain at one rank: nobody leaves, every chunk is
            # gathered and cut again
            bundle = runs["pods, no span"].pop("bundle")
            d0 = state_digest(bundle)
            axis.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grid = dist.make_axis(1, 1, npod=1, ranks=reshard.survivors(axis, 1))
            moved = reshard.drain_bundle(bundle, cfg, lay, lay, axis, keep=grid is not None)
            torch.cuda.synchronize()
            t_drain = time.perf_counter() - t0
            state_bytes = sum(t.numel() * t.element_size()
                              for t in tree.leaves({k: bundle[k] for k in ("params", "mu", "nu")}))
            coll = {f"{g} {op}": tuple(c) for (g, op), c in axis.counts.items()}
            n_leaves = len(tree.leaves(bundle["params"]))
            say(f"  the drain at one rank on {smi}: {t_drain:.3f} s for {moved / 1e9:.2f} GB "
                f"gathered (the state is {state_bytes / 1e9:.2f} GB), collectives {coll}; "
                f"the survivors' grid {grid.ranks if grid else None}; digest "
                f"{'unchanged' if state_digest(bundle) == d0 else 'CHANGED'}")
            if state_digest(bundle) != d0 or grid is None or grid.ranks != (0,):
                problems.append("the drain onto its own layout changed the state or lost the rank")
            if coll != {"data all_gather": (3 * n_leaves, state_bytes)} or moved != state_bytes:
                problems.append(f"drain collectives {coll}, {moved} bytes; want {3 * n_leaves} "
                                f"gathers of {state_bytes} bytes")
            del bundle, runs

            # the refusal at data 1, on the 2-layer cut: JAX's message, the
            # state as after the steps before it
            cfg2 = dataclasses.replace(cfg, num_layers=2)
            root = os.path.join(ROOT, "build", "phase15")
            shutil.rmtree(root, ignore_errors=True)
            sup = SupervisorConfig(checkpoint_every=100)

            def supervisor(name, plan):
                return Supervisor(cfg2, opt_cfg, data, lay, ckpt_root=os.path.join(root, name),
                                  sup=sup, fault_plan=plan, axis=flat, device=device)

            faulted = supervisor("faulted", flt.FaultPlan([flt.Fault("lose_replica", 1)]))
            try:
                faulted.run(3)
                msg = None
            except SupervisorError as e:
                msg = str(e)
            ok = supervisor("ok", None)
            ok.run(1)
            same = state_digest(faulted._bundle()) == state_digest(ok._bundle())
            say(f"  lose_replica at data 1: {msg!r}; the state {'as' if same else 'NOT as'} "
                f"an unfaulted run's after step 0")
            if msg != "cannot shrink below one data replica (step 1)" or not same:
                problems.append(f"the refusal at data 1: {msg!r}, state unchanged {same}")
            del faulted, ok
            shutil.rmtree(root, ignore_errors=True)
        finally:
            tdist.destroy_process_group()
    if problems:
        raise AssertionError("; ".join(problems))
    return total


# ---------------------------------------------------------------------------
# Phase 16: the dry run, against phase 5's measured step
# ---------------------------------------------------------------------------
DRYRUN_ARGV = ["-m", "repro_torch.launch.dryrun", "--arch", "yi-6b", "--shape", "train_4k"]
DRYRUN_TIMEOUT_S = 120


def meta_costs(torch, cfg, B: int, S: int, M: int, steps: int):
    """``roofline.analyze`` on ``meta`` tensors of the step ``launch.train``
    builds for ``cfg`` at B x S tokens in M micro-batches over ``steps``
    steps: layered + partitioned, bf16 compute over fp32 state and fp32
    moments, one rank."""
    from repro_torch import tree
    from repro_torch.core import dist as D
    from repro_torch.core import roofline, stepfn
    from repro_torch.core.accumulation import AccumConfig
    from repro_torch.launch import dryrun
    from repro_torch.optim.adam import AdamConfig

    step = stepfn.build_train_step(
        cfg, AccumConfig(method="layered", partitioned=True, n_microbatches=M),
        AdamConfig(lr=3e-3, warmup_steps=max(steps // 10, 1), decay_steps=steps))
    meta = torch.device("meta")
    storage = dryrun.storage_specs(cfg, D.LOCAL, True)
    opt = {"mu": tree.tree_map(lambda t: torch.empty_like(t, device=meta), storage),
           "nu": tree.tree_map(lambda t: torch.empty_like(t, device=meta), storage),
           "step": torch.empty((), dtype=torch.int32, device=meta)}
    batch = {k: torch.empty((M, B // M, S), dtype=torch.int32, device=meta)
             for k in ("tokens", "labels", "mask")}
    return roofline.analyze(step, storage, opt, batch, see=roofline.attention_seen(cfg, S))


def phase_dryrun(torch, smi, phase5: dict) -> None:
    """(a) ``roofline.analyze`` of phase 5's step on ``meta`` tensors
    (``stepfn.build_train_step`` as ``launch.train`` builds it from
    ``TRAIN_ARGV``: Yi-6B cut to 8 layers, bf16 compute over fp32
    partitioned state and fp32 moments, layered, 8 x 2048 tokens in 4
    micro-batches, one rank) against phase 5's records; (b) the production
    dry run of Yi-6B ``train_4k`` on the 16 x 16 grid in a subprocess."""
    from repro_torch import configs
    from repro_torch.core import roofline

    cfg = dataclasses.replace(configs.get_config("yi-6b"), num_layers=TRAIN_LAYERS)
    B, S = 8, 2048
    t0 = time.perf_counter()
    costs = meta_costs(torch, cfg, B, S, TRAIN_MB, TRAIN_STEPS)
    t_meta = time.perf_counter() - t0
    mem = costs.memory
    steady = phase5["records"][1:]
    step_s = sum(r["step_time_s"] for r in steady) / len(steady)
    peak = max(r["peak_mem_gb"] for r in phase5["records"])
    pred = mem["device_bytes"] / 1e9
    sixnd = roofline.model_flops_train(cfg, B, S)
    bound_s = max(costs.compute_s(), costs.memory_s())
    say(f"  phase 5's step on meta ({t_meta:.1f} s): predicted peak {pred:.2f} GB "
        f"(argument {mem['argument_bytes'] / 1e9:.2f}, temp {mem['temp_bytes'] / 1e9:.2f}) "
        f"against max_memory_allocated {peak:.2f} GB (ratio {pred / peak:.3f}); dot flops "
        f"{costs.dot_flops:.4e} against 6ND {sixnd:.4e} (ratio {costs.dot_flops / sixnd:.3f}); "
        f"compute {costs.compute_s():.4f} s, memory {costs.memory_s():.4f} s (HBM bytes "
        f"{costs.hbm_bytes:.4e}), bound {bound_s:.4f} s against the steady step "
        f"{step_s:.4f} s ({100 * bound_s / step_s:.1f}%) on {smi}")
    problems = []
    terms = [pred, peak, costs.dot_flops, costs.hbm_bytes, costs.compute_s(),
             costs.memory_s(), step_s]
    if not all(math.isfinite(x) for x in terms):
        problems.append(f"a term is not finite: {terms}")
    if bound_s > step_s:
        problems.append(f"the roofline bound {bound_s:.4f} s exceeds the measured step "
                        f"{step_s:.4f} s: a counting fault")
    if not 0.5 <= pred / peak <= 2.0:
        problems.append(f"predicted peak {pred:.2f} GB outside 0.5-2x of the measured "
                        f"{peak:.2f} GB")

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run([sys.executable, *DRYRUN_ARGV], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        problems.append(f"the 16 x 16 dry run failed ({out.returncode}): {out.stderr[-2000:]}")
    else:
        rep = json.loads(out.stdout)
        say(f"  yi-6b train_4k, one rank of {rep['n_chips']} (torch {torch.__version__}): "
            f"{rep['seconds']} s ({wall:.1f} s with the interpreter); memory "
            f"{json.dumps(rep['memory'])}; roofline {json.dumps(rep['roofline'])}; "
            f"collective calls {json.dumps(rep['coll_counts'])}; useful flops ratio "
            f"{rep['useful_flops_ratio']:.4f}")
        if rep["n_chips"] != 256 or not all(
                math.isfinite(v) for v in (rep["roofline"]["dot_flops"],
                                           rep["memory"]["device_bytes"])):
            problems.append(f"the 16 x 16 report is not whole: {rep}")
    if problems:
        raise AssertionError("; ".join(problems))


# ---------------------------------------------------------------------------
# Phase 17: the gemma family trained on the card
# ---------------------------------------------------------------------------
# launch.train at full width, bf16 compute over fp32 state, layered +
# partitioned: gemma-2b at full depth, 8 x 2048 tokens in 4 micro-batches
# (phase 5's batch); gemma2-9b cut to 6 layers (three local/global pairs;
# full depth's fp32 state does not fit a card), 4 x 8192 tokens in 4
# micro-batches of one sequence, so that its 4096 window cuts every local
# layer and softcap 50 runs in every layer
GEMMA_TRAIN = {"gemma-2b": dict(layers=0, batch=8, seq=2048, steps=5),
               "gemma2-9b": dict(layers=6, batch=4, seq=8192, steps=3)}
GEMMA_MB = 4


def train_family(torch, smi, arch: str, run: dict, insts: dict) -> tuple[dict, dict]:
    """``launch.train`` of ``arch`` at ``run``'s cut (layers, 0 for the
    config's depth; batch x seq tokens in ``GEMMA_MB`` micro-batches; steps):
    finite losses, exact K1-K6 launches a step (``family_step_launches``);
    then one more step on the run's state, profiled (``profile_step``:
    device ms by kernel group, the idle share; the attention kernels' share),
    whose K3, K4 and K5 launches must all be ``insts``' instances, and which
    must launch K5's partial sum once a K5 launch where K5 splits a KV head's
    query heads over blocks at the micro-batch's shape (``dkv_split``), else
    never.  Returns (the run's launches, {"records": the run's records,
    "profile": the profiled step's (device ms, launches) by kernel, "split":
    K5's split})."""
    from repro_torch import configs
    from repro_torch.core import stepfn
    from repro_torch.core.accumulation import AccumConfig
    from repro_torch.data.synthetic import DataConfig, batch_for
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train
    from repro_torch.optim.adam import AdamConfig

    cfg = configs.get_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=run["layers"] or cfg.num_layers)
    split = fa.dkv_split(run["batch"] // GEMMA_MB, run["seq"], cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim, fa.DTYPES[torch.bfloat16])
    argv = ["--arch", arch, "--global-batch", str(run["batch"]), "--seq-len", str(run["seq"]),
            "--microbatches", str(GEMMA_MB), "--steps", str(run["steps"]), "--lr", "3e-3",
            "--seed", str(SEED)] + (["--layers", str(run["layers"])] if run["layers"] else [])
    counters = train_counters()
    say(f"  before training {arch}: {free_card(torch)}")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    res = train.main(argv, keep_state=True)
    torch.cuda.synchronize()
    counts = read_counts(counters)
    per_step = family_step_launches(cfg, GEMMA_MB)
    want = {k: v * run["steps"] for k, v in per_step.items()}
    for r in res["records"]:
        say(f"  step {r['step']}: {r['step_time_s']:.3f} s, {r['tokens_per_s']:.0f} tok/s, "
            f"MFU {100 * r['mfu']:.2f}% (6ND over 989 TFLOP/s), loss {r['loss']:.4f}, grad norm "
            f"{r['grad_norm']:.4f}, max memory allocated {r['peak_mem_gb']:.2f} GB")
    steady = res["records"][1:]
    t_step = sum(r["step_time_s"] for r in steady) / len(steady)
    say(f"  {arch} training on {smi}: width {cfg.d_model}, {cfg.num_layers} layers, head dim "
        f"{cfg.head_dim}, {cfg.param_count() / 1e9:.3f} B parameters, layered + partitioned, "
        f"{run['batch']} x {run['seq']} tokens in {GEMMA_MB} micro-batches; steady mean "
        f"{t_step:.3f} s, {sum(r['tokens_per_s'] for r in steady) / len(steady):.0f} tok/s, MFU "
        f"{100 * sum(r['mfu'] for r in steady) / len(steady):.2f}%, max memory allocated "
        f"{max(r['peak_mem_gb'] for r in res['records']):.2f} GB")
    say(f"  launches over {run['steps']} steps {counts}; per step {per_step}")
    problems = []
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in res["records"]):
        problems.append(f"{arch}: non-finite loss or grad norm")
    if counts != want:
        problems.append(f"{arch}: launch counts {counts} != {want}")
    state = res.pop("state")
    step = stepfn.build_train_step(cfg, AccumConfig("layered", True, GEMMA_MB),
                                   AdamConfig(lr=3e-3, warmup_steps=1,
                                              decay_steps=run["steps"]))
    data = DataConfig(cfg.vocab_size, run["seq"], run["batch"], GEMMA_MB, seed=SEED)
    prof = profile_step(torch, step, state["storage"], state["opt"],
                        batch_for(cfg, data, run["steps"]), f"{arch} train step")
    launched = instances((k, c) for k, (_, c) in prof.items())
    attn = sum(ms for k, (ms, _) in prof.items() if re.search(ATTENTION_KERNEL, k))
    say(f"  {arch} step: attention (K3-K5) {attn:.1f} device-ms, "
        f"{100 * attn / sum(ms for ms, _ in prof.values()):.1f}% of device time; flash "
        f"instances {launched}; K5 splits a KV head's query heads over {split} blocks")
    for kernel, inst in insts.items():
        n = sum(c for name, c in launched.items() if name.startswith(inst))
        if n != per_step[kernel]:
            problems.append(f"{arch}: {n} of a step's {per_step[kernel]} {kernel} launches "
                            f"ran {inst}")
    n_sum = launched.get("dkv_sum_kernel", 0)
    if n_sum != (split > 1) * per_step["flash_attention_bwd_dkv"]:
        problems.append(f"{arch}: {n_sum} launches of K5's partial sum in a step of "
                        f"{per_step['flash_attention_bwd_dkv']} K5 launches at split {split}")
    del state, step
    say(f"  after {arch}: {free_card(torch)}")
    if problems:
        raise AssertionError("; ".join(problems))
    return counts, dict(records=res["records"], profile=prof, split=split)


def phase_gemma(torch, smi) -> dict:
    """Phase 17: ``train_family`` for each of ``GEMMA_TRAIN``, whose K3, K4
    and K5 launches must all be ``HD256_INSTANCES``; their launches."""
    out = {}
    for arch, run in GEMMA_TRAIN.items():
        for k, v in train_family(torch, smi, arch, run, HD256_INSTANCES)[0].items():
            out[k] = out.get(k, 0) + v
    return out


# ---------------------------------------------------------------------------
# Phase 18: granite-20b on the card
# ---------------------------------------------------------------------------
# granite-20b (52 layers of width 6144, 48 query heads on one KV head of 128,
# LayerNorm, plain GELU): served at full depth through launch.serve (40.63 GB
# of bf16 weights made on the card), trained through launch.train at full
# width cut to 6 layers (full depth's fp32 state, 325 GB, does not fit), 8 x
# 2048 tokens in 4 micro-batches, 3 steps
GRANITE = "granite-20b"
GRANITE_MB = (2, 2048)                       # the training micro-batch: B, S
GRANITE_SPLIT = 4                            # K5's G there (PERF.md, PR 27)
GRANITE_TRAIN = dict(layers=6, batch=8, seq=2048, steps=3)
GRANITE_SERVE_ARGV = ["--arch", GRANITE, "--requests", "8", "--rate", "0.5",
                      "--prompt-lens", "64,512,128,320,256,96,448,200", "--max-new", "16,24,32",
                      "--block-size", "16", "--num-blocks", "2048", "--max-batch", "8",
                      "--seed", str(SEED)]
# K3-K5 at granite's training micro-batch in bf16: K5 in its grouped
# instance (G = GRANITE_SPLIT), beside its partial sum, dkv_sum_kernel
GRANITE_INSTANCES = {"flash_attention_fwd": "flash_fwd_kernel_tc<128, 128>",
                     "flash_attention_bwd_dq": "flash_bwd_dq_kernel_tc<128, 128>",
                     "flash_attention_bwd_dkv": "flash_bwd_dkv_kernel_tc_grouped<128>"}


def paged_times(torch, cfg, label: str) -> dict:
    """K7 at ``cfg``'s heads, phase 2's timing shape (8 slots, contexts
    65-577, 16-token blocks, a pool of 2049 blocks, bf16): ms back to back
    from Python, as every kernel is timed, and device ms, a CUDA graph's of
    the same calls (the wrapper's host cost exceeds the kernel); the plain
    version's ms; the bound; no library call."""
    from repro_torch.kernels import paged_attention as pa
    g = torch.Generator(device="cuda").manual_seed(SEED)
    Hq, Hkv, D, bs = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 16
    ctx = [577, 65, 301, 512, 130, 449, 96, 260]
    R, N = len(ctx), 2049
    maxb = -(-max(ctx) // bs) + 1
    q = torch.randn(R, Hq, D, generator=g, device="cuda").bfloat16()
    kp, vp = (torch.randn(N, Hkv, bs, D, generator=g, device="cuda").bfloat16()
              for _ in range(2))
    bt = torch.randperm(N - 1, generator=g, device="cuda")[:R * maxb].view(R, maxb).int()
    cl = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    live = sum(ctx)
    row = dict(ms=cuda_ms(torch, lambda: pa.paged_attention_cuda(q, kp, vp, bt, cl), 200),
               device_ms=graph_ms(torch, lambda: pa.paged_attention_cuda(q, kp, vp, bt, cl)),
               plain_ms=cuda_ms(torch, lambda: pa.plain(q, kp, vp, bt, cl), 20),
               library_ms=None,
               bound=bound(2 * (2 * q.numel() + 2 * live * Hkv * D) + 4 * (bt.numel() + R),
                           4 * Hq * D * live, "bfloat16"))
    say(f"  time paged_attention_decode at {label}, q [{R}, {Hq}, {D}] kv heads {Hkv} bf16, "
        f"ctx {ctx}: kernel_ms={row['ms']:.4f} device_ms={row['device_ms']:.4f} plain_ms="
        f"{row['plain_ms']:.4f} bound_ms={row['bound'][0]:.4f} ({row['bound'][1]})")
    return row


def granite_checks(torch, F, failures) -> dict:
    """K3-K5 at granite-20b's training micro-batch (q [2, 2048, 48, 128], k/v
    [.., 1, 128]: MQA, rep 48) against their plain versions with phase 2's
    training-shape tolerances, K4's row check and its skipped-tile control
    included; the bf16 launches must be ``GRANITE_INSTANCES``.  K5 must split
    each key tile's 48 query heads over ``GRANITE_SPLIT`` blocks and give the
    same bits over ``BWD_REPEATS`` calls.  K7 at rep 48 (``paged_checks``).
    Then each kernel's time, bound and SDPA's time.  Returns {"granite":
    rows by kernel}."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    say("K3-K5 and K7 at granite-20b's shapes (MQA, rep 48, head dim 128; phase 2's "
        "training-shape tolerances)")
    cfg = configs.get_config(GRANITE)
    B, S = GRANITE_MB
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    errs = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        failures += shape_checks(torch, cfg, B, S, GRANITE, errs=errs, dq_control=True)
        torch.cuda.synchronize()
    launched = profiled_instances(prof)
    say(f"  granite-20b launched as: {launched}")
    for kernel, inst in GRANITE_INSTANCES.items():
        n = sum(c for name, c in launched.items() if name.startswith(inst))
        if n != 1:
            failures.append(f"granite-20b: {kernel} ran {n} of its 1 launch as {inst}")
    split = fa.dkv_split(B, S, Hq, Hkv, D, fa.DTYPES[torch.bfloat16])
    if launched.get("dkv_sum_kernel", 0) != (split > 1):
        failures.append(f"granite-20b: K5 at split {split} ran its partial sum "
                        f"{launched.get('dkv_sum_kernel', 0)} times")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, do = (torch.randn(B, S, Hq, D, generator=g, device="cuda").bfloat16() for _ in range(2))
    k, v = (torch.randn(B, S, Hkv, D, generator=g, device="cuda").bfloat16() for _ in range(2))
    out, lse = fa.flash_attention_fwd_cuda(q, k, v)
    _, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, out, lse, do)
    runs = [fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta) for _ in range(BWD_REPEATS)]
    same = all(torch.equal(a, b) for r in runs[1:] for a, b in zip(r, runs[0]))
    say(f"  K5 at granite-20b's shape, query heads split over {split} blocks a key tile "
        f"(kept: {GRANITE_SPLIT}): {BWD_REPEATS} calls {'bit for bit equal' if same else 'DIFFER'}")
    if split != GRANITE_SPLIT or not same:
        failures.append(f"granite-20b: K5 split {split} (the rule's G is {GRANITE_SPLIT}), "
                        f"repeated calls equal: {same}")
    del q, do, k, v, out, lse, delta, runs
    failures += paged_checks(torch, cfg, GRANITE)
    rows = attention_times(torch, F, cfg, B, S, errs, GRANITE)
    rows["paged_attention_decode"] = paged_times(torch, cfg, GRANITE)
    torch.cuda.empty_cache()
    return {"granite": rows}


def serve_granite(torch, np, smi) -> dict:
    """granite-20b at full depth through ``launch.serve.main``: bf16 weights
    made on the card from ``SEED`` (passed in, as the entry point would draw
    them), 8 requests of ``GRANITE_SERVE_ARGV``; every request's budget, the
    tokens in the vocabulary, every call's logits finite, exact K3 and K7
    launches and no K1 (LayerNorm); then 10 decode steps profiled."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.serving.cache import PagedCacheConfig
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import Request, SchedulerConfig, poisson_trace

    cfg = configs.get_config(GRANITE)
    L = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for _, p in T.named_parameters(params))
    say(f"  granite-20b: {L} layers, d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} "
        f"heads of {cfg.head_dim}, {n_params / 1e9:.3f} B parameters in bf16, made on the card "
        f"in {time.perf_counter() - t0:.1f} s; {free_card(torch)}")
    warm_engine(cfg, params)
    with finite_logits(torch) as finite:
        torch.cuda.synchronize()
        rn.launches = fa.launches = pa.launches = 0
        res = serve.main(GRANITE_SERVE_ARGV, params=params)
        counts = {"rmsnorm": rn.launches, "flash_attention_fwd": fa.launches,
                  "paged_attention_decode": pa.launches}
    want = {"rmsnorm": 0, "flash_attention_fwd": L * res["prefill_calls"],
            "paged_attention_decode": L * res["decode_steps"]}
    peak = torch.cuda.max_memory_allocated() / 1e9
    say(f"  granite-20b engine on {smi}: {res['requests']} requests, {res['emitted_tokens']} "
        f"tokens, {res['prefill_calls']} prefill calls, {res['decode_steps']} decode steps, "
        f"{res['preemptions']} preemptions in {res['seconds']:.3f} s -> {res['tok_per_s']:.1f} "
        f"tok/s; TTFT ms p50 {res['ttft_ms']['p50']:.2f} p99 {res['ttft_ms']['p99']:.2f}; ITL ms "
        f"p50 {res['itl_ms']['p50']:.2f} p99 {res['itl_ms']['p99']:.2f}; peak memory "
        f"{peak:.2f} GB")
    say(f"  launches {counts} expected {want}")
    a = dict(zip(GRANITE_SERVE_ARGV[::2], GRANITE_SERVE_ARGV[1::2]))
    reqs = poisson_trace(np.random.default_rng(SEED), n_requests=int(a["--requests"]),
                         rate=float(a["--rate"]), vocab=cfg.vocab_size,
                         prompt_lens=[int(x) for x in a["--prompt-lens"].split(",")],
                         max_new=[int(x) for x in a["--max-new"].split(",")])
    out = res["outputs"]
    problems = []
    if sorted(out) != sorted(r.rid for r in reqs) or any(
            len(out[r.rid]) != r.max_new_tokens for r in reqs):
        problems.append("not every request finished its budget")
    if any(not 0 <= t < cfg.vocab_size for toks in out.values() for t in toks):
        problems.append("token outside the vocabulary")
    if not finite or not bool(torch.stack(finite).all()):
        problems.append("non-finite logits")
    if counts != want:
        problems.append(f"launch counts {counts} != {want}")
    if problems:
        raise AssertionError("granite-20b serving: " + "; ".join(problems))
    rng = np.random.default_rng(SEED + 1)
    eng = ServingEngine(cfg, params, SchedulerConfig(
        cache=PagedCacheConfig(num_blocks=512, block_size=16, max_blocks_per_seq=36),
        max_batch=8))
    eng.submit_all([Request(rid=i, prompt=tuple(int(t) for t in rng.integers(
        0, cfg.vocab_size, 256)), max_new_tokens=40) for i in range(8)])
    eng.step()                                        # prefill of all 8, first decode
    eng.step()
    decode_profile(torch, eng, "granite-20b, contexts ~260")
    del eng, params
    return counts


def granite_dryrun(torch) -> float:
    """``meta_costs`` of ``GRANITE_TRAIN``'s run: its predicted peak GB,
    printed."""
    from repro_torch import configs

    run = GRANITE_TRAIN
    cfg = dataclasses.replace(configs.get_config(GRANITE), num_layers=run["layers"])
    mem = meta_costs(torch, cfg, run["batch"], run["seq"], GEMMA_MB, run["steps"]).memory
    pred = mem["device_bytes"] / 1e9
    say(f"  the dry run of granite-20b's {run['layers']}-layer training step on meta: "
        f"predicted peak {pred:.2f} GB (argument {mem['argument_bytes'] / 1e9:.2f}, temp "
        f"{mem['temp_bytes'] / 1e9:.2f})")
    return pred


def phase_granite(torch, F, np, smi) -> tuple[dict, dict]:
    """Phase 18: (a) the kernels at granite-20b's shapes (``granite_checks``),
    (b) granite-20b served at full depth, (c) its dry-run peak and
    ``train_family`` at ``GRANITE_TRAIN``'s cut (the profiled step's K5
    launches the split ``dkv_split`` chose, ``GRANITE_SPLIT``), the measured
    peak within 0.5-2x of the prediction.  Returns the launches of (b) and
    (c), and (a)'s rows by kernel."""
    t0 = time.perf_counter()
    failures = []
    rows = granite_checks(torch, F, failures)["granite"]
    if failures:
        raise AssertionError(f"kernels at granite-20b's shapes: {failures}")
    say(f"  (a) {time.perf_counter() - t0:.1f} s; {free_card(torch)}")
    counts = {}
    t0 = time.perf_counter()
    for name, c in serve_granite(torch, np, smi).items():
        counts[name] = counts.get(name, 0) + c
    say(f"  (b) {time.perf_counter() - t0:.1f} s; {free_card(torch)}")
    t0 = time.perf_counter()
    pred = granite_dryrun(torch)
    train_counts, res = train_family(torch, smi, GRANITE, GRANITE_TRAIN, GRANITE_INSTANCES)
    for name, c in train_counts.items():
        counts[name] = counts.get(name, 0) + c
    prof = res["profile"]
    total = sum(ms for ms, _ in prof.values())
    gemm = sum(ms for k, (ms, _) in prof.items() if any(n in k.lower() for n in GEMM_NAMES))
    attn = sum(ms for k, (ms, _) in prof.items() if re.search(ATTENTION_KERNEL, k))
    peak = max(r["peak_mem_gb"] for r in res["records"])
    say(f"  granite-20b step: device {total:.1f} ms, GEMM {gemm:.1f} ms, attention (K3-K5) "
        f"{attn:.1f} ms ({100 * attn / total:.1f}%), elementwise and the rest "
        f"{total - gemm - attn:.1f} ms; peak {peak:.2f} GB against the dry run's {pred:.2f} GB "
        f"(ratio {pred / peak:.3f})")
    say(f"  (c) {time.perf_counter() - t0:.1f} s; {free_card(torch)}")
    problems = []
    if res["split"] != GRANITE_SPLIT:
        problems.append(f"K5 split {res['split']} at the training micro-batch, not "
                        f"{GRANITE_SPLIT}")
    if not 0.5 <= pred / peak <= 2.0:
        problems.append(f"predicted peak {pred:.2f} GB outside 0.5-2x of the measured "
                        f"{peak:.2f} GB")
    if problems:
        raise AssertionError("granite-20b training: " + "; ".join(problems))
    return counts, rows


KERNELS = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:24"),
    "rmsnorm_bwd": ("src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
                    "src/repro/kernels/rmsnorm.py:33"),
    "flash_attention_fwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:63"),
    "flash_attention_bwd_dq": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                               "src/repro/kernels/flash_attention.py:133"),
    "flash_attention_bwd_dkv": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                                "src/repro/kernels/flash_attention.py:171"),
    "adamw": ("src/repro_torch/kernels/csrc/adamw.cu",
              "src/repro/kernels/adamw.py:34"),
    "paged_attention_decode": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                               "src/repro/kernels/paged_attention.py:40"),
}


def main() -> int:
    t_all = time.perf_counter()
    try:
        import numpy as np
        import torch
        import torch.nn.functional as F
    except ImportError as e:
        say(f"chip_smoke: {e}")
        return 1
    if not torch.cuda.is_available():
        say("chip_smoke: no CUDA device is available; this script runs on the card only")
        return 1
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        say(f"chip_smoke: the port is not beside this script ({e})")
        return 1
    try:
        t0 = time.perf_counter()
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _, build_s = _build.build()
        _build.library()
        report = ptxas_report(_build.build_log())
        spills = {k: r for k, r in report.items() if r.get("spill_stores")}
        missing = [i for i in HD256_INSTANCES.values() if i not in report]
        if missing:
            raise AssertionError(f"phase 1: no -Xptxas -v record of {missing}")
        spilled = [i for i in HD256_INSTANCES.values()
                   if report[i].get("spill_stores") or report[i].get("spill_loads")]
        if spilled:
            raise AssertionError(f"phase 1: the head dim 256 instances {spilled} spill")
        say(smi)
        say(f"[phase 1] card {torch.cuda.get_device_name(0)} ({smi}); tf32 off for matmul "
            f"and cudnn; nvcc build {build_s:.1f} s, {len(report)} kernel instances, "
            f"spilling: {spills or 'none'}; head dim 256 instances: "
            f"{ {k: r for k, r in report.items() if k.startswith('flash_') and '256' in k} }; "
            f"{time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        rows = phase_kernels(torch, F)
        say(f"[phase 2] kernels agree with their plain versions; {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        phase_parity(torch, np)
        phase_train_parity(torch)
        say(f"[phase 3] full-width card vs CPU parity ok; {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        serve_counts = phase_engine(torch, np, smi)
        say(f"[phase 4] full Yi-6B engine run ok; {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        train_counts, phase5 = phase_train(torch, smi)
        say(f"[phase 5] full-width Yi-6B training run ok; {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        group_counts, t_group, group_records = phase_group(torch, smi, phase5)
        say(f"[phase 6] the process-group path and the fused update ok; "
            f"{time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        pipe_counts = phase_pipeline(torch, smi, phase5, t_group)
        say(f"[phase 7] the pipeline ok; {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        sup_counts = phase_supervised(torch, smi)
        say(f"[phase 8] checkpoints, faults and telemetry on the card ok; "
            f"{time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        plan_counts = phase_plan(torch, smi)
        say(f"[phase 9] plan-driven launch ok; {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        moe_counts = phase_moe(torch, np, smi)
        say(f"[phase 10] the mixture-of-experts family ok; {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        recurrent_counts = phase_recurrent(torch, np, smi)
        say(f"[phase 11] the recurrent families ok; {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        family_counts = phase_families(torch, F, smi)
        say(f"[phase 12] the pipeline for every family and the two input modes ok; "
            f"{time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        group_serve_counts = phase_group_serving(torch, np, smi)
        say(f"[phase 13] serving over a group ok; {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        pod_counts = phase_pods(torch, smi, group_records)
        say(f"[phase 15] the pod axis and the drain on one card ok; "
            f"{time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        phase_dryrun(torch, smi, phase5)
        say(f"[phase 16] the dry run: phase 5's step reckoned and the 16 x 16 grid ok; "
            f"{time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        gemma_counts = phase_gemma(torch, smi)
        say(f"[phase 17] the gemma family trained on the card ok; "
            f"{time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        granite_counts, granite_rows = phase_granite(torch, F, np, smi)
        for name, r in granite_rows.items():
            rows[name]["granite"] = r
        say(f"[phase 18] granite-20b's kernels held, served at full depth and trained at "
            f"full width ok; {time.perf_counter() - t0:.1f} s")
    except Exception:  # noqa: BLE001 — report any phase's failure and exit nonzero
        traceback.print_exc()
        return 1

    # launches: the serving run's, the training run's, phases 6's, 7's, 8's,
    # 9's (the plan-driven run's), 10's (the MoE serving and training runs),
    # 11's (the recurrent families' serving and training runs), 12's (the
    # families' pipelines and the input modes' training runs), 13's (the
    # group serving calls), 15's (the pod axis's training runs), 17's (the
    # gemma training runs) and 18's (granite-20b's serving and training runs)
    counts = {name: sum(c.get(name, 0) for c in (
        serve_counts, train_counts, group_counts, pipe_counts, sup_counts, plan_counts,
        moe_counts, recurrent_counts, family_counts, group_serve_counts, pod_counts,
        gemma_counts, granite_counts))
        for name in KERNELS}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": rows[name]["max_abs_err"],
         "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
         "bound_ms": rows[name]["bound"][0], "bound_by": rows[name]["bound"][1],
         "library_ms": rows[name]["library_ms"],
         **({"device_ms": rows[name]["device_ms"]} if "device_ms" in rows[name] else {}),
         **{f"{hd}_{key}": (rows[name][hd]["bound"][0] if key == "bound_ms"
                            else rows[name][hd][key])
            for hd in ("hd112", "hd256", "gemma2", "granite", "fp32") if hd in rows[name]
            for key in ("ms", "bound_ms", "library_ms")}}
        for name, (src, rep) in KERNELS.items()]}
    say(f"[phase 14] total {time.perf_counter() - t_all:.1f} s")
    say(smi)
    say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
