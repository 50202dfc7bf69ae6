#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root; needs nvcc

Phases, each printing its own lines and its seconds; any failure exits
nonzero and prints no result:

  1. the card (name and power limit from nvidia-smi) and the nvcc build of
     every kernel from the sources in the checkout;
  2. each CUDA kernel against its plain PyTorch version on the card: the
     shapes the Yi-6B serving path gives it in bf16 and fp32, plus window,
     softcap, MQA, ragged-length, head-dim 64/256 and idle-row cases; at the
     path shapes, the kernel's time, the plain version's, one PyTorch
     library call's where one computes the same function (a yardstick the
     port never calls) and the card's bound;
  3. parity: Yi-6B at full width cut to 2 layers, fp32, one set of weights
     made on the CPU and copied to the card; 3 ragged prompts through prefill
     and 4 decode steps on the card (kernels) and on the CPU (plain versions);
  4. the full model: Yi-6B, 32 layers, bf16, weights made on the card, served
     by ``ServingEngine`` over a seeded Poisson trace, with the exact kernel
     launch counts of the run; then a ``torch.profiler`` window over decode
     steps and a prefill call (device busy share, device time by kernel
     group), which reports and never fails the run;
  5. the ``kernels`` line, and as the last line
     ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
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


def say(*parts) -> None:
    print(*parts, flush=True)


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


def bf16_ulp(scale: float) -> float:
    """One bf16 ulp at the output's scale (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(scale, 2.0 ** -100))) - 7)


def tolerance(torch, ref) -> float:
    if ref.dtype == torch.bfloat16:
        return bf16_ulp(ref.float().abs().max().item())
    return FP32_TOL


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_case(torch, name, got, want, failures) -> float:
    torch.cuda.synchronize()
    outs = got if isinstance(got, tuple) else (got,)
    refs = want if isinstance(want, tuple) else (want,)
    errs = []
    for part, g, w in zip(("", " [lse]"), outs, refs):
        if g.shape != w.shape or g.dtype != w.dtype:
            failures.append(f"{name}: {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
            return float("inf")
        err = (g.float() - w.float()).abs().max().item()
        tol = tolerance(torch, w)
        errs.append(err)
        ok = err <= tol and bool(torch.isfinite(g.float()).all())
        say(f"  {name}{part}: max_abs_err={err:.3e} tol={tol:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)
    return errs[0]


def phase_kernels(torch, F):
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
    say("K3 flash_attention_fwd (out and lse; fp32 tol 1e-4, bf16 out tol one ulp)")
    main = None
    for (B, S, Hq, Hkv, D), dtype, kw in [
            ((8, 512, 32, 4, 128), torch.bfloat16, dict(causal=True)),
            ((8, 512, 32, 4, 128), torch.float32, dict(causal=True)),
            ((2, 512, 32, 4, 128), torch.bfloat16, dict(causal=True, window=128, softcap=50.0)),
            ((2, 300, 16, 1, 128), torch.bfloat16, dict(causal=True)),            # MQA
            ((3, 77, 8, 2, 128), torch.float32, dict(causal=True, kv_len=70)),   # odd S, pad keys
            ((2, 300, 8, 2, 64), torch.bfloat16, dict(causal=True, window=40)),
            ((2, 256, 8, 4, 256), torch.bfloat16, dict(causal=True, window=64, softcap=50.0)),
            ((2, 50, 4, 2, 64), torch.float32, dict(causal=False, kv_len=41))]:
        q, k, v = randn(B, S, Hq, D, dtype=dtype), randn(B, S, Hkv, D, dtype=dtype), \
            randn(B, S, Hkv, D, dtype=dtype)
        err = check_case(torch, f"q={[B, S, Hq, D]} kv_heads={Hkv} {str(dtype)[6:]} {kw}",
                         fa.flash_attention_fwd_cuda(q, k, v, **kw), fa.plain(q, k, v, **kw),
                         failures)
        main = main or (q, k, v, err)
    q, k, v, err = main
    B, S, Hq, D = q.shape
    es = q.element_size()
    pairs = S * (S + 1) // 2                                  # causal, live (q, k) pairs
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    rows["flash_attention_fwd"] = dict(
        shape=f"q [{B}, {S}, {Hq}, {D}] k/v [{B}, {S}, {k.shape[2]}, {D}] bf16 causal",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: fa.flash_attention_fwd_cuda(q, k, v), 10),
        plain_ms=cuda_ms(torch, lambda: fa.plain(q, k, v), 3),
        library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 10),
        bound=bound(es * (2 * q.numel() + 2 * k.numel()) + 4 * B * Hq * S,
                    4 * B * Hq * D * pairs, "bfloat16"))

    # -- K7 paged decode: 8 slots, 32 q / 4 KV heads, hd 128, 16-token blocks, 2048+1 pool
    say("K7 paged_attention_decode (fp32 tol 1e-4, bf16 tol one ulp)")
    main = None
    for R, Hq, Hkv, D, bs, dtype, kw, ctx in [
            (8, 32, 4, 128, 16, torch.bfloat16, {}, [577, 65, 301, 512, 130, 449, 96, 260]),
            (8, 32, 4, 128, 16, torch.float32, {}, [577, 65, 301, 512, 130, 449, 96, 260]),
            (6, 32, 4, 128, 16, torch.bfloat16, {}, [0, 1, 17, 0, 333, 5]),        # idle rows
            (5, 32, 4, 128, 8, torch.bfloat16, {}, [9, 23, 57, 101, 287]),         # odd, bs 8
            (4, 16, 8, 256, 16, torch.bfloat16, dict(window=100, softcap=50.0), [31, 150, 400, 513]),
            (4, 8, 1, 256, 16, torch.float32, {}, [40, 257, 3, 199]),              # MQA, hd 256
            (3, 48, 1, 128, 16, torch.bfloat16, {}, [70, 300, 16]),                # rep 48
            (4, 8, 2, 64, 16, torch.float32, dict(window=20), [1, 44, 90, 210])]:
        maxb = -(-max(ctx) // bs) + 1
        N = 2049
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
        main = main or (qd, kp, vp, bt, cl, err)
    qd, kp, vp, bt, cl, err = main
    R, Hq, D = qd.shape
    Hkv = kp.shape[1]
    es = qd.element_size()
    live = int(cl.sum())
    rows["paged_attention_decode"] = dict(
        shape=f"q [{R}, {Hq}, {D}] pools [{kp.shape[0]}, {Hkv}, {kp.shape[2]}, {D}] "
              f"bf16, ctx {cl.tolist()}",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: pa.paged_attention_cuda(qd, kp, vp, bt, cl), 200),
        plain_ms=cuda_ms(torch, lambda: pa.plain(qd, kp, vp, bt, cl), 20),
        library_ms=None,
        bound=bound(es * (2 * qd.numel() + 2 * live * Hkv * D) + 4 * (bt.numel() + R),
                    4 * Hq * D * live, "bfloat16"))
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


# ---------------------------------------------------------------------------
# Phase 4: the full model through the serving engine
# ---------------------------------------------------------------------------
def phase_engine(torch, np, smi):
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models import transformer as T
    from repro_torch.serving import steps
    from repro_torch.serving.cache import PagedCacheConfig
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import Request, SchedulerConfig, poisson_trace

    cfg = configs.get_config("yi-6b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for _, p in T.named_parameters(params))
    say(f"  Yi-6B: {cfg.num_layers} layers, d_model {cfg.d_model}, {n_params / 1e9:.3f} B "
        f"parameters in bf16, made on the card in {time.perf_counter() - t0:.1f} s")

    # warm-up on a small pool (cuBLAS handles, allocator); not counted
    warm = ServingEngine(cfg, params, SchedulerConfig(
        cache=PagedCacheConfig(num_blocks=64, block_size=16, max_blocks_per_seq=8),
        max_batch=2))
    warm.submit(Request(rid=0, prompt=tuple(range(1, 65)), max_new_tokens=4))
    warm.run()
    del warm

    # every prefill/decode call's logits must be finite: checked on the card,
    # read once at the end
    finite = []
    wrapped = {n: getattr(steps, n) for n in ("paged_prefill_step", "paged_decode_step")}

    def probe(fn):
        def step(*a, **kw):
            logits, cache = fn(*a, **kw)
            finite.append(torch.isfinite(logits).all())
            return logits, cache
        return step

    reqs = poisson_trace(np.random.default_rng(SEED), n_requests=16, rate=0.5,
                         vocab=cfg.vocab_size,
                         prompt_lens=[64, 512, 128, 320, 256, 96, 448, 200],
                         max_new=[32, 48, 64])
    pcfg = PagedCacheConfig(num_blocks=2048, block_size=16, max_blocks_per_seq=36)
    eng = ServingEngine(cfg, params, SchedulerConfig(cache=pcfg, max_batch=8))
    eng.submit_all(reqs)
    for n, fn in wrapped.items():
        setattr(steps, n, probe(fn))
    try:
        torch.cuda.synchronize()
        rn.launches = fa.launches = pa.launches = 0
        t0 = time.perf_counter()
        out = eng.run(max_steps=2000)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {"rmsnorm": rn.launches, "flash_attention_fwd": fa.launches,
                  "paged_attention_decode": pa.launches}
    finally:
        for n, fn in wrapped.items():
            setattr(steps, n, fn)
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
KERNELS = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:24"),
    "flash_attention_fwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:63"),
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
        log = _build.build_log().splitlines()
        spills = [ln.strip() for ln in log if "spill" in ln and " 0 bytes spill stores" not in ln]
        say(smi)
        say(f"[phase 1] card {torch.cuda.get_device_name(0)} ({smi}); tf32 off for matmul "
            f"and cudnn; nvcc build {build_s:.1f} s, {sum('Compiling entry' in ln for ln in log)} "
            f"kernel instances, spilling: {spills or 'none'}; {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        rows = phase_kernels(torch, F)
        say(f"[phase 2] kernels agree with their plain versions; {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        phase_parity(torch, np)
        say(f"[phase 3] full-width card vs CPU parity ok; {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        counts = phase_engine(torch, np, smi)
        say(f"[phase 4] full Yi-6B engine run ok; {time.perf_counter() - t0:.1f} s")
    except Exception:  # noqa: BLE001 — report any phase's failure and exit nonzero
        traceback.print_exc()
        return 1

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": rows[name]["max_abs_err"],
         "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
         "bound_ms": rows[name]["bound"][0], "bound_by": rows[name]["bound"][1],
         "library_ms": rows[name]["library_ms"]}
        for name, (src, rep) in KERNELS.items()]}
    say(f"[phase 5] total {time.perf_counter() - t_all:.1f} s")
    say(smi)
    say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
