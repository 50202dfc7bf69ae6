#!/usr/bin/env python3
"""Serve the port over the cards of one host, each run held to the same
work on one card of the same call.

Three parts, one world of 4 ranks (each part makes its own groups over it):

  yi    Yi-6B over a model group of 4 (1x4): 8 ragged prompts through the
        paged prefill, then greedy decode steps of
        ``serving.steps.build_paged_serve_step``;
  dbrx  dbrx-132b over 2 data x 2 model ranks (2x2, the serving layout:
        8 experts a data rank, their hidden dim halved, tokens exchanged by
        all-to-all), the same paged run;
  seq   Yi-6B over a seq group of 4 (4x1): a dense cache of ``CTX``
        positions filled to ``PREFIX`` from one seeded tensor that every
        rank draws alike, each rank decoding on its quarter of the sequence
        (``stepfn.build_serve_step(seq_shard=True)``).

Each part runs in bf16 at full depth (dbrx: ``--dbrx-layers``, 40 by
default), where its times are taken, and again in fp32 at ``CHECK_LAYERS``,
where its logits must match one card's within ``FP32_TOL``: rank 0 serves
the same model on its card alone, fed the group's greedy tokens.  The bf16
runs are compared with one card too (dbrx at each of ``DBRX_ONE_CARD``
layers, depths that fit one card) and the comparison is reported, not
gated: a bf16 rounding of a sum split over ranks flips near-tied greedy
tokens and, in dbrx, router choices.  For dbrx each comparison also counts,
call by call, the (token, layer) pairs whose top-k experts differ between
the group and one card, and serves one card again with the group's expert
choices replayed (its own router probabilities as the combine weights), so
that what the flips account for shows.  Every rank draws its own block of
the weights layer by layer on its card (``transformer.init_params`` with
its axis).  Rank 0 prints each run's prefill ms (the second of two
prefills), decode ms a step (mean over the steps after the first), weights
and peak memory a rank, the collectives of a decode step, and the logits'
largest difference from one card and the calls whose greedy tokens all
agree, beside the card's name and power limit, and writes them, with the
per-call lists, to ``OUT/serve_cards.json``.

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        tools/torch_serve_cards.py OUT

With ``--smoke --device cpu`` it runs the smoke configs on gloo, for a
rehearsal.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

SEED = 0
PROMPTS = [512, 131, 256, 77, 400, 64, 300, 200]
FP32_TOL = 1e-4          # fp32 logits against one card, relative to the call's largest |logit|
CHECK_LAYERS = 2         # the fp32 checks' depth
DBRX_ONE_CARD = (2, 8)   # dbrx's bf16 depths held to one card (8 is the most that fits)
CTX, PREFIX = 32768, 32000           # the seq part's cache and its filled positions
SMOKE_PROMPTS, SMOKE_CTX, SMOKE_PREFIX = [32, 13, 20, 7, 25, 9, 16, 30], 64, 50


def main() -> int:
    import numpy as np
    import torch
    import torch.distributed as tdist

    from repro_torch import configs
    from repro_torch.core import dist, stepfn
    from repro_torch.core.dist import LOCAL
    from repro_torch.device import resolve_device
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as T
    from repro_torch.serving import steps
    from repro_torch.serving.cache import PagedCacheConfig, init_paged_cache

    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--dbrx-layers", type=int, default=40)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    world = int(os.environ["WORLD_SIZE"])
    base = dist.from_env(1, world, device)
    rank = tdist.get_rank()
    if cuda:
        from repro_torch.kernels import _build
        if rank == 0:
            _build.build()
        tdist.barrier()
        _build.library()
    prompts = SMOKE_PROMPTS if args.smoke else PROMPTS
    ctx, prefix = (SMOKE_CTX, SMOKE_PREFIX) if args.smoke else (CTX, PREFIX)
    router = {"record": None, "replay": None}
    moe_router = moe_mod._router

    def routed(cfg, p, x):
        """``moe._router``, recording each call's expert ids (a list a call
        in ``router["record"]``) or taking the recorded ones in order
        (``router["replay"]``) with this run's own probabilities."""
        weights, ids, aux = moe_router(cfg, p, x)
        if router["replay"] is not None:
            ids = router["replay"].pop(0)
            probs = torch.softmax(x.float() @ p["router"].float(), dim=-1).gather(-1, ids)
            weights = probs / probs.sum(-1, keepdim=True)
        if router["record"] is not None:
            router["record"][-1].append(ids)
        return weights, ids, aux

    moe_mod._router = routed

    def routes_for(replay):
        """Start recording (and, with ``replay``, replaying) a run's routes."""
        router["record"] = []
        router["replay"] = None if replay is None else [i for call in replay for i in call]
        return router["record"]

    def new_call():
        router["record"].append([])

    def routes_done():
        assert not router["replay"], "the replayed routes were not all used"
        router["record"] = router["replay"] = None

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def say(*a):
        if rank == 0:
            print(*a, flush=True)

    def peak_gb() -> float:
        return torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0

    def every_rank(x: float) -> list:
        t = torch.tensor([x], dtype=torch.float64, device=device)
        g = torch.empty(world, dtype=t.dtype, device=device)
        tdist.all_gather_into_tensor(g, t)
        return [round(v, 2) for v in g.tolist()]

    def free():
        import gc
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def cfg_of(arch: str, layers: int = 0, dtype: str | None = None):
        cfg = configs.get_config(arch, smoke=args.smoke)
        return dataclasses.replace(cfg, num_layers=layers or cfg.num_layers,
                                   dtype=dtype or cfg.dtype)

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        return r, 1e3 * (time.perf_counter() - t0)

    def counts(axis) -> dict:
        return {f"{g} {op}": list(v) for (g, op), v in axis.counts.items()}

    def paged_run(cfg, axis, params, feed=None, replay=None) -> dict:
        """Two paged prefills (the second timed), then ``args.steps`` decode
        steps, greedy on this run's logits or on ``feed``'s (the group's);
        an MoE's routes recorded, or ``replay``'s taken."""
        R, bs = len(prompts), 16
        S = -(-max(prompts) // bs) * bs
        maxb = -(-(S + args.steps) // bs)
        pcfg = PagedCacheConfig(num_blocks=R * maxb, block_size=bs, max_blocks_per_seq=maxb)
        rng = np.random.default_rng(SEED)
        toks = np.zeros((R, S), np.int32)
        for i, n in enumerate(prompts):
            toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
        batch = {"tokens": torch.from_numpy(toks).to(device),
                 "lens": torch.tensor(prompts, dtype=torch.int32, device=device)}
        lens = batch["lens"]
        tables = torch.arange(R * maxb, dtype=torch.int32, device=device).view(R, maxb)
        sax = stepfn.serve_axis(cfg, axis)
        cache = init_paged_cache(cfg, pcfg, device, sax)
        prefill = steps.build_paged_prefill_fn(cfg, sax)
        decode = (steps.build_paged_decode_fn(cfg) if axis is LOCAL
                  else steps.build_paged_serve_step(cfg, axis=axis))
        routes = routes_for(replay)
        new_call()
        prefill(params, cache, batch, tables)          # NCCL, cuBLAS and allocator warm-up
        new_call()
        (lg, cache), pre_ms = timed(lambda: prefill(params, cache, batch, tables))
        logits, ms = [lg], []
        for i in range(args.steps):
            nxt = (feed[i] if feed is not None else logits[-1]).argmax(-1).int()
            axis.reset_counts()
            new_call()
            (lg, cache), dt = timed(lambda: decode(params, cache, tables, lens + i, nxt))
            logits.append(lg)
            ms.append(dt)
        routes_done()
        return {"logits": logits, "prefill_ms": pre_ms, "decode_ms": ms,
                "collectives": counts(axis), "routes": routes}

    def seq_run(cfg, axis, params, feed=None) -> dict:
        """``args.steps`` decode steps on a dense cache of one row filled to
        ``prefix`` from one seeded draw (the whole cache on one card, this
        rank's shard of the sequence over a group)."""
        whole = T.init_cache(cfg, 1, ctx, device=device)
        gen = torch.Generator(device=device).manual_seed(SEED + 1)
        for name in ("k", "v"):
            for layer in whole[name]:
                layer[:, :, :prefix].normal_(generator=gen)
        whole["pos"] = prefix
        if axis is LOCAL:
            cache, step = whole, stepfn.build_serve_step(cfg)
        else:
            cache = stepfn.shard_cache(cfg, whole, axis, seq_shard=True)
            step = stepfn.build_serve_step(cfg, axis=axis, seq_shard=True)
            del whole
        first = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (1,)).astype(np.int32)).to(device)
        logits, ms = [], []
        for i in range(args.steps):
            prev = (feed if feed is not None else logits)[i - 1] if i else None
            nxt = first if prev is None else prev.argmax(-1).int()
            axis.reset_counts()
            (lg, cache), dt = timed(lambda: step(params, cache, nxt))
            logits.append(lg)
            ms.append(dt)
        return {"logits": logits, "prefill_ms": None, "decode_ms": ms,
                "collectives": counts(axis), "positions_a_rank": cache["k"].shape[3]}

    def summary(r: dict) -> dict:
        steady = r["decode_ms"][1:]
        return {"prefill_ms": r["prefill_ms"], "decode_ms_mean": sum(steady) / len(steady),
                "decode_ms_median": sorted(steady)[len(steady) // 2], "decode_ms": r["decode_ms"],
                "collectives_a_step": r["collectives"],
                **({"positions_a_rank": r["positions_a_rank"]} if "positions_a_rank" in r else {})}

    def compare(group: dict, one: dict) -> dict:
        """Each call's largest |difference| over its largest |logit| (and the
        worst call's), the calls whose greedy tokens all agree and, for an
        MoE, each call's (token, layer) pairs whose top-k experts differ."""
        err = [((g - o).abs().max() / o.abs().max()).item()
               for g, o in zip(group["logits"], one["logits"])]
        same = sum(bool(torch.equal(g.argmax(-1), o.argmax(-1)))
                   for g, o in zip(group["logits"], one["logits"]))
        res = {"max_rel_err": max(err), "calls_with_equal_tokens": same,
               "calls": len(err), "rel_err": err}
        if any(group.get("routes") or ()):
            # the warm-up prefill's routes dropped: a call a logits entry
            flips = [sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                         for a, b in zip(gc, oc))
                     for gc, oc in zip(group["routes"][1:], one["routes"][1:])]
            res |= {"router_flips": flips,
                    "routed": [sum(a.shape[0] for a in gc) for gc in group["routes"][1:]],
                    "calls_with_flips": sum(f > 0 for f in flips)}
        return res

    def part(run, cfg, axis, one_card_depths=()) -> dict:
        """``run`` over the group, then on rank 0's card alone, fed the
        group's tokens (for an MoE, once more with the group's routes); with
        ``one_card_depths`` (depths that fit one card) the one-card
        comparisons are made by parts at those depths."""
        free()
        params = T.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device,
                               stepfn.serve_axis(cfg, axis))
        wbytes = sum(t.numel() * t.element_size() for _, t in T.named_parameters(params))
        grp = run(cfg, axis, params)
        res = {"layers": cfg.num_layers, "dtype": cfg.dtype, "group": summary(grp),
               "weights_gb": every_rank(wbytes / 1e9), "peak_gb": every_rank(peak_gb())}
        del params
        if one_card_depths:
            res["at_one_card_depth"] = [part(run, dataclasses.replace(cfg, num_layers=n), axis)
                                        for n in one_card_depths]
            return res
        free()
        if rank == 0:
            params = T.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
            one = run(cfg, LOCAL, params, feed=grp["logits"])
            res["one_card"] = summary(one) | {"peak_gb": peak_gb()}
            res["vs_one_card"] = compare(grp, one)
            del one
            if cfg.is_moe:
                one = run(cfg, LOCAL, params, feed=grp["logits"], replay=grp["routes"])
                res["vs_one_card_group_routes"] = compare(grp, one)
                del one
            del params
        free()
        tdist.barrier()
        return res

    results: dict = {"world": world}
    meshes = {"yi": (1, world), "dbrx": (2, world // 2), "seq": (world, 1)}
    for name, (d, m) in meshes.items():
        axis = base if (d, m) == (1, world) else dist.make_axis(d, m)
        arch = "dbrx-132b" if name == "dbrx" else "yi-6b"
        run = seq_run if name == "seq" else paged_run
        bf16 = (part(run, cfg_of(arch, args.dbrx_layers), axis, DBRX_ONE_CARD)
                if name == "dbrx" else part(run, cfg_of(arch), axis))
        fp32 = part(run, cfg_of(arch, CHECK_LAYERS, "float32"), axis)
        results[name] = {"mesh": f"{d}x{m}", "bf16": bf16, "fp32": fp32}
        say(f"{name} {d}x{m}: {json.dumps(drop_lists(results[name]))}")

    bad = []
    if rank == 0:
        try:
            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 check=True).stdout.strip().splitlines()[0]
        except (OSError, subprocess.CalledProcessError):
            smi = f"no nvidia-smi ({device})"
        results["card"] = smi
        (out_dir / "serve_cards.json").write_text(json.dumps(results, indent=1))
        for name in meshes:
            r = results[name]
            g = r["bf16"]["group"]
            print(f"{name} {r['mesh']} bf16, {r['bf16']['layers']} layers, on {world} x {smi}: "
                  f"decode {g['decode_ms_mean']:.3f} ms a step (median "
                  f"{g['decode_ms_median']:.3f}), prefill {g['prefill_ms'] or 0:.1f} ms, weights "
                  f"{r['bf16']['weights_gb'][0]:.2f} GB and peak {max(r['bf16']['peak_gb']):.2f} "
                  f"GB a rank", flush=True)
            for near in r["bf16"].get("at_one_card_depth", [r["bf16"]]):
                vs = near["vs_one_card"]
                line = (f"{name} {r['mesh']} bf16 at {near['layers']} layers against one card: "
                        f"decode {near['group']['decode_ms_mean']:.3f} vs "
                        f"{near['one_card']['decode_ms_mean']:.3f} ms, logits max rel err "
                        f"{vs['max_rel_err']:.3e}, tokens equal at "
                        f"{vs['calls_with_equal_tokens']} of {vs['calls']} calls")
                if "router_flips" in vs:
                    rp = near["vs_one_card_group_routes"]
                    line += (f"; router flips in {vs['calls_with_flips']} of {vs['calls']} calls "
                             f"({vs['router_flips'][0]} of {vs['routed'][0]} (token, layer) "
                             f"pairs in the prefill, {sum(vs['router_flips'][1:])} of "
                             f"{sum(vs['routed'][1:])} in the decode steps); with the group's "
                             f"routes replayed: max rel err {rp['max_rel_err']:.3e}, tokens "
                             f"equal at {rp['calls_with_equal_tokens']} of {rp['calls']} calls")
                print(line, flush=True)
            vs = r["fp32"]["vs_one_card"]
            print(f"{name} {r['mesh']} fp32, {r['fp32']['layers']} layers: logits max rel err "
                  f"{vs['max_rel_err']:.3e} (tol {FP32_TOL:g}), tokens equal at "
                  f"{vs['calls_with_equal_tokens']} of {vs['calls']} calls", flush=True)
            if not (vs["max_rel_err"] <= FP32_TOL and vs["calls_with_equal_tokens"] == vs["calls"]):
                bad.append(name)
    flag = torch.tensor([len(bad)], device=device)
    tdist.all_reduce(flag)
    tdist.destroy_process_group()
    if bad:
        print(f"the fp32 group runs {bad} left the one-card run", flush=True)
    return 1 if flag.item() else 0


def drop_lists(res):
    """``res`` without its per-call lists, for the printed line."""
    if isinstance(res, dict):
        return {k: drop_lists(v) for k, v in res.items()
                if k not in ("decode_ms", "rel_err", "router_flips", "routed")}
    if isinstance(res, list):
        return [drop_lists(v) for v in res]
    return res


if __name__ == "__main__":
    sys.exit(main())
