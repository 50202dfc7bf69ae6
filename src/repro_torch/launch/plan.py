"""Config auto-search CLI: from analysis to an executable plan (counterpart
of ``repro/launch/plan.py``; the documents have that package's keys, and
its numbers where the constants are the same).

Paper-scale analysis (closed forms + event simulation, on the paper's A100
of its table A.1):

  PYTHONPATH=src python -m repro_torch.launch.plan --arch paper-x --size 160
  PYTHONPATH=src python -m repro_torch.launch.plan --arch paper-x --size 160 \\
      --net ethernet --grid reduced --out plan_x160.json

Executable plan for a registry arch (counted costs, scored at the H100's
peak and NVLink rate; ``--devices 0`` plans for every card of the machine):

  PYTHONPATH=src python -m repro_torch.launch.plan --arch gemma-2b --smoke \\
      --devices 4 --global-batch 8 --out plan_gemma.json
  PYTHONPATH=src python -m repro_torch.launch.plan --arch yi-6b --layers 8 \\
      --global-batch 8 --seq-len 2048 --microbatches 1,2,4,8 --out plan.json
  PYTHONPATH=src python -m repro_torch.launch.train --plan plan.json

The paper-x document reports the full ranked plan list, the winner, the
conventional 3d baseline and the speedup between them (table 6.1's headline
comparison, ~1.9x at x=160).
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.core import calculator as calc
from repro_torch.planner import plan as planlib
from repro_torch.planner import search as searchlib

NETS = {"ib": "ib", "ethernet": "ethernet", "nvlink": "nvlink"}


def _print_paper_table(doc: dict) -> None:
    cols = ("family", "n_a", "n_l", "n_b", "n_mu", "b_mu", "n_gpu",
            "time_days", "sim_time_days")
    widths = {c: max(len(c), 9) for c in cols}
    widths["family"] = 26
    print("  ".join(c.ljust(widths[c]) for c in cols))
    for r in doc["plans"]:
        print("  ".join(str(r.get(c, "-")).ljust(widths[c]) for c in cols))
    win = doc["winner"]
    print(f"\nwinner: {win['family']}  n_a={win['n_a']} n_l={win['n_l']} "
          f"n_mu={win['n_mu']} b_mu={win['b_mu']} n_gpu={win['n_gpu']} "
          f"-> {win.get('sim_time_days', win['time_days'])} days")
    if "baseline_3d" in doc:
        b = doc["baseline_3d"]
        print(f"3d baseline: {b['family']}  n_l={b['n_l']} n_mu={b['n_mu']} "
              f"n_gpu={b['n_gpu']} -> "
              f"{b.get('sim_time_days', b['time_days'])} days")
        print(f"speedup vs 3d baseline: {doc['speedup_vs_3d_baseline']}x "
              f"(paper table 6.1: ~1.9x)")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="search distributed-training configurations and emit a "
                    "JSON plan")
    ap.add_argument("--arch", required=True,
                    help="'paper-x' (analysis, with --size) or a registry "
                         "arch (executable smoke plan, with --smoke)")
    ap.add_argument("--size", type=int, default=160,
                    help="x of the X_[x] family (paper-x mode)")
    ap.add_argument("--net", default="ib", choices=sorted(NETS),
                    help="inter-node link for the paper-x analysis")
    ap.add_argument("--grid", default="full", choices=["full", "reduced"])
    ap.add_argument("--top", type=int, default=12,
                    help="ranked plans to print / save")
    ap.add_argument("--simulate-top", type=int, default=12)
    ap.add_argument("--max-sims", type=int, default=64)
    ap.add_argument("--max-gpus", type=int, default=100_000,
                    help="prune plans needing more GPUs (0 = unlimited)")
    ap.add_argument("--split-backward", action="store_true",
                    help="paper-x mode: also enumerate the zero-bubble "
                         "split-backward variant of every pipelined "
                         "candidate (dgrad + deferred wgrad ticks; the "
                         "simulator gap-fills wgrads into bubble slots). "
                         "Smoke plans always rank both variants.")
    ap.add_argument("--smoke", action="store_true",
                    help="plan for the reduced (CPU-friendly) config of a "
                         "registry arch; without it the execution plan "
                         "targets the full-size config")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers at full width (0: the "
                         "config's depth); recorded in the plan's execution")
    ap.add_argument("--devices", type=int, default=0,
                    help="cards to plan for (0 = every card of this machine)")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--microbatches", default="1,2,4",
                    help="comma-separated n_mu candidates for --smoke")
    ap.add_argument("--stages", default="1",
                    help="comma-separated pipeline-stage candidates for "
                         "--smoke (S > 1 plans a stage x data x model mesh "
                         "running the modular pipeline)")
    ap.add_argument("--out", default=None, help="write the plan JSON here")
    ap.add_argument("--dump-table", action="store_true",
                    help="print the winner's embedded tick table (the "
                         "schedule-as-data contract launch.train interprets)")
    ap.add_argument("--format", default="json", choices=["json", "chrome"],
                    help="--dump-table output: the table JSON itself, or a "
                         "Chrome-trace (Perfetto-loadable) rendering of the "
                         "simulator's predicted timeline for it, written "
                         "through the shared obs/trace.py writer")
    ap.add_argument("--table-out", default=None,
                    help="file for --dump-table --format chrome (default "
                         "tick_table_trace.json)")
    args = ap.parse_args(argv)

    if args.arch.startswith("paper-x") or args.arch == "paper-x":
        x = args.size
        if args.arch not in ("paper-x", f"paper-x{x}"):
            x = int(args.arch.removeprefix("paper-x"))
        hw = calc.Hardware()
        net = getattr(hw, NETS[args.net])
        plans = searchlib.search(x, hw, net=net, grid=args.grid,
                                 simulate_top=args.simulate_top,
                                 max_sims=args.max_sims,
                                 max_gpus=args.max_gpus or None,
                                 split_backward=args.split_backward)
        doc = planlib.paper_plan_document(x, plans, net_name=args.net,
                                          top=args.top)
        _print_paper_table(doc)
    else:
        devices = args.devices
        if devices <= 0:
            devices = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if devices <= 0:
                ap.error("--devices 0 plans for this machine's cards, and it has none: "
                         "pass --devices N")
        mus = tuple(int(v) for v in args.microbatches.split(","))
        stages = tuple(int(v) for v in args.stages.split(","))
        doc = planlib.smoke_plan_document(
            args.arch, devices=devices, global_batch=args.global_batch,
            seq_len=args.seq_len, steps=args.steps, microbatch_options=mus,
            stage_options=stages, smoke=args.smoke, layers=args.layers)
        shown = {k: v for k, v in doc["execution"].items()
                 if k != "tick_table"}
        print(json.dumps(shown, indent=1))
        print(f"({len(doc['plans'])} ranked executions; winner above)")
        if args.dump_table:
            tt = doc["execution"].get("tick_table")
            if tt is None:
                print("(winner is not pipelined: no tick table)")
            else:
                from repro_torch.planner.simulator import TickTable
                tab = TickTable.from_json(tt)
                split = (f" split_backward (residual ring depth "
                         f"{tab.residual_depth()})" if tab.is_split else "")
                print(f"tick table: schedule={tab.schedule} "
                      f"S={tab.n_stages} V={tab.n_chunks} "
                      f"k_c={tab.layers_per_chunk} M={tab.n_microbatches} "
                      f"T={tab.n_ticks}{split}")
                if args.format == "chrome":
                    _dump_table_chrome(tab, args.table_out
                                       or "tick_table_trace.json")
                else:
                    print(json.dumps(tt))

    if args.out:
        planlib.save_plan(doc, args.out)
        print(f"plan written to {args.out}")
    return doc


def _dump_table_chrome(tab, path: str) -> str:
    """Render the table's simulator-predicted timeline as a Chrome trace via
    the shared timeline writer — a unit cost model (fwd 1s, bwd 2s per
    layer), so the trace shows the schedule's *shape* (bubbles, interleaving,
    ring hops), not absolute hardware time."""
    from repro_torch.core.schedules import PipeSpec
    from repro_torch.obs import trace as obs_trace
    from repro_torch.planner.simulator import CostModel, simulate

    spec = PipeSpec(tab.n_stages, tab.n_chunks * tab.layers_per_chunk,
                    tab.n_microbatches, tab.schedule,
                    n_chunks=tab.n_chunks, split_backward=tab.is_split)
    cost = CostModel(flops_fwd_layer=1.0, flops_bwd_layer=2.0,
                     act_bytes=0.0, layer_param_bytes=0.0,
                     layer_grad_bytes=0.0, flops_rate=1.0,
                     p2p_bw=1.0, coll_bw=1.0)
    res = simulate(spec.sim_config(), cost, record_timeline=True)
    tracer = obs_trace.Tracer()
    obs_trace.add_timeline(tracer, res.timeline, pid=0,
                           name=f"planned {tab.schedule} "
                                f"S={tab.n_stages} M={tab.n_microbatches}",
                           scale_us=1e6)
    tracer.save(path)
    print(f"chrome trace ({len(res.timeline)} units) written to {path}")
    return path


if __name__ == "__main__":
    main()
