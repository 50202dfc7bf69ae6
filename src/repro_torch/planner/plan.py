"""Plan documents: the JSON contract between the planner and the launchers
(a copy of ``repro/planner/plan.py``, which the port may not import; the
documents are that package's, key for key).

Two kinds of plan:

  * paper-scale analysis plans (``kind: "paper-x"``): the ranked output of
    ``search.search`` for an X_[x] model — table 6.1 generalized to the full
    (schedule x method x partition x mesh) space.  These describe clusters
    far larger than any test machine; they are *analysis* artifacts.

  * executable smoke plans (``kind: "execution"``): a small grid over mesh
    factorizations / accumulation methods for a registry arch, sized to the
    local device count.  The winner's ``execution`` dict is directly
    consumable by ``launch.train --plan`` (either package's), closing the
    loop from analysis to real steps.

``python -m repro_torch.launch.plan`` produces either kind; see that module.
The executable plans' scores use a card's peak flops and link bandwidth,
the H100's (``core/roofline.py``) unless others are passed: given the JAX
package's TPU constants, the port writes that package's documents.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

from repro_torch.core import roofline
from repro_torch.planner import search as searchlib

PLAN_VERSION = 1


# ---------------------------------------------------------------------------
# Paper-scale analysis plans
# ---------------------------------------------------------------------------
def paper_plan_document(x: int, plans: list, *, net_name: str = "ib",
                        top: int = 12) -> dict:
    base, win = searchlib.baseline_and_winner(plans)
    doc: dict[str, Any] = {
        "version": PLAN_VERSION,
        "kind": "paper-x",
        "x": x,
        "net": net_name,
        "steps": searchlib.STEPS,
        "plans": [p.row() for p in plans[:top]],
        "winner": win.row(),
    }
    if base is not None:
        doc["baseline_3d"] = base.row()
        doc["speedup_vs_3d_baseline"] = round(
            base.best_time_s / win.best_time_s, 3)
    return doc


def save_plan(doc: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, default=str)


def load_plan(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("version", 0) > PLAN_VERSION:
        raise ValueError(f"plan version {doc['version']} is newer than this "
                         f"planner ({PLAN_VERSION})")
    return doc


def execution_of(doc: dict) -> dict:
    """The execution dict of a plan document (winner's, for ranked docs)."""
    if "execution" in doc:
        return doc["execution"]
    win = doc.get("winner", {})
    if "execution" in win:
        return win["execution"]
    raise ValueError("plan document carries no execution section "
                     "(paper-x analysis plans are not directly runnable; "
                     "generate an execution plan with --smoke)")


def shrink_execution(ex: dict, *, data: int) -> dict:
    """Re-validate an execution section for a mesh shrunk along `data`.

    The supervisor's failure-shrink path calls this before resharding:
    dropping a data-axis replica changes the per-device batch shard, so the
    surviving mesh must still divide the plan's batch — and the schedule's
    tick table stays valid (it never depends on the data extent).  Returns
    a copy of ``ex`` with the new mesh; raises ``ValueError`` with the
    offending arithmetic when the shrunk mesh cannot run the plan."""
    if data < 1:
        raise ValueError(f"shrunk data extent must be >= 1, got {data}")
    old_d, model = (int(v) for v in ex.get("mesh", "1x1").split("x"))
    if data > old_d:
        raise ValueError(f"shrink cannot grow the data axis: {old_d} -> {data}")
    gb, mb = ex.get("global_batch", 1), ex.get("microbatches", 1)
    if gb % mb:
        raise ValueError(f"plan batch {gb} not divisible by "
                         f"microbatches {mb}")
    if (gb // mb) % data:
        raise ValueError(
            f"cannot shrink to data={data}: per-microbatch batch "
            f"{gb}//{mb} = {gb // mb} is not divisible by the surviving "
            f"data extent (pick a batch with more factors, or shrink to a "
            f"divisor)")
    if ex.get("partitioned") and ex.get("stages", 1) > 1 and data < 1:
        raise ValueError("partitioned pipeline storage needs data >= 1")
    out = dict(ex)
    out["mesh"] = f"{data}x{model}"
    return out


# ---------------------------------------------------------------------------
# Executable smoke plans (registry archs, local device counts)
# ---------------------------------------------------------------------------
def _factorizations(n: int) -> list[tuple[int, int]]:
    return [(d, n // d) for d in range(1, n + 1) if n % d == 0]


def smoke_plan_document(arch: str, *, devices: int, global_batch: int = 8,
                        seq_len: int = 64, steps: int = 5,
                        microbatch_options: tuple[int, ...] = (1, 2, 4),
                        stage_options: tuple[int, ...] = (1,),
                        smoke: bool = True, layers: int = 0,
                        peak_flops: float = roofline.PEAK_FLOPS,
                        link_bw: float = roofline.LINK_BW) -> dict:
    """Rank executable (stage-mesh, method, partition, n_mu) combos for
    ``arch`` on ``devices`` local devices, using roofline-traced per-layer
    costs.  ``smoke`` selects the reduced config (and is recorded in the
    plan, so ``launch.train --plan`` runs the same config that was costed).

    ``stage_options`` adds pipelined candidates: each stage count S > 1
    splits the devices into a stage x data x model mesh and ranks every
    executable schedule (modular / 1f1b / interleaved), each in unsplit AND
    zero-bubble split-backward form, priced from its simulator-emitted tick
    table — T ticks of one masked chunk VJP + head VJP + three ring permutes
    each, exactly the generic executor's per-tick cost
    (simulator.predict_spmd_composition).  Split tables run MORE ticks of the
    same per-tick bundle (each backward unit becomes a dgrad + a wgrad tick),
    so the formula prices them honestly on this lockstep executor; their
    wall-clock win lives in the event simulator's overlap accounting, not
    here.  The winner's ``execution`` section carries the
    ``stages``/``schedule``/``split_backward`` fields AND the embedded
    ``tick_table`` JSON, so ``launch.train --plan`` interprets the very
    table that was scored (schedule-as-data).

    Scoring mirrors the paper's accounting at smoke scale: per-device compute
    (fwd + recompute + transposed dots), data-axis ZeRO/reduction bytes
    placed per the accumulation method (layered overlaps them, standard
    serializes the end-of-step psum), and un-overlapped per-layer tensor-
    parallel psums.  Absolute times are meaningless on CPU; the *ranking*
    follows the same mechanics the paper-scale search uses.

    ``peak_flops`` and ``link_bw`` are the card's dense peak and the link the
    collectives run at (the H100's by default; the JAX package scores with a
    TPU's).  ``layers`` (0: the config's depth) cuts the depth at full width,
    as ``launch.train --layers`` does; a nonzero cut is recorded in the
    execution section, which is otherwise the JAX package's key for key.
    Like the JAX package's, the scoring has no memory check.
    """
    from repro_torch import configs
    from repro_torch.core.schedules import PipeSpec
    from repro_torch.planner import simulator as simlib
    from repro_torch.planner import validate as V

    # ranked preference among equal scores: paper schedule first (it is the
    # flop/byte minimum or ties it at K == 1, where all three coincide)
    sched_rank = {"modular": 0, "interleaved": 1, "1f1b": 2}

    cfg0 = configs.get_config(arch, smoke=smoke)
    if layers:
        cfg0 = dataclasses.replace(cfg0, num_layers=layers)
    rows = []
    tables: dict[tuple, simlib.TickTable] = {}
    for S in sorted(set(stage_options)):
        if devices % S:
            continue
        for d, mdl in _factorizations(devices // S):
            cfg = cfg0.padded_for_tp(mdl) if mdl > 1 else cfg0
            L = cfg.num_layers
            if S > 1 and L % S:
                continue
            K = L // S
            for M in microbatch_options:
                if global_batch % (M * d) or global_batch < M * d:
                    continue
                mb_local = global_batch // (M * d)
                tc = V.traced_layer_costs(cfg, mb_local, seq_len)
                f_dev = tc.flops_fwd_layer / mdl
                head_dev = tc.flops_head / mdl
                ring_d = (d - 1) / d if d > 1 else 0.0
                ring_m = (mdl - 1) / mdl if mdl > 1 else 0.0
                # un-overlapped Megatron psums: ~4 per layer per micro-batch
                # (attn out + mlp out, fwd + bwd), payload = one activation
                tp_s = (4.0 * K * M * 2.0 * ring_m * tc.act_bytes
                        / link_bw)
                # (schedule, split, compute_s, p2p_s, table) candidates
                cands = []
                if S == 1:
                    compute_s = (4.0 * K * M * f_dev
                                 + 3.0 * M * head_dev) / peak_flops
                    cands.append((None, False, compute_s, 0.0, None))
                else:
                    for sched in ("modular", "interleaved", "1f1b"):
                        for split in (False, True):
                            try:
                                spec = PipeSpec(S, K, M, sched,
                                                split_backward=split)
                                table = tables.get((S, K, M, sched, split))
                                if table is None:
                                    table = spec.tick_table()
                                    tables[(S, K, M, sched, split)] = table
                            except (AssertionError, simlib.DeadlockError):
                                continue    # infeasible for this schedule
                            T_ = table.n_ticks
                            k_c = table.layers_per_chunk
                            # the generic executor's per-tick cost: one masked
                            # chunk VJP + one masked head VJP + 3 ring
                            # permutes (simulator.predict_spmd_composition);
                            # split tables pay the same bundle over more ticks
                            compute_s = T_ * (3.0 * k_c * f_dev
                                              + 3.0 * head_dev) \
                                / peak_flops
                            p2p_s = (3.0 * T_ * tc.act_bytes
                                     / link_bw)
                            cands.append((sched, split, compute_s, p2p_s,
                                          table))
                for sched, split, compute_s, p2p_s, table in cands:
                    for method in (("layered",) if S > 1
                                   else ("layered", "standard")):
                        for part in ((False, True) if d > 1 else (False,)):
                            if part:
                                if S > 1:
                                    # tick executor: gather + scatter each
                                    # chunk once per pass (no AD re-gather)
                                    data_bytes = (2.0 * ring_d * K
                                                  * tc.layer_bytes
                                                  + 2.0 * ring_d
                                                  * tc.outer_bytes)
                                else:
                                    per_layer = 3.0 * ring_d * tc.layer_bytes
                                    n_coll = K * (M if method == "standard"
                                                  else 1)
                                    data_bytes = (
                                        n_coll * per_layer
                                        + 3.0 * ring_d * tc.outer_bytes
                                        * (M if method == "standard" else 1))
                            else:
                                data_bytes = 2.0 * ring_d * (
                                    K * tc.layer_bytes + tc.outer_bytes)
                            data_s = data_bytes / link_bw
                            if method == "layered":
                                step_s = max(compute_s, data_s) + tp_s + p2p_s
                            else:
                                step_s = compute_s + data_s + tp_s + p2p_s
                            rows.append({
                                "mesh": f"{d}x{mdl}",
                                "stages": S,
                                "schedule": sched,
                                "split_backward": split,
                                "n_ticks": (table.n_ticks if table is not None
                                            else None),
                                "method": method,
                                "partitioned": part,
                                "microbatches": M,
                                "score_step_s": step_s,
                                "compute_s": compute_s,
                                "data_coll_s": data_s,
                                "tp_coll_s": tp_s,
                                "p2p_s": p2p_s,
                            })
    if not rows:
        raise ValueError(
            f"no feasible execution for arch={arch} devices={devices} "
            f"global_batch={global_batch} microbatches={microbatch_options} "
            f"stages={stage_options}")
    rows.sort(key=lambda r: (r["score_step_s"], not r["partitioned"],
                             sched_rank.get(r["schedule"], 0),
                             r["split_backward"]))
    win = rows[0]
    execution = {
        "arch": arch,
        "smoke": smoke,
        "mesh": win["mesh"],
        "method": win["method"],
        "partitioned": win["partitioned"],
        "microbatches": win["microbatches"],
        "global_batch": global_batch,
        "seq_len": seq_len,
        "steps": steps,
    }
    if layers:
        execution["layers"] = layers
    if win["stages"] > 1:
        execution["stages"] = win["stages"]
        execution["schedule"] = win["schedule"]
        execution["split_backward"] = win["split_backward"]
        # schedule-as-data: embed the scored tick table so launch.train
        # interprets exactly what the planner priced (launch.plan
        # --dump-table prints it for inspection)
        spec_k = None
        for key in tables:
            if (key[0] == win["stages"] and key[2] == win["microbatches"]
                    and key[3] == win["schedule"]
                    and key[4] == win["split_backward"]):
                spec_k = key
                break
        assert spec_k is not None
        execution["tick_table"] = tables[spec_k].to_json()
    return {
        "version": PLAN_VERSION,
        "kind": "execution",
        "arch": arch,
        "devices": devices,
        "plans": rows,
        "execution": execution,
    }
