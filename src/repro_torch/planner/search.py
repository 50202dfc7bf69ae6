"""Pruned configuration search for the X_[x] family (planner layer 2): a
copy of ``repro/planner/search.py``, which the port may not import.

Enumerates the joint space the paper only samples:

    (schedule, accumulation method, ZeRO partition, n_a, n_l, b_mu, n_mu)

with ``n_b`` derived from the critical batch (``n_b = floor(b_c/(n_mu b_mu))``,
the paper's fill rule) so every candidate trains at the largest useful batch.
Candidates are pruned with the calculator's closed-form constraints (memory
fit incl. offload-stream intensity, compute-bound reductions, pipeline
overlap minima), ranked by an analytic efficiency product mirroring §5, and
the head of the ranking — plus the best candidate of every
(schedule, method, partition) family — is re-scored with the discrete-event
simulator.  The final order is by simulated step time where available.

Ties (e.g. a non-partitioned layered config whose reductions are equally
hidden) break toward offload-free, then partitioned plans: at equal predicted
speed the planner prefers the config with no host-stream dependency and the
smallest per-device state.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core import calculator as calc
from repro_torch.planner import simulator as simlib
from repro_torch.serving.cache import kv_bytes_per_token

STEPS = 1e5          # the paper's 100k-step budget (section 6)
SCHEDULES = ("gpipe", "1f1b", "modular", "interleaved")
INTERLEAVED_CHUNKS = (2, 4)


@dataclasses.dataclass
class Plan:
    """One ranked configuration: knobs + derived sizes + predictions."""
    schedule: str
    method: str                    # layered | standard
    partitioned: bool
    n_a: int
    n_l: int
    n_mu: int
    b_mu: int
    n_b: int
    n_chunks: int = 1
    # zero-bubble backward split: tick table carries dgrad/wgrad halves,
    # wgrad deferred into bubble slots (simulator prices the exact overlap)
    split_backward: bool = False
    offload: bool = False
    efficiency: dict = dataclasses.field(default_factory=dict)
    time_s: float = 0.0            # analytic
    sim: dict | None = None
    sim_time_s: float | None = None
    memory: dict = dataclasses.field(default_factory=dict)

    @property
    def n_gpu(self) -> int:
        return self.n_b * self.n_l * self.n_a

    @property
    def b(self) -> int:
        return self.n_b * self.n_mu * self.b_mu

    @property
    def family(self) -> str:
        part = "part" if self.partitioned else "repl"
        sched = self.schedule + ("+zb" if self.split_backward else "")
        return f"{sched}/{self.method}/{part}"

    @property
    def best_time_s(self) -> float:
        return self.sim_time_s if self.sim_time_s is not None else self.time_s

    def sort_key(self) -> tuple:
        return (self.best_time_s, self.offload, not self.partitioned,
                -self.n_gpu)

    @property
    def stage_mesh(self) -> dict:
        """The mesh-axis sizes an executor needs to build this plan's
        stage x data x model device mesh (the fields launch.train consumes
        for pipelined plans): n_l pipeline stages, n_b data shards, n_a
        tensor-parallel ways."""
        return {"stage": self.n_l, "data": self.n_b, "model": self.n_a}

    def row(self) -> dict:
        out = {
            "family": self.family, "schedule": self.schedule,
            "method": self.method, "partitioned": self.partitioned,
            "split_backward": self.split_backward,
            # the generic tick-table executor (core/pipeline.py) can run this
            # schedule — including its zero-bubble split-backward variant
            # (kinds 3/4 execute via the residual ring buffer)
            "executable": simlib.canonical_schedule(self.schedule)
            in simlib.EXECUTABLE_SCHEDULES,
            "offload": self.offload,
            "n_a": self.n_a, "n_l": self.n_l, "n_b": self.n_b,
            "n_mu": self.n_mu, "b_mu": self.b_mu, "n_chunks": self.n_chunks,
            "n_gpu": self.n_gpu, "b": self.b,
            "stage_mesh": self.stage_mesh,
            "efficiency": {k: round(v, 4) for k, v in self.efficiency.items()},
            "time_days": round(self.time_s / calc.DAY, 3),
        }
        if self.sim_time_s is not None:
            out["sim_time_days"] = round(self.sim_time_s / calc.DAY, 3)
            out["sim"] = self.sim
        if self.memory:
            out["memory_gib"] = {k: round(v, 2) for k, v in self.memory.items()}
        return out


# ---------------------------------------------------------------------------
# Constraint helpers (paper §5 closed forms, via core/calculator.py)
# ---------------------------------------------------------------------------
def _reduction_min_nmu(m: calc.XModel, hw: calc.Hardware, net: float,
                       *, partitioned: bool, b_mu: int) -> int:
    """Smallest n_mu keeping the layered data-axis reduction compute-bound
    (eqs. 8/9; the standard method concentrates the reduction instead)."""
    nu = hw.nu(net)
    need = 2.0 * nu if partitioned else 4.0 * nu / 3.0
    return max(1, math.ceil(need / (m.d_s * b_mu)))


def _overlap_min_nmu(m: calc.XModel, hw: calc.Hardware, net: float,
                     n_l: int) -> int:
    """Micro-batches needed to hide the contiguous-schedule pipe transfer
    behind compute (eq. 10)."""
    if n_l <= 1:
        return 1
    nu_l = calc.nu_pipe_base(m, n_l)
    return math.ceil(n_l * (1.0 + hw.nu(net) / nu_l))


def _nmu_candidates(m: calc.XModel, hw: calc.Hardware, net: float, *,
                    schedule: str, method: str, partitioned: bool,
                    n_l: int, b_mu: int) -> list[int]:
    mins = [1]
    if method == "layered":
        mins.append(_reduction_min_nmu(m, hw, net,
                                       partitioned=partitioned, b_mu=b_mu))
    if n_l > 1:
        if schedule in ("gpipe", "1f1b"):
            mins.append(_overlap_min_nmu(m, hw, net, n_l))
        elif schedule == "modular":
            mins.append(n_l)
    n_mu_min = max(mins)
    cands = {n_mu_min, 2 * n_mu_min}
    n_b = int(m.b_c // (n_mu_min * b_mu))
    if n_b >= 1:       # the paper's fill rule: top the batch up to b_c
        cands.add(int(m.b_c // (n_b * b_mu)))
    if schedule == "interleaved":
        # Megatron's constraint: n_mu must tile the stage count once it
        # exceeds it, or the chunk-major 1F1B ordering has no valid steady
        # state (enforced by the simulator)
        cands = {c if c <= n_l else math.ceil(c / n_l) * n_l for c in cands}
    return sorted(c for c in cands if c * b_mu <= m.b_c)


def _memory_check(m: calc.XModel, hw: calc.Hardware,
                  plan: Plan) -> tuple[bool, bool, dict]:
    """(feasible, needs_offload, breakdown_gib)."""
    cfg = calc.Config(plan.family, n_b=plan.n_b, n_l=plan.n_l, n_a=plan.n_a,
                      n_mu=plan.n_mu, b_mu=plan.b_mu)
    mem = calc.memory_breakdown(m, cfg, partitioned=plan.partitioned)
    cap = 0.9 * hw.mem / calc.GIB
    total = mem["offloadable"] + mem["non_offloadable"]
    if total <= cap:
        return True, False, mem
    if mem["non_offloadable"] > cap:
        return False, False, mem
    # offload feasible iff the state stream stays compute-bound (eq. 13);
    # when the gradient reduction also crosses the PCIe root (non-partitioned
    # data parallelism) the two share the link — the calculator's 7/3 PCIe
    # factor (appendix A), which prunes barely-compute-bound offload configs.
    need = hw.nu(hw.cpu_gpu)
    if plan.n_b > 1 and not plan.partitioned:
        need = max(need, (7.0 / 3.0) * hw.nu(hw.pcie))
    stream_ok = plan.b_mu * plan.n_mu * m.d_s >= need
    return stream_ok, True, mem


# ---------------------------------------------------------------------------
# Analytic scoring (mirrors calculator's §5 selection, generalized)
# ---------------------------------------------------------------------------
def analytic_eval(m: calc.XModel, hw: calc.Hardware, plan: Plan,
                  net: float) -> Plan | None:
    S, M = plan.n_l, plan.n_mu
    K = m.d_l // S
    tp_eff = 1.0
    if plan.n_a > 1:
        ov = hw.nu(hw.nvlink) / calc.nu_tensor(m, plan.n_a)
        if ov > 0.25:                      # paper's NVLink overhead ceiling
            return None
        tp_eff = 1.0 / (1.0 + ov)
    eff: dict[str, float] = {"tp": tp_eff}
    if S > 1:
        V = K if plan.schedule == "modular" else plan.n_chunks
        if plan.schedule == "interleaved" and M < S:
            # not enough micro-batches to fill the interleaved steady state;
            # the warmup dominates and the V x bubble reduction is lost (the
            # simulator prices the exact warmup, this keeps the *estimate*
            # from promoting unsimulatable optimism)
            V = 1
        bub = float(S - 1)
        if plan.split_backward:
            # zero-bubble split: the wgrad share of the backward (1/3 of a
            # 3x-fwd backward = 3/4 of a fwd+bwd tick pair) moves off the
            # cooldown critical path into bubble slots.  Estimate only —
            # the event simulator prices the exact gap-filled overlap.
            bub *= 1.0 - simlib.WGRAD_FRACTION * 0.75
        eff["bubble"] = V * M / (V * M + bub)
        k_c = K // V
        nu_chunk = (2 + m.n_I) * m.d_m * k_c
        ov_p2p = hw.nu(net) / nu_chunk
        if plan.schedule in ("gpipe", "1f1b"):
            hidden = M >= S * (1.0 + ov_p2p)
            eff["p2p"] = 1.0 if hidden else 1.0 / (1.0 + ov_p2p)
        else:                               # un-overlapped per-tick transfer
            eff["p2p"] = 1.0 / (1.0 + ov_p2p)
    if plan.n_b > 1:
        nu = hw.nu(net)
        have = M * plan.b_mu * m.d_s
        if plan.method == "layered":
            # per-layer collectives, spread over the pass: bandwidth-bound
            need = 2.0 * nu if plan.partitioned else 4.0 * nu / 3.0
            eff["reduce"] = min(1.0, have / need)
        elif plan.partitioned:              # per-micro-batch gathers (3 L M)
            eff["reduce"] = min(1.0, plan.b_mu * m.d_s / (2.0 * nu))
    feasible, offload, mem = _memory_check(m, hw, plan)
    if not feasible:
        return None
    plan.offload = offload
    plan.memory = mem
    t_ideal = STEPS * m.step_flops(plan.b) / (plan.n_gpu * hw.c)
    t_step = t_ideal / math.prod(eff.values())
    if plan.n_b > 1 and plan.method == "standard" and not plan.partitioned:
        # the standard method's single psum lands AFTER the last micro-batch:
        # a serial step-level addition, not a per-tick slowdown
        n = plan.n_b
        wire = 2.0 * (n - 1) / n * 4.0 * m.p / (plan.n_l * plan.n_a)
        extra = STEPS * wire / net
        eff["reduce"] = t_step / (t_step + extra)
        t_step = t_step + extra
    plan.efficiency = eff
    plan.time_s = t_step
    return plan


# ---------------------------------------------------------------------------
# Simulation scoring
# ---------------------------------------------------------------------------
def build_cost_model(m: calc.XModel, hw: calc.Hardware, plan: Plan,
                     net: float) -> simlib.CostModel:
    p_layer = m.p / m.d_l          # attention extras amortized per layer
    tp_eff = plan.efficiency.get("tp", 1.0)
    # AdamW update working set per device per layer: fp32 master + mu + nu +
    # reduced gradient (4 x 4 B/param), over the state shards this device owns
    opt_shard = plan.n_a * (plan.n_b if plan.partitioned else 1)
    return simlib.CostModel(
        flops_fwd_layer=2.0 * plan.b_mu * m.d_s * p_layer / plan.n_a,
        flops_bwd_layer=6.0 * plan.b_mu * m.d_s * p_layer / plan.n_a,
        act_bytes=2.0 * plan.b_mu * m.d_s * m.d_m / plan.n_a,
        layer_param_bytes=2.0 * p_layer / plan.n_a,       # bf16 gathers
        layer_grad_bytes=4.0 * p_layer / plan.n_a,        # fp32 reductions
        flops_rate=hw.c * tp_eff,
        p2p_bw=net,
        coll_bw=net,
        opt_bytes_per_layer=16.0 * p_layer / opt_shard,
        hbm_bw=hw.hbm_bw,
    )


def simulate_plan(m: calc.XModel, hw: calc.Hardware, plan: Plan, net: float,
                  *, max_units: int = 400_000) -> Plan:
    S = plan.n_l
    if S <= 1:
        plan.sim = {"skipped": "no pipeline: analytic model is exact"}
        return plan
    K = m.d_l // S
    V = K if plan.schedule == "modular" else plan.n_chunks
    if 2 * V * S * plan.n_mu > max_units:
        plan.sim = {"skipped": f"{2 * V * S * plan.n_mu} units > cap"}
        return plan
    sim = simlib.SimConfig(
        n_stages=S, layers_per_stage=K, n_microbatches=plan.n_mu,
        schedule=plan.schedule,
        n_chunks=plan.n_chunks if plan.schedule == "interleaved" else 0,
        method=plan.method, partitioned=plan.partitioned, n_data=plan.n_b,
        split_backward=plan.split_backward,
        overlap_p2p=plan.schedule in ("gpipe", "1f1b"),
        # mirrors stepfn's dispatch: the one-pass chunk kernel serves any
        # partitioned layout; placement (per-chunk §C.3 overlap vs end-of-
        # step tail) follows plan.method inside the simulator
        fused_optimizer=plan.partitioned,
    )
    res = simlib.simulate(sim, build_cost_model(m, hw, plan, net))
    plan.sim = res.summary()
    plan.sim_time_s = STEPS * res.step_time
    return plan


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------
def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def enumerate_plans(m: calc.XModel, hw: calc.Hardware, net: float, *,
                    grid: str = "full",
                    split_backward: bool = False) -> list[Plan]:
    if grid == "reduced":
        n_as = [hw.max_node]
        n_ls = [d for d in (1, m.d_l // 32 or 1, m.d_l // 20 or 1, m.d_l)
                if d >= 1 and m.d_l % d == 0]
        b_mus = [1]
    else:
        n_as = [a for a in (1, 2, 4, 8, 16) if a <= hw.max_node]
        n_ls = _divisors(m.d_l)
        b_mus = [1, 2, 4]
    plans: list[Plan] = []
    seen: set[tuple] = set()
    for n_a in n_as:
        for n_l in n_ls:
            K = m.d_l // n_l
            for b_mu in b_mus:
                for method in ("standard", "layered"):
                    for partitioned in (False, True):
                        for schedule in (SCHEDULES if n_l > 1 else ("gpipe",)):
                            vs = [K] if schedule == "modular" else (
                                [v for v in INTERLEAVED_CHUNKS
                                 if v < K and K % v == 0]
                                if schedule == "interleaved" else [1])
                            for v in vs:
                                for n_mu in _nmu_candidates(
                                        m, hw, net, schedule=schedule,
                                        method=method, partitioned=partitioned,
                                        n_l=n_l, b_mu=b_mu):
                                    n_b = max(1, int(m.b_c // (n_mu * b_mu)))
                                    splits = ((False, True) if
                                              (split_backward and n_l > 1)
                                              else (False,))
                                    for zb in splits:
                                        key = (schedule, method, partitioned,
                                               n_a, n_l, n_mu, b_mu, v, zb)
                                        if key in seen:
                                            continue
                                        seen.add(key)
                                        plans.append(Plan(
                                            schedule=schedule, method=method,
                                            partitioned=partitioned, n_a=n_a,
                                            n_l=n_l, n_mu=n_mu, b_mu=b_mu,
                                            n_b=n_b, n_chunks=v,
                                            split_backward=zb))
    return plans


def search(x: int, hw: calc.Hardware | None = None, *,
           net: float | None = None, grid: str = "full",
           simulate_top: int = 12, max_sims: int = 64,
           max_gpus: int | None = None,
           split_backward: bool = False) -> list[Plan]:
    """Ranked plans for X_[x].

    Analytic prune + rank first; then the simulator re-scores the best
    candidate of every (schedule, method, partition) family and the head of
    the ranking, *iterating* — simulate, re-sort, simulate whatever new
    candidates float into the top — until the top ``simulate_top`` plans all
    carry simulated times (or ``max_sims`` is spent).  The iteration matters:
    analytic estimates are optimistic for some schedules, so a single pass
    would let never-simulated optimism outrank simulated truth.

    ``split_backward=True`` additionally enumerates the zero-bubble variant
    of every pipelined candidate (backward split into dgrad + deferred
    wgrad; the simulator gap-fills the wgrads into per-stage bubbles).
    Split variants form their own ``<schedule>+zb`` families so the family
    pass always simulates at least one of each.
    """
    hw = hw or calc.Hardware()
    net = net or hw.ib
    m = calc.XModel(x)
    plans = [p for p in (analytic_eval(m, hw, c, net)
                         for c in enumerate_plans(
                             m, hw, net, grid=grid,
                             split_backward=split_backward))
             if p is not None]
    if max_gpus is not None:
        plans = [p for p in plans if p.n_gpu <= max_gpus]
    plans.sort(key=Plan.sort_key)
    attempted: set[int] = set()
    sims = 0

    def run(p: Plan) -> None:
        nonlocal sims
        if id(p) in attempted:
            return
        attempted.add(id(p))
        simulate_plan(m, hw, p, net)
        if p.sim_time_s is not None:
            sims += 1

    best_of: dict[str, Plan] = {}
    for p in plans:
        if p.family not in best_of:
            best_of[p.family] = p
    for p in best_of.values():
        run(p)
    while sims < max_sims:
        plans.sort(key=Plan.sort_key)
        todo = [p for p in plans[:simulate_top] if id(p) not in attempted]
        if not todo:
            break
        for p in todo:
            run(p)
            if sims >= max_sims:
                break
    plans.sort(key=Plan.sort_key)
    return plans


# ---------------------------------------------------------------------------
# Serving search (SimConfig.serving): rank decode configs by tok/s
# ---------------------------------------------------------------------------
_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


@dataclasses.dataclass
class ServePlan:
    """One serving configuration: TP width x live batch x cache layout."""
    tp: int
    batch: int                      # live decode batch (engine slots)
    block_size: int                 # paged block size; 0 = dense layout
    mean_ctx: int                   # steady-state live context per request
    max_seq: int                    # dense layout's allocated seq length
    weight_gib: float = 0.0
    kv_gib: float = 0.0             # steady-state allocated KV per device
    time_s: float = 0.0             # simulated decode-step time
    tok_s: float = 0.0
    sim: dict = dataclasses.field(default_factory=dict)

    @property
    def layout(self) -> str:
        return f"paged/{self.block_size}" if self.block_size else "dense"

    def sort_key(self) -> tuple:
        return (-self.tok_s, self.tp, self.batch)

    def row(self) -> dict:
        return {"layout": self.layout, "tp": self.tp, "batch": self.batch,
                "mean_ctx": self.mean_ctx,
                "weight_gib": round(self.weight_gib, 2),
                "kv_gib": round(self.kv_gib, 2),
                "step_us": round(self.time_s * 1e6, 1),
                "tok_s": round(self.tok_s, 1), "sim": self.sim}


def _serving_bytes(cfg, tp: int) -> tuple[float, float, float, float]:
    """(weight bytes/device, kv bytes/token/device, decode flops/token,
    TP collective bytes/token) for a ModelConfig on a tp-way model axis.

    The KV numbers come from the engine's own layout helpers
    (serving/cache.py), so the cost model cannot drift from what the paged
    pool actually allocates.
    """
    itemsize = _DTYPE_BYTES.get(cfg.dtype, 2)
    w = 2.0 * cfg.param_count() / tp                      # bf16 serving weights
    kv_pt = float(kv_bytes_per_token(cfg, tp))
    flops_pt = 2.0 * cfg.param_count(active_only=True) / tp
    ring = (tp - 1) / tp if tp > 1 else 0.0
    coll_pt = cfg.num_layers * 2.0 * ring * cfg.d_model * itemsize
    return w, kv_pt, flops_pt, coll_pt


def serving_cost_model(cfg, hw: calc.Hardware, tp: int) -> simlib.CostModel:
    w, kv_pt, flops_pt, coll_pt = _serving_bytes(cfg, tp)
    tp_eff = 1.0                                          # folded into coll_pt
    return simlib.CostModel(
        flops_fwd_layer=0.0, flops_bwd_layer=0.0, act_bytes=0.0,
        layer_param_bytes=w / max(cfg.num_layers, 1), layer_grad_bytes=0.0,
        flops_rate=hw.c * tp_eff, p2p_bw=hw.ib, coll_bw=hw.nvlink,
        hbm_bw=hw.hbm_bw, kv_bytes_per_token=kv_pt,
        serve_flops_per_token=flops_pt, serve_coll_bytes_per_token=coll_pt)


def search_serving(cfg, hw: calc.Hardware | None = None, *,
                   mean_ctx: int = 2048, max_seq: int = 4096,
                   max_batch: int = 512,
                   block_sizes: tuple = (0, 16, 32, 64, 128),
                   tps: tuple | None = None) -> list[ServePlan]:
    """Ranked serving configs for a ModelConfig: enumerate (tp, live batch,
    cache layout), keep what fits HBM, rank by simulated decode tok/s.

    The paged layouts allocate ``batch * ceil(mean_ctx / bs) * bs`` tokens of
    KV (steady-state live blocks + tail fragmentation); the dense layout
    allocates ``batch * max_seq`` regardless of the live context — the same
    budget therefore admits a larger paged batch, which is where continuous
    batching's throughput comes from at the planner level.
    """
    hw = hw or calc.Hardware()
    if tps is None:
        tps = tuple(t for t in (1, 2, 4, 8, 16)
                    if t <= hw.max_node and cfg.num_heads % t == 0)
    cap = 0.9 * hw.mem
    plans: list[ServePlan] = []
    for tp in tps:
        w, kv_pt, _, _ = _serving_bytes(cfg, tp)
        if w > cap:
            continue
        cost = serving_cost_model(cfg, hw, tp)
        b = 1
        while b <= max_batch:
            for bs in block_sizes:
                toks = (-(-mean_ctx // bs) * bs) if bs else max_seq
                kv_alloc = float(b) * toks * kv_pt
                if w + kv_alloc > cap:
                    continue
                sim = simlib.SimConfig(
                    n_stages=1, layers_per_stage=max(cfg.num_layers, 1),
                    n_microbatches=1, schedule="gpipe", serving=True,
                    serve_batch=b, serve_ctx=mean_ctx, serve_block=bs,
                    serve_max_seq=max_seq)
                res = simlib.simulate(sim, cost)
                plans.append(ServePlan(
                    tp=tp, batch=b, block_size=bs, mean_ctx=mean_ctx,
                    max_seq=max_seq, weight_gib=w / calc.GIB,
                    kv_gib=kv_alloc / calc.GIB, time_s=res.step_time,
                    tok_s=res.counts["tok_per_s"], sim=res.summary()))
            b *= 2
    plans.sort(key=ServePlan.sort_key)
    return plans


def baseline_and_winner(plans: list[Plan]) -> tuple[Plan | None, Plan]:
    """The paper's comparison pair: winner = top-ranked plan; baseline = best
    conventional 3d plan (contiguous pipeline, standard accumulation, no
    partition — Megatron-style)."""
    winner = plans[0]
    base = [p for p in plans
            if p.schedule == "gpipe" and p.method == "standard"
            and not p.partitioned and p.n_l > 1 and p.n_a > 1]
    return (min(base, key=Plan.sort_key) if base else None), winner
