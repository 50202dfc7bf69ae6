"""Discrete-event simulator of distributed training schedules, and the
executable tick tables (a copy of ``repro/planner/simulator.py``, which the
port may not import; ``core/pipeline.py`` runs the tables).

Simulates ONE optimizer step of a pipelined, data-parallel, optionally
ZeRO-partitioned configuration at (micro-batch x layer-chunk) granularity.
Four pipeline schedules:

  gpipe        contiguous layer blocks; all forwards, flush, all backwards
               (the paper's "naive" baseline, = schedules.PipeSpec "naive")
  modular      the paper's §4 schedule: round-robin layer placement, one
               layer per tick, micro-batches of a layer run consecutively
               (= layered gradient accumulation per stage)
  1f1b         PipeDream-flush: same bubble as gpipe but bounded in-flight
               activations (Narayanan et al., 2021)
  interleaved  interleaved 1F1B with V round-robin chunks per stage
               (Megatron-LM); bubble shrinks ~V x for ~V x more p2p rounds

Modelled resources, per pipeline stage (one representative device of the
data-parallel group — the configuration is SPMD-symmetric over `data`):

  * a compute engine: executes F/B units in the schedule's program order
    (head-of-line; a stalled unit blocks the stage, as in the real scan);
  * forward and backward p2p send engines: boundary activations / cotangent
    transfers serialize per direction at ``act_bytes / p2p_bw`` each;
  * a collective engine for data-axis collectives (ZeRO weight all-gathers,
    gradient psum_scatter / psum) at ring-bandwidth wire bytes
    ``(n-1)/n * bytes / coll_bw``.

Overlap knobs: ``overlap_p2p=False`` charges sends to the producing stage's
compute engine (the paper's un-overlapped improved-pipeline p2p, eq. 11);
``overlap_coll=False`` does the same for data-axis collectives.
``shared_link=True`` makes p2p and collectives contend for one wire.

Placement of the data-axis collectives follows the accumulation method
(core/accumulation.py): ``layered`` gathers each chunk's weights once per
pass and reduces its gradient once per step, spread over the backward;
``standard`` gathers per (chunk, micro-batch) when partitioned (3*L*M
collectives) and reduces everything in one end-of-step psum when not.

Tensor parallelism is not simulated event-by-event: its collectives are
per-layer-internal and overlap-free by construction, so it is folded into
the compute rate (``CostModel.flops_rate`` carries the 1/(1+overhead)
efficiency factor, eq. 12).  Embedding/head work is marginal at paper scale
and enters only as the ``t_head`` loss-turnaround latency.

Everything is pure Python and deterministic: same inputs, same timeline, and
the same numbers as the JAX package's for the same inputs.  A tick table's
JSON form (``TickTable.to_json``) is that package's key for key, so a table
made by either package loads into the other.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

SCHEDULES = ("gpipe", "modular", "1f1b", "interleaved")
_ALIASES = {"naive": "gpipe"}

# Tick kinds of the executable tick table (core/pipeline.py interprets these;
# the integer values are part of the plan-JSON contract).  BDGRAD/BWGRAD are
# the zero-bubble backward split: a B unit's activation-path transpose
# (dgrad, releases the upstream cotangent) and its deferred weight-path dots
# (wgrad, replayed from a saved residual) run as separate ticks, letting
# ``build_tick_table(split_backward=True)`` park the wgrad halves in what
# would otherwise be bubble slots.
TICK_IDLE, TICK_F, TICK_B, TICK_BDGRAD, TICK_BWGRAD = 0, 1, 2, 3, 4
EXECUTABLE_TICK_KINDS = (TICK_IDLE, TICK_F, TICK_B, TICK_BDGRAD, TICK_BWGRAD)
# stable human-readable kind names of the shared timeline schema (obs/trace,
# obs/drift and TickTable.timeline all render these); idle ticks have none.
TICK_NAMES = {TICK_IDLE: None, TICK_F: "F", TICK_B: "B",
              TICK_BDGRAD: "Bd", TICK_BWGRAD: "Bw"}
# every schedule in SCHEDULES lowers to executable tick kinds, split or not
EXECUTABLE_SCHEDULES = SCHEDULES

# Share of a backward unit's time spent in the deferred weight-path dots.
# The full backward bundle is recompute + activation-path transposes +
# weight-path dots (~3x one forward); the wgrad half replays from a saved
# residual, so it is the weight dots alone — one forward-equivalent of the
# three.  Used by the event simulator's split-backward mode.
WGRAD_FRACTION = 1.0 / 3.0


def canonical_schedule(name: str) -> str:
    name = _ALIASES.get(name, name)
    if name not in SCHEDULES:
        raise ValueError(f"unknown schedule {name!r}; known: {SCHEDULES}")
    return name


# HBM passes over the per-layer optimizer state (params + both Adam moments
# + gradient) charged by the update step: the fused Pallas chunk kernel
# (kernels/adamw.py) does one blocked read+write sweep; the unfused tree-map
# stages each state tensor through separate elementwise ops (~6 round-trips,
# measured against the repo's optim/adam.py lowering).
OPT_PASSES_FUSED = 1.0
OPT_PASSES_UNFUSED = 6.0


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Per-unit costs.  Flops/bytes are per (layer x micro-batch) so the same
    model serves every chunking; seconds are derived through the rates."""
    flops_fwd_layer: float          # forward flops, one layer, one micro-batch
    flops_bwd_layer: float          # backward (recompute + transposes)
    act_bytes: float                # boundary activation bytes per micro-batch
    layer_param_bytes: float        # one layer's weight bytes (gather payload)
    layer_grad_bytes: float         # one layer's gradient bytes (reduce payload)
    flops_rate: float               # effective device flops/s (tp_eff folded in)
    p2p_bw: float                   # stage-to-stage bytes/s
    coll_bw: float                  # data-axis bytes/s
    t_head: float = 0.0             # loss turnaround latency after last layer
    # optimizer update path (0 disables the term — pre-fused-kernel behavior):
    # per-device bytes of one layer's update working set (fp32 master shard +
    # both Adam moments + reduced gradient) and the device HBM bandwidth the
    # update sweeps run at.
    opt_bytes_per_layer: float = 0.0
    hbm_bw: float = 0.0
    # serving-mode costs (SimConfig.serving; all 0 for training sims):
    # per-device K+V bytes cached per token, decode flops per token, and the
    # per-token tensor-parallel collective wire bytes (per-layer psums).
    kv_bytes_per_token: float = 0.0
    serve_flops_per_token: float = 0.0
    serve_coll_bytes_per_token: float = 0.0

    @property
    def t_fwd_layer(self) -> float:
        return self.flops_fwd_layer / self.flops_rate

    @property
    def t_bwd_layer(self) -> float:
        return self.flops_bwd_layer / self.flops_rate

    def t_opt_layer(self, fused: bool) -> float:
        """Seconds to apply one layer's AdamW update on this device."""
        if self.opt_bytes_per_layer <= 0 or self.hbm_bw <= 0:
            return 0.0
        passes = OPT_PASSES_FUSED if fused else OPT_PASSES_UNFUSED
        return passes * self.opt_bytes_per_layer / self.hbm_bw


@dataclasses.dataclass(frozen=True)
class SimConfig:
    n_stages: int
    layers_per_stage: int           # K: layers owned by each stage
    n_microbatches: int
    schedule: str = "modular"       # gpipe | modular | 1f1b | interleaved
    n_chunks: int = 0               # V (interleaved only; 0 = auto)
    method: str = "layered"         # layered | standard (collective placement)
    partitioned: bool = True        # ZeRO state partition over `data`
    n_data: int = 1                 # data-axis size (collective wire factors)
    overlap_p2p: bool = True
    overlap_coll: bool = True
    shared_link: bool = False       # p2p and collectives share one wire
    include_backward: bool = True
    # zero-bubble backward split: B units run as dgrad (releases the
    # upstream cotangent after (1 - WGRAD_FRACTION) of the backward time)
    # with the wgrad half deferred into the stage's idle gaps — the event-
    # engine counterpart of build_tick_table(split_backward=True).
    split_backward: bool = False
    # -- serving mode -------------------------------------------------------
    # Models ONE continuous-batching decode step instead of a training step:
    # decode is HBM-bandwidth-bound (every step streams the whole weight
    # shard plus the live KV working set once), so the step time is
    # max(HBM sweep, matmul compute) plus the un-overlapped per-layer TP
    # psums.  The paged layout (serve_block > 0) streams only the blocks
    # covering each request's live context — ceil(ctx/bs)*bs tokens — while
    # the dense layout streams the full allocated [B, max_seq] cache; that
    # traffic gap is exactly what the paged pool buys at the step level
    # (the admission-capacity gap is priced by search.search_serving).
    serving: bool = False
    serve_batch: int = 0            # live decode batch (requests)
    serve_ctx: int = 0              # mean live context length (tokens)
    serve_block: int = 0            # paged block size; 0 = dense layout
    serve_max_seq: int = 0          # dense layout: allocated sequence length
    # optimizer path (active when CostModel.opt_bytes_per_layer > 0).
    # fused = the one-pass chunk kernel (kernels/adamw.py) at
    # OPT_PASSES_FUSED x HBM traffic; unfused = the tree-map update at
    # OPT_PASSES_UNFUSED x.  Placement follows the accumulation method
    # independently of the pass count, mirroring the runtime: the layered
    # schedule (§C.3) applies each chunk's update the moment its gradient is
    # reduced, overlapping the rest of the backward; every other method runs
    # one bulk update tail after its last reduce (stepfn dispatches the
    # fused kernel for any partitioned layout, layered or not).
    fused_optimizer: bool = False

    def __post_init__(self):
        object.__setattr__(self, "schedule", canonical_schedule(self.schedule))
        K = self.layers_per_stage
        if self.schedule == "modular":
            v = K
        elif self.schedule == "interleaved":
            v = self.n_chunks or min(2, K)
        else:
            v = 1
        assert K % v == 0, f"chunks {v} must divide layers/stage {K}"
        object.__setattr__(self, "n_chunks", v)
        if self.schedule == "interleaved":
            M, S = self.n_microbatches, self.n_stages
            # Megatron's interleaving constraint: with more micro-batches
            # than stages, the group structure must tile evenly or the
            # chunk-major 1F1B ordering deadlocks on the ragged group.
            assert M <= S or M % S == 0, \
                f"interleaved 1f1b needs n_mu <= n_stages or n_mu % " \
                f"n_stages == 0 (got M={M}, S={S})"

    @property
    def round_robin(self) -> bool:
        return self.schedule in ("modular", "interleaved")

    @property
    def layers_per_chunk(self) -> int:
        return self.layers_per_stage // self.n_chunks

    @property
    def n_global_chunks(self) -> int:
        return self.n_chunks * self.n_stages


@dataclasses.dataclass
class SimResult:
    step_time: float
    compute_s: float                  # busy compute seconds per stage (mean)
    busy_per_stage: list[float]
    bubble_fraction: float            # 1 - mean busy / step_time
    p2p_s: float                      # total wire-seconds of p2p transfers
    p2p_bytes: float
    coll_s: float                     # total wire-seconds of data collectives
    coll_bytes: float
    counts: dict[str, Any]
    peak_live_mb: list[int]           # max in-flight activations per stage
    opt_s: float = 0.0                # HBM-seconds of optimizer update sweeps
    timeline: list | None = None

    def summary(self) -> dict:
        return {
            "step_time_s": self.step_time,
            "bubble_fraction": round(self.bubble_fraction, 4),
            "compute_s": self.compute_s,
            "p2p_s": self.p2p_s, "p2p_bytes": self.p2p_bytes,
            "coll_s": self.coll_s, "coll_bytes": self.coll_bytes,
            "opt_s": self.opt_s,
            "peak_live_mb": max(self.peak_live_mb) if self.peak_live_mb else 0,
            "counts": dict(self.counts),
        }


# ---------------------------------------------------------------------------
# Per-stage program order
# ---------------------------------------------------------------------------
def stage_order(sim: SimConfig, s: int) -> list[tuple[str, int, int]]:
    """The (kind, chunk, micro-batch) unit sequence stage ``s`` executes."""
    S, M, V = sim.n_stages, sim.n_microbatches, sim.n_chunks
    sched = sim.schedule
    if sched == "gpipe":
        f = [("F", 0, mb) for mb in range(M)]
        b = [("B", 0, mb) for mb in reversed(range(M))]
        return f + b if sim.include_backward else f
    if sched == "modular":
        f = [("F", v, mb) for v in range(V) for mb in range(M)]
        if not sim.include_backward:
            return f
        return f + [("B", v, mb) for (_, v, mb) in reversed(f)]
    if sched == "1f1b":
        f = [("F", 0, mb) for mb in range(M)]
        b = [("B", 0, mb) for mb in range(M)]
        if not sim.include_backward:
            return f
        return _one_f_one_b(f, b, warmup=min(S - 1 - s, M))
    # interleaved: micro-batch groups of G, chunk-major within a group
    G = min(S, M)
    groups = [range(g, min(g + G, M)) for g in range(0, M, G)]
    f = [("F", v, mb) for grp in groups for v in range(V) for mb in grp]
    if not sim.include_backward:
        return f
    b = [("B", v, mb) for grp in groups for v in reversed(range(V))
         for mb in grp]
    warmup = min((S - 1 - s) * 2 + (V - 1) * G, V * M)
    return _one_f_one_b(f, b, warmup=warmup)


def _one_f_one_b(f: list, b: list, *, warmup: int) -> list:
    out = list(f[:warmup])
    steady = len(f) - warmup
    for i in range(steady):
        out.append(f[warmup + i])
        out.append(b[i])
    out.extend(b[steady:])
    return out


# ---------------------------------------------------------------------------
# The event engine
# ---------------------------------------------------------------------------
class DeadlockError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Executable tick tables (schedule-as-data)
# ---------------------------------------------------------------------------
# A tick table is the lockstep SPMD rendering of a schedule's stage_order:
# T rows, one per global tick; each row assigns every stage at most one
# (kind, chunk, micro-batch) unit.  core/pipeline.py runs the table (the JAX
# package's executor as one lock-step scan, the port's a stage's own units
# only) — the table, not the executor, is where schedules differ, so the
# simulator stays the single source of truth.
#
# Chunk placement is uniform across schedules: stage s's local chunk v is
# global chunk g = v*S + s, holding global layers [g*k_c, (g+1)*k_c).  For
# the V=1 schedules (gpipe/1f1b) this reduces to g = s (contiguous blocks);
# for modular (V=K, k_c=1) it is the paper's round-robin placement.  A handy
# invariant follows: g mod S is the owning stage and g // S its local slot,
# and consecutive global chunks are always one forward ring hop apart.
@dataclasses.dataclass(frozen=True)
class TickTable:
    """Static schedule table interpreted by core/pipeline.py.

    Core arrays are [T][S] ints: ``kind`` (TICK_* code), ``unit_v`` (local
    chunk), ``unit_mb`` (micro-batch); idle rows carry zeros.  The derived
    recv tables (what each stage's ring recv means at the END of tick t) are
    recomputed from the core arrays, never serialized:

      frecv_*   forward-ring recv: valid, receiver-side chunk slot, micro-
                batch, and whether it is the final network output (head input
                arriving at the loss stage 0)
      hrecv_*   loss-ring recv at stage S-1: the head cotangent for the last
                chunk, emitted the same tick the final output arrives
      brecv_*   backward-ring recv: valid, receiver-side chunk slot, micro-
                batch of an upstream dx cotangent
    """
    schedule: str
    n_stages: int
    n_chunks: int                 # V: local chunks per stage
    layers_per_chunk: int         # k_c
    n_microbatches: int
    kind: tuple                   # [T][S] TICK_* codes
    unit_v: tuple                 # [T][S] local chunk index
    unit_mb: tuple                # [T][S] micro-batch index
    frecv_valid: tuple
    frecv_v: tuple
    frecv_mb: tuple
    frecv_final: tuple
    hrecv_valid: tuple
    hrecv_mb: tuple
    brecv_valid: tuple
    brecv_v: tuple
    brecv_mb: tuple

    @property
    def n_ticks(self) -> int:
        return len(self.kind)

    @property
    def n_global_chunks(self) -> int:
        return self.n_chunks * self.n_stages

    def validate_executable(self) -> None:
        """Raise if the table cannot run on the generic executor
        (core/pipeline.py): unknown tick kinds, or split-backward ticks
        (kinds 3/4) whose dgrad→wgrad pairing is inconsistent.

        The message names the offending kinds and the planner flag that
        emits each known one, so a stale or foreign plan JSON (e.g. a table
        from a newer planner revision) is diagnosable from the error alone.
        """
        bad = sorted({k for row in self.kind for k in row
                      if k not in EXECUTABLE_TICK_KINDS})
        if bad:
            def name(k):
                n = TICK_NAMES.get(k)
                return f"{k} ({n})" if n else str(k)
            raise NotImplementedError(
                f"tick table for schedule {self.schedule!r} contains tick "
                f"kinds {[name(k) for k in bad]} this executor cannot "
                f"interpret; executable kinds are "
                f"{dict((k, TICK_NAMES[k]) for k in EXECUTABLE_TICK_KINDS)} "
                f"(kinds 3/4 = the dgrad/wgrad halves emitted by "
                f"build_tick_table(split_backward=True)).  A plan JSON with "
                f"other kinds comes from a different planner revision — "
                f"re-emit the plan with this repo's planner.")
        if self.is_split:
            # a malformed split table (e.g. hand-edited JSON) must fail here,
            # not as silent garbage gradients in the executor
            self.residual_slots()

    @property
    def is_split(self) -> bool:
        """True when the table carries zero-bubble dgrad/wgrad ticks."""
        return any(k in (TICK_BDGRAD, TICK_BWGRAD)
                   for row in self.kind for k in row)

    def residual_slots(self) -> tuple[list, int]:
        """Ring-buffer slot assignment for the dgrad→wgrad residuals.

        A BDGRAD tick saves its (activation, cotangent) residual into a
        per-stage slot; the matching BWGRAD tick replays from that slot and
        frees it.  Slots are assigned by free-list so the buffer is bounded
        by the maximum number of dgrads outstanding at once (the table's max
        dgrad→wgrad distance in units, not ticks), NOT by V*M.

        Returns ``(slot, depth)``: ``slot`` a [T][S] int table (0 for
        non-split ticks) and ``depth`` the ring-buffer bound R the executor
        sizes its residual buffers with.  Raises ValueError on inconsistent
        pairing — a wgrad with no strictly-earlier dgrad, or a dgrad whose
        wgrad never runs (the strict ready rules of the split scheduler).
        """
        S = self.n_stages
        slot = [[0] * S for _ in range(self.n_ticks)]
        depth = 0
        free: list[list[int]] = [[] for _ in range(S)]
        n_alloc = [0] * S
        held: list[dict] = [{} for _ in range(S)]
        for t in range(self.n_ticks):
            for s in range(S):
                k = self.kind[t][s]
                key = (self.unit_v[t][s], self.unit_mb[t][s])
                if k == TICK_BDGRAD:
                    if key in held[s]:
                        raise ValueError(
                            f"split tick table: duplicate BDGRAD for chunk "
                            f"v={key[0]} mb={key[1]} on stage {s} (tick {t})")
                    sl = free[s].pop() if free[s] else n_alloc[s]
                    if sl == n_alloc[s]:
                        n_alloc[s] += 1
                        depth = max(depth, n_alloc[s])
                    held[s][key] = (sl, t)
                    slot[t][s] = sl
                elif k == TICK_BWGRAD:
                    if key not in held[s]:
                        raise ValueError(
                            f"split tick table: BWGRAD for chunk v={key[0]} "
                            f"mb={key[1]} on stage {s} (tick {t}) has no "
                            f"earlier BDGRAD — not a "
                            f"build_tick_table(split_backward=True) table")
                    sl, t_bd = held[s].pop(key)
                    if t_bd >= t:
                        raise ValueError(
                            f"split tick table: BWGRAD at tick {t} not "
                            f"strictly after its BDGRAD (tick {t_bd}) on "
                            f"stage {s}")
                    slot[t][s] = sl
                    free[s].append(sl)
        leftover = [(s, key) for s in range(S) for key in held[s]]
        if leftover:
            raise ValueError(
                f"split tick table: {len(leftover)} BDGRAD tick(s) whose "
                f"BWGRAD half never runs (first: stage {leftover[0][0]}, "
                f"(v, mb)={leftover[0][1]}) — the weight gradient would be "
                f"silently dropped")
        return slot, max(depth, 1)

    def residual_depth(self) -> int:
        """The executor's residual ring-buffer bound R (1 for unsplit)."""
        return self.residual_slots()[1]

    def gather_segments(self) -> list:
        """Partition of [0, T) at ZeRO weight-gather boundaries: a list of
        ``(t0, t1, chunks)`` where ``chunks`` are the local chunk indices
        whose weights must be gathered before tick ``t0`` (first forward
        use at any stage).  Exactly V gathers per pass, total."""
        first_use = {}
        for t, row in enumerate(self.kind):
            for s, k in enumerate(row):
                if k in (TICK_F, TICK_B, TICK_BDGRAD, TICK_BWGRAD):
                    v = self.unit_v[t][s]
                    first_use.setdefault(v, t)
        for v in range(self.n_chunks):
            first_use.setdefault(v, 0)
        bounds = sorted({t for t in first_use.values()} | {0})
        segs = []
        for i, t0 in enumerate(bounds):
            t1 = bounds[i + 1] if i + 1 < len(bounds) else self.n_ticks
            segs.append((t0, t1, sorted(v for v, t in first_use.items()
                                        if t == t0)))
        return segs

    def predicted_collectives(self, *, partitioned: bool,
                              n_layer_leaves: int = 1) -> dict:
        """Collective counts of the JAX package's executor per optimizer
        step: three ring permutes a tick, and when partitioned one data-group
        all-gather and one reduce-scatter per (layer leaf, local chunk).  The
        port issues the same data-group counts; its stage-group transfers
        are the valid ring entries only."""
        out = {"ppermute_stage": 3 * self.n_ticks}
        if partitioned:
            out["all_gather_data"] = self.n_chunks * n_layer_leaves
            out["psum_scatter_data"] = self.n_chunks * n_layer_leaves
        return out

    def timeline(self) -> list:
        """The table's own predicted timeline in the shared observability
        schema ``(stage, kind, chunk, microbatch, start, end)`` — one time
        unit per tick, every non-idle unit spanning ``[t, t+1)``.  This is
        the lockstep rendering the segmented executor measurement
        (obs/trace.measure_tick_timeline) also produces, so the two align
        directly in ``obs/drift.drift_report``."""
        out = []
        for t, row in enumerate(self.kind):
            for s, k in enumerate(row):
                if k == TICK_IDLE:
                    continue
                out.append((s, TICK_NAMES[k], self.unit_v[t][s],
                            self.unit_mb[t][s], float(t), float(t + 1)))
        return out

    def to_json(self) -> dict:
        return {
            "schedule": self.schedule,
            "n_stages": self.n_stages,
            "n_chunks": self.n_chunks,
            "layers_per_chunk": self.layers_per_chunk,
            "n_microbatches": self.n_microbatches,
            "n_ticks": self.n_ticks,
            "kind": [list(r) for r in self.kind],
            "v": [list(r) for r in self.unit_v],
            "mb": [list(r) for r in self.unit_mb],
            "predicted_collectives": self.predicted_collectives(
                partitioned=True),
        }

    @classmethod
    def from_json(cls, doc: dict) -> "TickTable":
        return _finish_table(doc["schedule"], doc["n_stages"],
                             doc["n_chunks"], doc["layers_per_chunk"],
                             doc["n_microbatches"],
                             [list(r) for r in doc["kind"]],
                             [list(r) for r in doc["v"]],
                             [list(r) for r in doc["mb"]])


def _finish_table(schedule, S, V, k_c, M, kind, unit_v, unit_mb) -> TickTable:
    """Derive the recv tables from the core (kind, v, mb) arrays."""
    T_ = len(kind)
    n_g = V * S
    z = lambda: [[0] * S for _ in range(T_)]
    fr_valid, fr_v, fr_mb, fr_fin = z(), z(), z(), z()
    hr_valid, hr_mb = z(), z()
    br_valid, br_v, br_mb = z(), z(), z()
    for t in range(T_):
        for s in range(S):
            # forward ring: stage s receives from (s-1) % S
            snd = (s - 1) % S
            if kind[t][snd] == TICK_F:
                g = unit_v[t][snd] * S + snd
                fr_valid[t][s] = 1
                fr_mb[t][s] = unit_mb[t][snd]
                if g == n_g - 1:
                    fr_fin[t][s] = 1          # head input at the loss stage
                else:
                    fr_v[t][s] = (g + 1) // S  # receiver-side chunk slot
            # backward ring: stage s receives from (s+1) % S
            snd = (s + 1) % S
            if kind[t][snd] in (TICK_B, TICK_BDGRAD):
                g = unit_v[t][snd] * S + snd
                if g > 0:
                    br_valid[t][s] = 1
                    br_v[t][s] = (g - 1) // S
                    br_mb[t][s] = unit_mb[t][snd]
        # loss ring: the tick a final output reaches stage 0, its head
        # cotangent rides the reverse ring to stage S-1 within the same tick
        if fr_fin[t][0]:
            hr_valid[t][S - 1] = 1
            hr_mb[t][S - 1] = fr_mb[t][0]
    tt = lambda rows: tuple(tuple(r) for r in rows)
    return TickTable(
        schedule=schedule, n_stages=S, n_chunks=V, layers_per_chunk=k_c,
        n_microbatches=M, kind=tt(kind), unit_v=tt(unit_v),
        unit_mb=tt(unit_mb), frecv_valid=tt(fr_valid), frecv_v=tt(fr_v),
        frecv_mb=tt(fr_mb), frecv_final=tt(fr_fin), hrecv_valid=tt(hr_valid),
        hrecv_mb=tt(hr_mb), brecv_valid=tt(br_valid), brecv_v=tt(br_v),
        brecv_mb=tt(br_mb))


def build_tick_table(sim: SimConfig, *, split_backward: bool = False
                     ) -> TickTable:
    """Lockstep-schedule ``stage_order`` into an executable tick table.

    List scheduling over integer ticks, at most one unit per stage per tick,
    head-of-line per stage (same discipline as the event engine, with unit
    compute times and next-tick arrivals).  Readiness mirrors the executor's
    in-tick dataflow — a value produced at tick t is usable from tick t+1:

      F(g, mb)       g == 0, or F(g-1, mb) ran at an earlier tick (the
                     activation arrived over the forward ring)
      B(n_g-1, mb)   F(n_g-1, mb) ran at an earlier tick: the final output
                     wrapped to stage 0, whose head VJP + loss-ring permute
                     delivered the cotangent within that same tick
      B(g, mb)       B(g+1, mb) ran at an earlier tick (dx arrived over the
                     backward ring)

    ``split_backward=True`` is the zero-bubble split (ZB-H1-style greedy):
    every B unit becomes a BDGRAD tick in place, and its deferred BWGRAD
    half fills the first later tick its stage would otherwise idle — the
    warmup/cooldown bubble slots of 1f1b/interleaved — with leftovers
    drained as a tail.  The extended ready rules stay strict: a BWGRAD may
    run only at a tick strictly after its BDGRAD (which saved the residual),
    never displaces a ready head-of-line unit, and every BDGRAD's wgrad
    half must eventually run (``TickTable.residual_slots`` re-checks all
    three on any table).  ``DeadlockError`` still fires if no stage can
    progress on head-of-line units or pending wgrads.
    """
    assert sim.include_backward, "tick tables describe full grad passes"
    S, M, V = sim.n_stages, sim.n_microbatches, sim.n_chunks
    n_g = V * S
    orders = [deque(stage_order(sim, s)) for s in range(S)]
    f_done: dict[tuple[int, int], int] = {}
    b_done: dict[tuple[int, int], int] = {}
    # per-stage deferred wgrad halves, oldest first: (v, mb, dgrad_tick)
    pend_w: list[deque] = [deque() for _ in range(S)]
    kind, unit_v, unit_mb = [], [], []
    t = 0
    while any(orders) or any(pend_w):
        row_k, row_v, row_mb = [TICK_IDLE] * S, [0] * S, [0] * S
        progressed = False
        for s in range(S):
            ok = False
            if orders[s]:
                knd, v, mb = orders[s][0]
                g = v * S + s
                if knd == "F":
                    ok = g == 0 or f_done.get((g - 1, mb), t) < t
                elif g == n_g - 1:
                    ok = f_done.get((g, mb), t) < t
                else:
                    ok = b_done.get((g + 1, mb), t) < t
            if ok:
                orders[s].popleft()
                progressed = True
                row_v[s], row_mb[s] = v, mb
                if knd == "F":
                    row_k[s] = TICK_F
                    f_done[(g, mb)] = t
                elif split_backward:
                    row_k[s] = TICK_BDGRAD
                    b_done[(g, mb)] = t
                    pend_w[s].append((v, mb, t))
                else:
                    row_k[s] = TICK_B
                    b_done[(g, mb)] = t
            elif pend_w[s] and pend_w[s][0][2] < t:
                # bubble slot: run the oldest deferred wgrad (its residual
                # was saved by a strictly-earlier BDGRAD tick)
                v, mb, _ = pend_w[s].popleft()
                progressed = True
                row_k[s], row_v[s], row_mb[s] = TICK_BWGRAD, v, mb
        if not progressed:
            stuck = {s: orders[s][0] for s in range(S) if orders[s]}
            pend = {s: list(pend_w[s]) for s in range(S) if pend_w[s]}
            raise DeadlockError(
                f"tick table for {sim.schedule} "
                f"(split_backward={split_backward}) deadlocked at tick {t}; "
                f"heads: {stuck}; pending wgrads: {pend}")
        kind.append(row_k)
        unit_v.append(row_v)
        unit_mb.append(row_mb)
        t += 1
    return _finish_table(sim.schedule, S, V, sim.layers_per_chunk, M,
                         kind, unit_v, unit_mb)


def _simulate_serving(sim: SimConfig, cost: CostModel) -> SimResult:
    """One decode step of a live batch against the weight + KV HBM streams."""
    L = sim.n_stages * sim.layers_per_stage
    R = sim.serve_batch
    weight_bytes = L * cost.layer_param_bytes
    if sim.serve_block > 0:
        blocks = (sim.serve_ctx + sim.serve_block - 1) // sim.serve_block
        toks_per_seq = blocks * sim.serve_block
    else:
        toks_per_seq = max(sim.serve_max_seq, sim.serve_ctx)
    kv_bytes = float(R) * toks_per_seq * cost.kv_bytes_per_token
    hbm_s = ((weight_bytes + kv_bytes) / cost.hbm_bw
             if cost.hbm_bw > 0 else 0.0)
    compute_s = (R * cost.serve_flops_per_token / cost.flops_rate
                 if cost.flops_rate > 0 else 0.0)
    coll_bytes = float(R) * cost.serve_coll_bytes_per_token
    coll_s = coll_bytes / cost.coll_bw if cost.coll_bw > 0 else 0.0
    step = max(hbm_s, compute_s) + coll_s      # TP psums are in-line, unhidden
    busy = max(compute_s, 1e-30)
    return SimResult(
        step_time=step, compute_s=compute_s, busy_per_stage=[busy],
        bubble_fraction=1.0 - busy / step if step > 0 else 0.0,
        p2p_s=0.0, p2p_bytes=0.0, coll_s=coll_s, coll_bytes=coll_bytes,
        counts={"tok_per_s": R / step if step > 0 else 0.0,
                "hbm_s": hbm_s, "weight_bytes": weight_bytes,
                "kv_bytes": kv_bytes, "kv_tokens_read": R * toks_per_seq},
        peak_live_mb=[0], opt_s=0.0)


def simulate(sim: SimConfig, cost: CostModel, *,
             record_timeline: bool = False) -> SimResult:
    if sim.serving:
        return _simulate_serving(sim, cost)
    S, M, V = sim.n_stages, sim.n_microbatches, sim.n_chunks
    k_c = sim.layers_per_chunk
    n_g = sim.n_global_chunks
    rr = sim.round_robin

    t_f = k_c * cost.t_fwd_layer
    t_b = k_c * cost.t_bwd_layer
    split = sim.split_backward and sim.include_backward
    t_bw = WGRAD_FRACTION * t_b if split else 0.0
    t_bd = t_b - t_bw               # dgrad: recompute + activation transposes
    t_p2p = (cost.act_bytes / cost.p2p_bw
             if S > 1 and cost.p2p_bw > 0 else 0.0)
    n = sim.n_data
    ring = (n - 1) / n if n > 1 else 0.0
    gather_bytes = ring * k_c * cost.layer_param_bytes
    scatter_bytes = ring * k_c * cost.layer_grad_bytes
    psum_bytes = 2.0 * ring * k_c * cost.layer_grad_bytes
    t_gather = gather_bytes / cost.coll_bw if cost.coll_bw > 0 else 0.0
    t_scatter = scatter_bytes / cost.coll_bw if cost.coll_bw > 0 else 0.0
    t_psum = psum_bytes / cost.coll_bw if cost.coll_bw > 0 else 0.0

    def chunk_gidx(v: int, s: int) -> int:
        return v * S + s if rr else s

    orders = [deque(stage_order(sim, s)) for s in range(S)]
    n_units_total = sum(len(o) for o in orders)

    stage_free = [0.0] * S
    sendf_free = [0.0] * S
    sendb_free = [0.0] * S
    coll_free = [0.0] * S
    if sim.shared_link:
        sendb_free = sendf_free          # one wire: alias the engine list

    def _take(engine: list[float], s: int, ready: float, dur: float) -> float:
        start = max(ready, engine[s])
        engine[s] = start + dur
        return start + dur

    def p2p_engine(direction: str) -> list[float]:
        if sim.shared_link:
            return sendf_free
        return sendf_free if direction == "f" else sendb_free

    def coll_engine() -> list[float]:
        return sendf_free if sim.shared_link else coll_free

    f_end: dict[tuple[int, int], float] = {}
    arrive_a: dict[tuple[int, int], float] = {}   # fwd activation at chunk g
    arrive_c: dict[tuple[int, int], float] = {}   # cotangent for chunk g
    last_event = 0.0

    # --- data-axis collective gating (prefetch model: gathers serialize on
    # the collective engine in program order; issue time is unconstrained, so
    # the model is bandwidth-bound, not latency-bound) -------------------
    gather_ready_f: dict[tuple[int, int], float] = {}
    gather_ready_b: dict[tuple[int, int], float] = {}
    gather_ready_unit: dict[tuple[str, int, int, int], float] = {}
    n_gathers = 0
    if sim.partitioned and n > 1 and t_gather > 0 and not sim.overlap_coll:
        pass   # charged to the compute engine at first use, below
    elif sim.partitioned and n > 1:
        eng = coll_engine()
        if sim.method == "layered":
            for s in range(S):
                seen: list[int] = []
                for kind, v, mb in orders[s]:
                    key = (s, v)
                    d = gather_ready_f if kind == "F" else gather_ready_b
                    if key not in d:
                        d[key] = _take(eng, s, 0.0, t_gather)
                        n_gathers += 1
        else:
            for s in range(S):
                for kind, v, mb in orders[s]:
                    gather_ready_unit[(kind, s, v, mb)] = _take(
                        eng, s, 0.0, t_gather)
                    n_gathers += 1

    remaining_b_chunk = {(s, v): M for s in range(S) for v in range(V)}
    remaining_b_stage = [V * M for _ in range(S)]
    n_reduces = 0
    reduce_end = 0.0
    stage_reduce_end = [0.0] * S
    coll_bytes_total = float(n_gathers) * gather_bytes
    coll_s_total = float(n_gathers) * t_gather
    t_opt_chunk = k_c * cost.t_opt_layer(sim.fused_optimizer)
    # per-chunk overlapped placement is a property of the layered schedule
    # (§C.3), not of the kernel: other methods update in one end-of-step tail
    opt_per_chunk = sim.method == "layered"
    opt_free = [0.0] * S              # per-stage HBM engine (update sweeps)
    opt_s_total = 0.0
    n_opt = 0

    busy = [0.0] * S
    fwd_sends = [0] * S
    bwd_sends = [0] * S
    p2p_bytes_total = 0.0
    p2p_s_total = 0.0
    live = [0] * S
    peak_live = [0] * S
    timeline: list | None = [] if record_timeline else None
    pending_gather_charge: dict[tuple, bool] = {}
    # split-backward state: deferred wgrad halves (v, mb, dgrad_end) and the
    # compute-engine busy intervals the gap-filling pass slots them into
    pending_w: list[list] = [[] for _ in range(S)]
    busy_iv: list[list] = [[] for _ in range(S)]

    def gather_gate(kind: str, s: int, v: int, mb: int) -> float:
        """Ready-time contribution of the ZeRO weight gather for a unit."""
        nonlocal n_gathers, coll_bytes_total, coll_s_total
        if not sim.partitioned or n <= 1 or t_gather <= 0:
            return 0.0
        if sim.overlap_coll:
            if sim.method == "layered":
                d = gather_ready_f if kind == "F" else gather_ready_b
                return d.get((s, v), 0.0)
            return gather_ready_unit.get((kind, s, v, mb), 0.0)
        # un-overlapped: the gather runs on the compute engine at first need
        key = (kind, s, v) if sim.method == "layered" else (kind, s, v, mb)
        if key not in pending_gather_charge:
            pending_gather_charge[key] = True
            g0 = max(stage_free[s], 0.0)
            stage_free[s] = g0 + t_gather
            busy_iv[s].append((g0, stage_free[s]))
            n_gathers += 1
            coll_bytes_total += gather_bytes
            coll_s_total += t_gather
        return 0.0

    def issue_reduce(s: int, at: float, nbytes: float, dur: float) -> None:
        nonlocal n_reduces, reduce_end, coll_bytes_total, coll_s_total
        if n <= 1 or nbytes <= 0:
            return
        if sim.overlap_coll:
            end = _take(coll_engine(), s, at, dur)
        else:
            start = max(at, stage_free[s])
            stage_free[s] = start + dur
            end = start + dur
        n_reduces += 1
        reduce_end = max(reduce_end, end)
        stage_reduce_end[s] = max(stage_reduce_end[s], end)
        coll_bytes_total += nbytes
        coll_s_total += dur

    def charge_opt_fused(s: int, grad_ready: float) -> None:
        """§C.3 fused update: one chunk's AdamW sweep starts the moment its
        gradient is fully reduced.  It runs on the per-stage HBM engine
        (``opt_free``), not the compute engine — the update has no dataflow
        into the remaining backward chunks, so it overlaps them instead of
        forming an end-of-step tail."""
        nonlocal opt_s_total, n_opt
        if t_opt_chunk <= 0:
            return
        start = max(opt_free[s], stage_reduce_end[s], grad_ready)
        opt_free[s] = start + t_opt_chunk
        opt_s_total += t_opt_chunk
        n_opt += 1

    def finish_b_unit(s: int, v: int, end: float) -> None:
        """Gradient-reduction + fused-update placement once a chunk's
        backward unit is COMPLETE (at B end when unsplit, at the deferred
        wgrad's end when split — the reduce-per-chunk frequency is identical
        either way)."""
        remaining_b_chunk[(s, v)] -= 1
        remaining_b_stage[s] -= 1
        chunk_done = remaining_b_chunk[(s, v)] == 0
        if sim.partitioned:
            if sim.method == "layered":
                if chunk_done:
                    issue_reduce(s, end, scatter_bytes, t_scatter)
            else:
                issue_reduce(s, end, scatter_bytes, t_scatter)
        else:
            if sim.method == "layered":
                if chunk_done:
                    issue_reduce(s, end, psum_bytes, t_psum)
            elif remaining_b_stage[s] == 0:
                issue_reduce(s, end, V * psum_bytes, V * t_psum)
        if chunk_done and opt_per_chunk:
            charge_opt_fused(s, end)

    def ready(s: int, unit: tuple[str, int, int]) -> bool:
        kind, v, mb = unit
        g = chunk_gidx(v, s)
        if kind == "F":
            return g == 0 or (g, mb) in arrive_a
        return (g, mb) in arrive_c

    def schedule_unit(s: int, unit: tuple[str, int, int]) -> None:
        nonlocal last_event, p2p_bytes_total, p2p_s_total
        kind, v, mb = unit
        g = chunk_gidx(v, s)
        gate = gather_gate(kind, s, v, mb)
        if kind == "F":
            inp = arrive_a.get((g, mb), 0.0)
            start = max(stage_free[s], inp, gate)
            end = start + t_f
            stage_free[s] = end
            busy[s] += t_f
            f_end[(g, mb)] = end
            live[s] += 1
            peak_live[s] = max(peak_live[s], live[s])
            # forward send (ring: the last chunk wraps to the loss stage).
            # Un-overlapped p2p (paper eq. 11): the send serializes on the
            # producing stage's compute engine instead of a send engine.
            if S > 1:
                if sim.overlap_p2p:
                    done = _take(p2p_engine("f"), s, end, t_p2p)
                else:
                    stage_free[s] = end + t_p2p
                    done = stage_free[s]
                fwd_sends[s] += 1
                p2p_bytes_total += cost.act_bytes
                p2p_s_total += t_p2p
            else:
                done = end
            if g < n_g - 1:
                arrive_a[(g + 1, mb)] = done
            else:
                # loss turnaround: head latency + cotangent return transfer
                # (kept on the send engine even when un-overlapped: the loss
                # stage's compute timeline is not interrupted mid-step)
                loss_stage = (s + 1) % S
                cot = done + cost.t_head
                if S > 1:
                    cot = _take(p2p_engine("b"), loss_stage, cot, t_p2p)
                    bwd_sends[loss_stage] += 1
                    p2p_bytes_total += cost.act_bytes
                    p2p_s_total += t_p2p
                arrive_c[(g, mb)] = cot
        else:
            start = max(stage_free[s], f_end[(g, mb)],
                        arrive_c[(g, mb)], gate)
            # split: the dgrad half alone sits on the cotangent critical
            # path; the wgrad half is deferred into a later idle gap
            dur = t_bd if split else t_b
            end = start + dur
            stage_free[s] = end
            busy[s] += dur
            live[s] -= 1
            if g > 0:
                if S > 1:
                    if sim.overlap_p2p:
                        done = _take(p2p_engine("b"), s, end, t_p2p)
                    else:
                        stage_free[s] = end + t_p2p
                        done = stage_free[s]
                    bwd_sends[s] += 1
                    p2p_bytes_total += cost.act_bytes
                    p2p_s_total += t_p2p
                else:
                    done = end
                arrive_c[(g - 1, mb)] = done
            if split:
                pending_w[s].append((v, mb, end))
            else:
                finish_b_unit(s, v, end)
        last_event = max(last_event, stage_free[s])
        busy_iv[s].append((start, stage_free[s]))
        if timeline is not None:
            tk = "Bd" if (split and kind != "F") else kind
            timeline.append((s, tk, v, mb, round(start, 9), round(end, 9)))

    # --- head-of-line scheduling loop ------------------------------------
    work = deque(range(S))
    in_work = [True] * S
    n_scheduled = 0
    while work:
        s = work.popleft()
        in_work[s] = False
        progressed = False
        while orders[s] and ready(s, orders[s][0]):
            schedule_unit(s, orders[s].popleft())
            n_scheduled += 1
            progressed = True
        if progressed:
            for t in (s, (s + 1) % S, (s - 1) % S):
                if not in_work[t]:
                    in_work[t] = True
                    work.append(t)
    if n_scheduled != n_units_total:
        stuck = {s: orders[s][0] for s in range(S) if orders[s]}
        raise DeadlockError(
            f"schedule deadlocked with {n_units_total - n_scheduled} units "
            f"pending; heads: {stuck}")

    # split backward: slot every deferred wgrad into its stage's earliest
    # compute-engine idle gap at/after its dgrad finished (leftovers append
    # at the stage's end).  Wgrads have no downstream consumers, so this
    # post-hoc placement cannot perturb the forward/dgrad event times above;
    # chunk-gradient reduces + fused updates fire at the wgrad that
    # completes each chunk, same per-chunk frequency as the unsplit path.
    n_wgrad = 0
    if split:
        for s in range(S):
            gaps = []
            cur = 0.0
            for (a, b) in sorted(busy_iv[s]):
                if a > cur:
                    gaps.append((cur, a))
                cur = max(cur, b)
            gaps.append((cur, float("inf")))
            i = 0
            for (v, mb, w_ready) in pending_w[s]:
                while True:
                    gs, ge = gaps[i]
                    w0 = max(gs, w_ready)
                    if ge - w0 >= t_bw:
                        break
                    i += 1
                gaps[i] = (w0 + t_bw, ge)
                w1 = w0 + t_bw
                busy[s] += t_bw
                n_wgrad += 1
                stage_free[s] = max(stage_free[s], w1)
                last_event = max(last_event, w1)
                finish_b_unit(s, v, w1)
                if timeline is not None:
                    timeline.append((s, "Bw", v, mb,
                                     round(w0, 9), round(w1, 9)))

    # non-layered methods: one bulk update tail per stage once all of its
    # chunk gradients are reduced (pass count still set by fused_optimizer).
    if (t_opt_chunk > 0 and not opt_per_chunk
            and sim.include_backward):
        for s in range(S):
            start = max(stage_free[s], stage_reduce_end[s])
            opt_free[s] = start + V * t_opt_chunk
            opt_s_total += V * t_opt_chunk
            n_opt += V

    step_time = max([last_event, reduce_end]
                    + opt_free + sendf_free + sendb_free)
    mean_busy = sum(busy) / S
    return SimResult(
        step_time=step_time,
        compute_s=mean_busy,
        busy_per_stage=busy,
        bubble_fraction=1.0 - mean_busy / step_time if step_time > 0 else 0.0,
        p2p_s=p2p_s_total, p2p_bytes=p2p_bytes_total,
        coll_s=coll_s_total, coll_bytes=coll_bytes_total,
        counts={"fwd_units": V * M * S, "bwd_units": V * M * S
                if sim.include_backward else 0,
                "wgrad_units": n_wgrad,
                "fwd_sends": fwd_sends, "bwd_sends": bwd_sends,
                "gathers": n_gathers, "reduces": n_reduces,
                "opt_updates": n_opt},
        peak_live_mb=peak_live,
        opt_s=opt_s_total,
        timeline=timeline,
    )


# ---------------------------------------------------------------------------
# SPMD lowering equivalents (cross-validation against core/roofline.py)
# ---------------------------------------------------------------------------
def predict_spmd_composition(spec, cost: CostModel, *,
                             head_flops: float = 0.0,
                             extra_coll_bytes: float = 0.0,
                             table: "TickTable | None" = None) -> dict:
    """Predicted per-device cost composition of the JAX package's SPMD
    tick-table executor (``repro/core/pipeline.py``) for a
    ``schedules.PipeSpec``.  The port's executor runs only the units a
    stage's row names, which the event simulator above prices
    (``planner/validate.py`` compares each with what it prices).

    The executor's accounting, derived from its construction and pinned
    against the lowered jaxpr by the conformance tests:

      * every tick, every stage runs ONE masked chunk VJP — forward plus its
        transposed dots, ``3x`` the forward dot flops per layer (the same
        bundle the remat'd AD path paid, collapsed into a single tick) — on
        garbage during bubble ticks;
      * every tick, the loss stage's masked head VJP runs stage-replicated:
        ``3x head_flops`` per tick on every device;
      * every tick permutes THREE ring payloads (forward activation, head
        cotangent, backward cotangent), each one micro-batch boundary
        activation.

    ``extra_coll_bytes`` carries the non-permute wire bytes (the end-of-step
    stage psum completing the stage-replicated outer-leaf gradients).

    Zero-bubble split tables price by the SAME per-tick bundle — every tick
    still runs the one masked joint VJP and three permutes, whether it is a
    full B, a dgrad, or a wgrad tick — so only the tick count ``T`` differs
    between a split and an unsplit schedule here.
    """
    if table is None:
        split = bool(getattr(spec, "split_backward", False))
        table = build_tick_table(SimConfig(
            n_stages=spec.n_stages, layers_per_stage=spec.layers_per_stage,
            n_microbatches=spec.n_microbatches, schedule=spec.schedule,
            n_chunks=getattr(spec, "n_chunks", 0) or 0,
            split_backward=split), split_backward=split)
    T_ = table.n_ticks
    k_c = table.layers_per_chunk
    flops = T_ * (3.0 * k_c * cost.flops_fwd_layer + 3.0 * head_flops)
    p2p = 3.0 * T_ * cost.act_bytes
    coll = p2p + extra_coll_bytes
    return {
        "dot_flops": flops,
        "p2p_bytes": p2p,
        "n_ticks": T_,
        "compute_s": flops / cost.flops_rate,
        "collective_s": coll / cost.p2p_bw if cost.p2p_bw > 0 else 0.0,
    }
