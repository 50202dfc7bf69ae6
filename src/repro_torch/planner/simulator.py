"""Executable tick tables of the pipeline schedules (the tick-table half of
``repro/planner/simulator.py``; its event simulator is not ported).

A tick table is the lock-step rendering of a schedule's per-stage program
(``stage_order``): T rows, one per tick, and in each row at most one
(kind, chunk, micro-batch) unit for every stage.  ``core/pipeline.py`` runs
it.  The table, not the executor, is where schedules differ.  Its JSON form
(``TickTable.to_json``) is the JAX package's, key for key, so a table made
by either package loads into the other.

Chunk placement is the same for every schedule: stage s's local chunk v is
global chunk g = v*S + s, which holds global layers [g*k_c, (g+1)*k_c).
Consecutive global chunks are one forward ring hop apart.
"""
from __future__ import annotations

import dataclasses
from collections import deque

SCHEDULES = ("gpipe", "modular", "1f1b", "interleaved")
_ALIASES = {"naive": "gpipe"}

# Tick kinds (the integers are part of the plan-JSON contract).  BDGRAD and
# BWGRAD are the zero-bubble split of a backward unit: the activation-path
# half, which sends the upstream cotangent at once, and the weight-path half,
# replayed later from a saved residual in what would be a bubble slot.
TICK_IDLE, TICK_F, TICK_B, TICK_BDGRAD, TICK_BWGRAD = 0, 1, 2, 3, 4
EXECUTABLE_TICK_KINDS = (TICK_IDLE, TICK_F, TICK_B, TICK_BDGRAD, TICK_BWGRAD)
# the kinds' names in the shared timeline schema; idle ticks have none
TICK_NAMES = {TICK_IDLE: None, TICK_F: "F", TICK_B: "B",
              TICK_BDGRAD: "Bd", TICK_BWGRAD: "Bw"}
EXECUTABLE_SCHEDULES = SCHEDULES


def canonical_schedule(name: str) -> str:
    name = _ALIASES.get(name, name)
    if name not in SCHEDULES:
        raise ValueError(f"unknown schedule {name!r}; known: {SCHEDULES}")
    return name


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """A schedule's shape: the fields the tick tables read."""
    n_stages: int
    layers_per_stage: int           # K: layers owned by each stage
    n_microbatches: int
    schedule: str = "modular"       # gpipe | modular | 1f1b | interleaved
    n_chunks: int = 0               # V (interleaved only; 0 = auto)

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
            # than stages the groups must tile evenly, or the chunk-major
            # 1F1B order deadlocks on the ragged group
            assert M <= S or M % S == 0, \
                f"interleaved 1f1b needs n_mu <= n_stages or n_mu % " \
                f"n_stages == 0 (got M={M}, S={S})"

    @property
    def layers_per_chunk(self) -> int:
        return self.layers_per_stage // self.n_chunks


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
        return f + b
    if sched == "modular":
        f = [("F", v, mb) for v in range(V) for mb in range(M)]
        return f + [("B", v, mb) for (_, v, mb) in reversed(f)]
    if sched == "1f1b":
        f = [("F", 0, mb) for mb in range(M)]
        b = [("B", 0, mb) for mb in range(M)]
        return _one_f_one_b(f, b, warmup=min(S - 1 - s, M))
    # interleaved: micro-batch groups of G, chunk-major within a group
    G = min(S, M)
    groups = [range(g, min(g + G, M)) for g in range(0, M, G)]
    f = [("F", v, mb) for grp in groups for v in range(V) for mb in grp]
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


class DeadlockError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Executable tick tables
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TickTable:
    """The static schedule table ``core/pipeline.py`` runs.

    The core arrays are [T][S] ints: ``kind`` (a TICK_* code), ``unit_v``
    (local chunk) and ``unit_mb`` (micro-batch); idle entries hold zeros.
    The receive tables say what stage s receives on each ring at the end of
    tick t; they are derived from the core arrays and never serialised:

      frecv_*   forward ring: valid, the receiver's chunk slot, micro-batch,
                and whether it is the network's final output (the head's
                input, arriving at the loss stage 0)
      hrecv_*   loss ring, at stage S-1: the head cotangent of the last
                chunk, sent the tick the final output arrives
      brecv_*   backward ring: valid, the receiver's chunk slot and
                micro-batch of an upstream dx cotangent
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

    def validate_executable(self) -> None:
        """Raise if the executor cannot run the table: unknown tick kinds,
        or dgrad/wgrad ticks (kinds 3/4) that do not pair up.  The message
        names the offending kinds and the planner flag that emits each known
        one."""
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
            # a malformed split table must fail here, not as wrong gradients
            self.residual_slots()

    @property
    def is_split(self) -> bool:
        """True when the table carries dgrad/wgrad ticks."""
        return any(k in (TICK_BDGRAD, TICK_BWGRAD)
                   for row in self.kind for k in row)

    def residual_slots(self) -> tuple[list, int]:
        """Slots of the dgrad -> wgrad residuals.

        A BDGRAD tick saves its (activation, cotangent) pair into a stage's
        slot; the matching BWGRAD tick replays from it and frees it.  Slots
        come from a free list, so their number is the most dgrads a stage
        has outstanding at once, not V*M.

        Returns ``(slot, depth)``: a [T][S] table (0 off split ticks) and
        the number of slots R.  Raises ValueError on a broken pairing: a
        wgrad without a strictly earlier dgrad, or a dgrad whose wgrad never
        runs.
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
        """The number of residual slots R (1 for an unsplit table)."""
        return self.residual_slots()[1]

    def gather_segments(self) -> list:
        """[0, T) cut at the ZeRO weight-gather boundaries: ``(t0, t1,
        chunks)``, where ``chunks`` are the local chunks whose weights are
        gathered before tick ``t0`` (their first use at any stage).  V
        gathers a pass in all."""
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
        """The table's predicted timeline in the shared schema ``(stage,
        kind, chunk, microbatch, start, end)``: one time unit a tick."""
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
    """Derive the receive tables from the core (kind, v, mb) arrays."""
    T_ = len(kind)
    n_g = V * S
    z = lambda: [[0] * S for _ in range(T_)]  # noqa: E731
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
        # cotangent goes back to stage S-1 within the same tick
        if fr_fin[t][0]:
            hr_valid[t][S - 1] = 1
            hr_mb[t][S - 1] = fr_mb[t][0]
    tt = lambda rows: tuple(tuple(r) for r in rows)  # noqa: E731
    return TickTable(
        schedule=schedule, n_stages=S, n_chunks=V, layers_per_chunk=k_c,
        n_microbatches=M, kind=tt(kind), unit_v=tt(unit_v),
        unit_mb=tt(unit_mb), frecv_valid=tt(fr_valid), frecv_v=tt(fr_v),
        frecv_mb=tt(fr_mb), frecv_final=tt(fr_fin), hrecv_valid=tt(hr_valid),
        hrecv_mb=tt(hr_mb), brecv_valid=tt(br_valid), brecv_v=tt(br_v),
        brecv_mb=tt(br_mb))


def build_tick_table(sim: SimConfig, *, split_backward: bool = False
                     ) -> TickTable:
    """Lock-step ``stage_order`` into an executable tick table.

    List scheduling over integer ticks, at most one unit per stage a tick,
    head-of-line per stage.  A value made at tick t is usable from tick t+1:

      F(g, mb)       g == 0, or F(g-1, mb) ran at an earlier tick
      B(n_g-1, mb)   F(n_g-1, mb) ran at an earlier tick: the final output
                     reached stage 0, whose head VJP sent the cotangent on
                     the loss ring within that same tick
      B(g, mb)       B(g+1, mb) ran at an earlier tick

    ``split_backward=True`` is the zero-bubble split: every B unit becomes a
    BDGRAD tick in place, and its BWGRAD half fills the first later tick its
    stage would idle, leftovers drained at the end.  A BWGRAD runs only
    strictly after its BDGRAD and never displaces a ready unit.
    ``DeadlockError`` fires if no stage can progress.
    """
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
                # a bubble slot: run the oldest deferred wgrad
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
