"""Pipeline schedule specs (counterpart of ``repro/core/schedules.py``, the
paper's §4).

``PipeSpec`` names a schedule and its shape; the executable form of a
schedule is the tick table that ``planner.simulator.build_tick_table`` emits
and ``core/pipeline.py`` runs.  Four schedules lower to tick tables:

  naive/gpipe   stage s owns layers [s*K, (s+1)*K): one chunk of K layers,
                all forwards, a flush, all backwards; bubble K*(S-1)
                layer-ticks per stage
  modular       the paper's round-robin placement, stage s owns layers
                {s, s+S, ...}: K one-layer chunks, one layer a tick, every
                micro-batch of a layer in a row (layered accumulation per
                stage); bubble S-1 layer-ticks per stage
  1f1b          naive's placement and bubble, one forward one backward in
                the steady state
  interleaved   Megatron's 1F1B over V round-robin chunks of K/V layers

The closed-form tick accounting covers modular and naive; 1f1b and
interleaved are counted from their tick tables.
"""
from __future__ import annotations

import dataclasses

# names accepted here; "naive" is the paper's name for gpipe
KNOWN_SCHEDULES = ("modular", "naive", "gpipe", "1f1b", "interleaved")


@dataclasses.dataclass(frozen=True)
class PipeSpec:
    n_stages: int
    layers_per_stage: int
    n_microbatches: int
    schedule: str = "modular"    # modular | naive/gpipe | 1f1b | interleaved
    n_chunks: int = 0            # V (interleaved only; 0 = auto)
    # zero-bubble backward split: the tick table carries dgrad / wgrad
    # halves instead of full B units (same gradients, another order)
    split_backward: bool = False

    def __post_init__(self):
        assert self.schedule in KNOWN_SCHEDULES, \
            f"unknown schedule {self.schedule!r}; known: {KNOWN_SCHEDULES}"
        K = self.layers_per_stage
        if self.schedule == "modular":
            assert self.n_microbatches >= self.n_stages, \
                "modular pipeline needs n_mu >= n_stages"
            v = K
        elif self.schedule == "interleaved":
            v = self.n_chunks or min(2, K)
            M, S = self.n_microbatches, self.n_stages
            assert M <= S or M % S == 0, \
                f"interleaved 1f1b needs n_mu <= n_stages or n_mu % " \
                f"n_stages == 0 (got M={M}, S={S})"
        else:
            v = 1
        assert K % v == 0, f"chunks {v} must divide layers/stage {K}"
        object.__setattr__(self, "n_chunks", v)

    def sim_config(self):
        """The planner ``SimConfig`` naming the same schedule."""
        from repro_torch.planner import simulator as simlib
        return simlib.SimConfig(
            n_stages=self.n_stages, layers_per_stage=self.layers_per_stage,
            n_microbatches=self.n_microbatches, schedule=self.schedule,
            n_chunks=self.n_chunks if self.schedule == "interleaved" else 0,
            split_backward=self.split_backward)

    def tick_table(self):
        """The executable tick table of this spec (split when it says so)."""
        from repro_torch.planner import simulator as simlib
        return simlib.build_tick_table(self.sim_config(),
                                       split_backward=self.split_backward)

    @property
    def layers_per_chunk(self) -> int:
        return self.layers_per_stage // self.n_chunks

    @property
    def num_layers(self) -> int:
        return self.n_stages * self.layers_per_stage

    # ------------------------------------------------------------------
    # Closed-form accounting for the two paper schedules
    def _closed_form(self):
        assert self.schedule in ("modular", "naive"), \
            f"closed-form tick accounting covers modular/naive only " \
            f"(schedule {self.schedule!r}: use tick_table())"

    @property
    def total_outer_steps(self) -> int:
        self._closed_form()
        S, K, M = self.n_stages, self.layers_per_stage, self.n_microbatches
        return K * M + S - 1 if self.schedule == "modular" else M + S - 1

    @property
    def layer_ticks_per_stage(self) -> int:
        K = self.layers_per_stage
        return self.total_outer_steps * (1 if self.schedule == "modular" else K)

    @property
    def bubble_layer_ticks(self) -> int:
        self._closed_form()
        S, K = self.n_stages, self.layers_per_stage
        return (S - 1) if self.schedule == "modular" else K * (S - 1)

    @property
    def bubble_fraction(self) -> float:
        return self.bubble_layer_ticks / self.layer_ticks_per_stage

    @property
    def permutes(self) -> int:
        """Ring rounds of the lock-step rendering (one per outer step)."""
        return self.total_outer_steps

    @property
    def compute_layer_ticks(self) -> int:
        """Busy layer-ticks per stage: K*M, whatever the schedule."""
        return self.layers_per_stage * self.n_microbatches

    @property
    def p2p_sends_per_stage(self) -> int:
        """Forward boundary transfers a stage makes (modular: one per busy
        layer-tick, K*M; naive: one per stage visit, M), the final layer's
        wrap to the loss stage included."""
        self._closed_form()
        M = self.n_microbatches
        if self.schedule == "modular":
            return self.layers_per_stage * M
        return M

    def p2p_bytes_per_tick(self, act_bytes: float) -> float:
        """One micro-batch's boundary activation in both schedules: the
        eq. 10 vs 11 traffic ratio is in the number of rounds."""
        return float(act_bytes)

    def fwd_p2p_bytes(self, act_bytes: float) -> float:
        """Forward p2p bytes a stage sends."""
        return self.p2p_sends_per_stage * self.p2p_bytes_per_tick(act_bytes)
