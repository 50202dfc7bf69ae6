"""The supervised training loop: auto-resume and the anomaly gate
(counterpart of ``repro/resilience/supervisor.py``).

The paper's §8.2 argues that streaming checkpoints bound a crash's loss to
one batch; this loop cashes that bound in, for one rank of a (stage x) data
x model grid of processes:

  * **auto-resume**: every checkpoint is a params + Adam-moments bundle in
    a step-scoped, checksummed directory (``reshard.save_bundle``); after a
    (real or injected) crash the supervisor restores the newest checkpoint
    that verifies, falling back over corrupt ones (bounded by
    ``max_rollback``, each logged as ``restore_rejected``), resharding when
    the saved layout differs, with a bounded number of restarts and an
    exponential backoff.  The restore copies into the tensors the run
    already holds.  Replayed steps see the same step-keyed synthetic batches,
    so a resumed trajectory is the unkilled one.
  * **the anomaly gate**: a step whose loss or grad norm is non-finite, or
    whose grad norm exceeds ``anomaly_factor`` x the running median, is
    skipped.  The JAX package's steps are functional, so it drops the new
    state; the port updates in place, so the gate runs inside the step,
    after the global norm and before the first write (``stepfn``'s
    ``gate``), and a skipped step leaves storage, moments and the step
    count bit for bit as they were (checked, by a digest of the state
    before and after).  Injected ``nan_grad`` / ``grad_spike`` faults act
    through the gate.
  * **failure-shrink**: a lost data replica (a ``lose_replica`` fault
    before step ``i``) shrinks the grid to ``data - 1`` and step ``i`` runs
    there, so no step is lost, as in the JAX package.  Here each data
    replica is a process that owns 1/D of the ZeRO chunks, so the leaving
    ranks (the last data row) *drain*: they still send their chunks, leaf
    by leaf over the old data groups, and each survivor keeps its chunk of
    the new layout (``reshard.drain_bundle``); then the leaving ranks return
    from ``run`` (``left`` in the result) and the survivors rebuild the step
    on their own groups (``dist.make_axis(..., ranks=)``), which every later
    collective, checkpoints and restores included, runs on.  Before any
    tensor moves, the shrink is refused below one data replica, when the
    plan (``plan_execution``, from ``launch.train --plan``) rejects the
    smaller grid (``planner.plan.shrink_execution``), and when the batch
    does not split over the survivors.

Events (on rank 0's ``MetricsSink``) carry the JAX package's names:
``resume``, ``restart``, ``anomaly``, ``injected_corruption``,
``restore_rejected`` and ``shrink``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import statistics
import time

import torch
import torch.distributed as tdist

from repro_torch import tree
from repro_torch.checkpointing import store
from repro_torch.core import dist, stepfn
from repro_torch.core.accumulation import AccumConfig
from repro_torch.core.dist import LOCAL, AxisCtx
from repro_torch.data.synthetic import DataConfig, batch_for
from repro_torch.models.common import ModelConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.optim.adam import AdamConfig, adam_init
from repro_torch.planner import plan as planlib
from repro_torch.resilience import faults as flt
from repro_torch.resilience import reshard
from repro_torch.resilience.reshard import MeshLayout


class SupervisorError(RuntimeError):
    """Unrecoverable supervision failure (retries exhausted, a skipped step
    that changed the state, a shrink that cannot happen)."""


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    max_restarts: int = 3        # bounded retries before giving up
    backoff_s: float = 0.0       # base of the exponential restart backoff
    checkpoint_every: int = 1    # steps between checkpoint saves
    keep_checkpoints: int = 3    # GC: newest N valid checkpoints survive
    max_rollback: int = 4        # corrupt checkpoints to fall back over
    anomaly_factor: float = 20.0  # grad-spike gate (0 disables); non-finite
    anomaly_window: int = 8       # loss/grad-norm is always gated
    seed: int = 0


def state_digest(t) -> str:
    """A fingerprint of the bits of every leaf of a tensor tree: the int64
    sums of each leaf's 16- or 32-bit words, computed where the leaf lives
    (no copy to the host), hashed together."""
    sums = []
    for leaf in tree.leaves(t):
        x = leaf.detach().reshape(-1)
        words = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
        sums.append(int(x.view(words[x.element_size()]).sum(dtype=torch.int64)))
    return hashlib.sha256(repr(sums).encode()).hexdigest()


def _dir_bytes(d: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


class Supervisor:
    """Owns this rank's (step function, state) pair and survives its
    failures.  ``layout`` names the grid and the storage layout and must be
    ``axis``'s; ``method`` picks the accumulation schedule for flat (stages
    == 1) layouts; the state lives on ``device``."""

    def __init__(self, cfg: ModelConfig, opt_cfg: AdamConfig, data_cfg: DataConfig,
                 layout: MeshLayout, *, ckpt_root: str, method: str = "layered",
                 sup: SupervisorConfig = SupervisorConfig(),
                 fault_plan: flt.FaultPlan | None = None,
                 sink: obs_metrics.MetricsSink | None = None, tracer=None,
                 axis: AxisCtx = LOCAL, device="cpu", plan_execution: dict | None = None):
        if (layout.stages, layout.data, layout.model) != (axis.nstage, axis.ndata, axis.tp):
            raise SupervisorError(f"layout {layout} is not this rank's grid "
                                  f"({axis.nstage}x{axis.ndata}x{axis.tp})")
        self.cfg, self.opt_cfg, self.data_cfg, self.layout = cfg, opt_cfg, data_cfg, layout
        self.method = method
        self.ckpt_root = ckpt_root
        self.sup = sup
        self.faults = fault_plan
        self.plan_execution = plan_execution
        self.sink = sink or obs_metrics.MetricsSink(None)
        self.tracer = tracer
        self.axis = axis
        self.device = torch.device(device)
        self.rank0 = axis.stage_index == axis.data_index == axis.model_index == 0
        self.reg = obs_metrics.resilience_registry()
        self.mtree = self.reg.init()
        self.restarts = 0
        self.history: list[dict] = []
        self.skipped: list[dict] = []      # per skipped step: the state digests
        self.io: list[dict] = []           # checkpoint saves and restores, timed
        self._gnorms: list[float] = []
        self.step_fn = None
        self.storage = None
        self.opt = None
        self._trained = False
        self._i = 0
        self._seen = (math.nan, math.nan)
        self._why = None
        self._before = None

    # -- build / state ----------------------------------------------------
    def _build(self) -> None:
        lay = self.layout
        if lay.stages > 1:
            self.step_fn = stepfn.build_pipeline_train_step(
                self.cfg, lay.pipe_spec(self.cfg), self.opt_cfg,
                partitioned=lay.partitioned, axis=self.axis, gate=self._gate)
        else:
            acc = AccumConfig(method=self.method, partitioned=lay.partitioned,
                              n_microbatches=lay.n_microbatches)
            self.step_fn = stepfn.build_train_step(self.cfg, acc, self.opt_cfg,
                                                   axis=self.axis, gate=self._gate)

    def _fresh_state(self) -> None:
        lay = self.layout
        self.storage = self.opt = None
        if lay.stages > 1:
            self.storage = stepfn.init_pipeline_storage(
                self.cfg, self.sup.seed, lay.pipe_spec(self.cfg), partitioned=lay.partitioned,
                device=self.device, axis=self.axis)
        else:
            self.storage = stepfn.init_storage(self.cfg, self.sup.seed,
                                               partitioned=lay.partitioned,
                                               device=self.device, axis=self.axis)
        self.opt = adam_init(self.storage, moment_dtype=self.opt_cfg.moment_dtype)
        self._trained = False

    def _bundle(self) -> dict:
        return {"params": self.storage, "mu": self.opt["mu"], "nu": self.opt["nu"],
                "opt_step": self.opt["step"]}

    def _save(self, *, step: int) -> None:
        meta = {"layout": self.layout.to_meta(), "arch": self.cfg.name,
                "moment_dtype": self.opt_cfg.moment_dtype}
        t0 = time.perf_counter()
        d = reshard.save_bundle(self.ckpt_root, self._bundle(), self.cfg, self.layout,
                                self.axis, step=step, meta=meta,
                                keep=self.sup.keep_checkpoints)
        if d is not None:
            self.io.append({"op": "save", "step": step, "bytes": _dir_bytes(d),
                            "seconds": time.perf_counter() - t0})

    def _restore(self) -> int | None:
        """Newest valid checkpoint -> this rank's tensors; its step, or
        None when nothing is restorable."""
        if self.storage is None:
            self._fresh_state()
        t0 = time.perf_counter()
        step = reshard.restore_bundle(
            self.ckpt_root, self._bundle(), self.cfg, self.layout, self.axis,
            moment_dtype=self.opt_cfg.moment_dtype, max_rollback=self.sup.max_rollback,
            on_reject=lambda d, e: self.sink.log(event="restore_rejected",
                                                 record={"dir": d, "error": e}))
        if step is not None:
            d = os.path.join(self.ckpt_root, store.step_dir_name(step))
            self.io.append({"op": "restore", "step": step, "bytes": _dir_bytes(d),
                            "seconds": time.perf_counter() - t0})
        return step

    def _restore_or_init(self) -> int:
        step = self._restore()
        if step is not None:
            return step
        if self._trained:
            self._fresh_state()
        return 0

    # -- recovery actions -------------------------------------------------
    def _handle_crash(self, at_step: int) -> int:
        self.restarts += 1
        if self.restarts > self.sup.max_restarts:
            raise SupervisorError(f"giving up after {self.sup.max_restarts} restarts "
                                  f"(crash before step {at_step})")
        if self.sup.backoff_s > 0:
            time.sleep(self.sup.backoff_s * (2 ** (self.restarts - 1)))
        t0 = time.perf_counter()
        with obs_trace.span("recovery", cat="resilience", step=at_step):
            resume = self._restore_or_init()
        rec_s = time.perf_counter() - t0
        lost = max(0, at_step - resume)
        self.mtree = self.reg.update(self.mtree, restarts=1, lost_steps=lost,
                                     recovery_time_s=rec_s)
        self.sink.log(event="restart",
                      record={"crash_step": at_step, "resume_step": resume,
                              "lost_steps": lost, "recovery_time_s": rec_s,
                              "restarts": self.restarts})
        return resume

    def _anomalous(self, loss: float, gnorm: float) -> str | None:
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            return f"non-finite step (loss={loss}, grad_norm={gnorm})"
        window = self._gnorms[-self.sup.anomaly_window:]
        if (self.sup.anomaly_factor > 0 and len(window) >= 3
                and gnorm > self.sup.anomaly_factor * statistics.median(window)):
            return (f"grad-norm spike {gnorm:.3g} > {self.sup.anomaly_factor:g} x running "
                    f"median {statistics.median(window):.3g}")
        return None

    def _gate(self, loss_t: torch.Tensor, gnorm_t: torch.Tensor) -> bool:
        """The pre-update gate of step ``self._i``: its loss and grad norm
        (poisoned by an injected fault of this step), judged before any
        state is written.  On a refusal it takes the state's digest."""
        loss, gnorm = float(loss_t), float(gnorm_t)
        for f in tuple(self.faults.pending_at(self._i)) if self.faults else ():
            if f.kind == "nan_grad":
                self.faults.fire(f)
                loss, gnorm = float("nan"), float("inf")
            elif f.kind == "grad_spike":
                self.faults.fire(f)
                gnorm *= f.scale
        self._seen = (loss, gnorm)
        self._why = self._anomalous(loss, gnorm)
        if self._why is not None:
            self._before = state_digest(self._bundle())
        return self._why is None

    def _barrier(self) -> None:
        if self.axis is not LOCAL and tdist.is_initialized():
            tdist.barrier(group=self.axis.world)

    def _shrink(self, at_step: int) -> bool:
        """The failure-shrink before step ``at_step``: refuse it, in the JAX
        package's order and before any tensor moves, or drain the last data
        row's chunks to the survivors and rebuild the step on their groups.
        Returns False on the ranks that leave."""
        old = self.layout
        if old.data <= 1:
            raise SupervisorError(f"cannot shrink below one data replica (step {at_step})")
        new = dataclasses.replace(old, data=old.data - 1)
        plan = self.plan_execution
        if plan is not None:
            # the plan must still hold on the surviving grid: refuse before
            # any tensor moves if it does not
            try:
                plan = planlib.shrink_execution(plan, data=new.data)
            except ValueError as e:
                raise SupervisorError(f"failure-shrink to data={new.data} rejected by the "
                                      f"plan: {e}") from e
        rows = self.data_cfg.global_batch // self.data_cfg.n_microbatches
        if rows % new.data:
            raise SupervisorError(f"failure-shrink to data={new.data}: a micro-batch of "
                                  f"{rows} rows does not split over the survivors")
        old_axis = self.axis
        t0 = time.perf_counter()
        with obs_trace.span("shrink", cat="resilience", step=at_step):
            axis = dist.make_axis(new.data, new.model, new.stages,
                                  ranks=reshard.survivors(old_axis, new.data))
            moved = reshard.drain_bundle(self._bundle(), self.cfg, old, new, old_axis,
                                         keep=axis is not None)
            if axis is None:
                self.storage = self.opt = None
                return False
            self.axis, self.layout, self.plan_execution = axis, new, plan
            self._build()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        rec_s = time.perf_counter() - t0
        self.mtree = self.reg.update(self.mtree, shrinks=1, recovery_time_s=rec_s)
        self.sink.log(event="shrink",
                      record={"step": at_step, "data_from": old.data, "data_to": new.data,
                              "recovery_time_s": rec_s, "bytes_drained": moved})
        return True

    # -- the loop ---------------------------------------------------------
    def run(self, steps: int) -> dict:
        """Supervised training to ``steps`` total completed steps.  Returns
        a result dict (history, restart, shrink and skip counters, the final
        layout) and leaves the final state on ``self.storage`` / ``self.opt``.
        A rank that leaves in a failure-shrink returns there, its result's
        ``left`` the step before which it left.  The run's spans, and the
        train steps' own, go to ``tracer``."""
        with obs_trace.active(self.tracer):
            return self._run(steps)

    def _run(self, steps: int) -> dict:
        sup = self.sup
        with obs_trace.span("build_step"):
            self._build()
        i = self._restore_or_init()
        if i:
            self.sink.log(event="resume", record={"resume_step": i})
        while i < steps:
            try:
                for f in tuple(self.faults.pending_at(i)) if self.faults else ():
                    if f.kind == "crash":
                        self.faults.fire(f)
                        raise flt.InjectedCrash(i)
                    if f.kind == "lose_replica":
                        self.faults.fire(f)
                        if not self._shrink(i):
                            return self._result(steps, left=i)
                batch = batch_for(self.cfg, self.data_cfg, i, self.axis)
                self._i = i
                t0 = time.perf_counter()
                self.storage, self.opt, m = self.step_fn(self.storage, self.opt, batch)
                lr = float(m["lr"])                 # device sync: ends the step
                dt = time.perf_counter() - t0
                loss, gnorm = self._seen
                if m.get("skipped"):
                    after = state_digest(self._bundle())
                    self.skipped.append({"step": i, "digest_before": self._before,
                                         "digest_after": after})
                    if after != self._before:
                        raise SupervisorError(f"step {i} was skipped but changed the state")
                    self.mtree = self.reg.update(self.mtree, skipped_steps=1)
                    self.sink.log(event="anomaly",
                                  record={"step": i, "loss": loss, "grad_norm": gnorm,
                                          "reason": self._why})
                    i += 1
                    continue
                self._trained = True
                self._gnorms.append(gnorm)
                rec = {"step": i, "loss": loss, "grad_norm": gnorm, "lr": lr,
                       "step_time_s": dt}
                self.history.append(rec)
                self.sink.log(rec)
                if (i + 1) % sup.checkpoint_every == 0:
                    self._save(step=i + 1)
                for f in tuple(self.faults.pending_at(i)) if self.faults else ():
                    if f.kind == "corrupt_checkpoint":
                        self.faults.fire(f)
                        ckpts = store.checkpoint_steps(self.ckpt_root)
                        if self.rank0 and ckpts:
                            path = flt.corrupt_checkpoint_file(
                                ckpts[-1][1], file_index=f.file_index,
                                byte_offset=f.byte_offset)
                            self.sink.log(event="injected_corruption",
                                          record={"step": i, "file": path})
                        self._barrier()
                i += 1
            except flt.InjectedCrash as e:
                i = self._handle_crash(e.step)
        return self._result(steps)

    def _result(self, steps: int, left: int | None = None) -> dict:
        """The run's result; ``left``: the step before which this rank left
        the grid in a failure-shrink (its state is gone)."""
        host = self.reg.to_host(self.mtree)
        result = {
            "steps": steps,
            "history": self.history,
            "final_layout": self.layout.to_meta(),
            "restarts": int(host["restarts"]),
            "lost_steps": int(host["lost_steps"]),
            "skipped_steps": int(host["skipped_steps"]),
            "shrinks": int(host["shrinks"]),
            "recovery_time_s": host["recovery_time_s"],
        }
        if self.history:
            result["first_loss"] = self.history[0]["loss"]
            result["last_loss"] = self.history[-1]["loss"]
        if left is not None:
            result["left"] = left
        return result

    def history_by_step(self) -> dict[int, dict]:
        """Last record per step index (replayed steps overwrite)."""
        out: dict[int, dict] = {}
        for rec in self.history:
            out[rec["step"]] = rec
        return out
