"""Deterministic fault injection: fault plans as data (a copy of
``repro/resilience/faults.py``; the JSON is the same).

A fault plan is a JSON document listing faults keyed by the *global step*
at which they fire — the harness is deterministic by construction (no
clocks, no randomness), so a recovery trajectory is exactly reproducible
and CI can assert parity against an unfaulted run.

    {"faults": [
        {"kind": "crash", "step": 5},
        {"kind": "nan_grad", "step": 3},
        {"kind": "grad_spike", "step": 4, "scale": 1e4},
        {"kind": "corrupt_checkpoint", "step": 6, "file_index": 0,
         "byte_offset": 7},
        {"kind": "lose_replica", "step": 8}
    ]}

Semantics (enforced by repro_torch.resilience.supervisor.Supervisor):

  crash               the process dies *before* executing this step
                      (InjectedCrash) — the supervisor restarts from the
                      latest valid checkpoint; steps since it are lost.
  nan_grad            this step's gradient goes non-finite: the reported
                      loss/grad-norm are poisoned to NaN/inf and the
                      supervisor's anomaly gate must discard the update.
  grad_spike          this step's grad-norm is scaled by ``scale`` — the
                      running-threshold spike gate must reject it.
  corrupt_checkpoint  after this step's checkpoint save, one byte of one
                      checkpoint file is flipped (deterministic pick) —
                      the checksum walk must fall back to an older step.
  lose_replica        one data-axis replica disappears before this step.
                      The JAX package's supervisor shrinks its mesh in
                      memory; the port's refuses this fault (failure-shrink
                      is not ported: each replica is a process that owns
                      its ZeRO chunks, so losing one loses them).

Each fault fires exactly once (the plan tracks consumption), so a replay
after restart does not re-fire the crash that caused it.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator

KINDS = ("crash", "nan_grad", "grad_spike", "corrupt_checkpoint",
         "lose_replica")


class FaultPlanError(ValueError):
    """A fault plan fails validation (unknown kind, bad step, ...)."""


class InjectedCrash(RuntimeError):
    """The simulated process death of a ``crash`` fault."""

    def __init__(self, step: int):
        super().__init__(f"injected crash before step {step}")
        self.step = step


@dataclasses.dataclass
class Fault:
    kind: str
    step: int
    scale: float = 1e4          # grad_spike: factor applied to the grad norm
    file_index: int = 0         # corrupt_checkpoint: sorted-file index
    byte_offset: int = 0        # corrupt_checkpoint: offset of flipped byte
    fired: bool = False         # consumption marker (one-shot)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise FaultPlanError(
                f"unknown fault kind {self.kind!r}; known kinds: {KINDS}")
        if self.step < 0:
            raise FaultPlanError(f"fault step must be >= 0, got {self.step}")

    def to_json(self) -> dict:
        d = {"kind": self.kind, "step": self.step}
        if self.kind == "grad_spike":
            d["scale"] = self.scale
        if self.kind == "corrupt_checkpoint":
            d.update(file_index=self.file_index, byte_offset=self.byte_offset)
        return d


@dataclasses.dataclass
class FaultPlan:
    faults: list[Fault] = dataclasses.field(default_factory=list)

    @classmethod
    def from_json(cls, doc: dict) -> "FaultPlan":
        if not isinstance(doc, dict) or "faults" not in doc:
            raise FaultPlanError(
                "fault plan must be an object with a 'faults' list, got "
                f"{type(doc).__name__}")
        out = []
        for i, f in enumerate(doc["faults"]):
            if not isinstance(f, dict) or "kind" not in f or "step" not in f:
                raise FaultPlanError(
                    f"fault #{i} must be an object with 'kind' and 'step': "
                    f"{f!r}")
            known = {k.name for k in dataclasses.fields(Fault)} - {"fired"}
            extra = set(f) - known
            if extra:
                raise FaultPlanError(
                    f"fault #{i} has unknown keys {sorted(extra)}; "
                    f"allowed: {sorted(known)}")
            out.append(Fault(**f))
        return cls(out)

    def to_json(self) -> dict:
        return {"faults": [f.to_json() for f in self.faults]}

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(json.load(f))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)

    def pending_at(self, step: int) -> Iterator[Fault]:
        """Unfired faults scheduled at ``step`` (consume with ``fire``)."""
        for f in self.faults:
            if f.step == step and not f.fired:
                yield f

    def fire(self, fault: Fault) -> Fault:
        fault.fired = True
        return fault

    @property
    def unfired(self) -> list[Fault]:
        return [f for f in self.faults if not f.fired]


# ---------------------------------------------------------------------------
# The corruption injector (also used directly by tests)
# ---------------------------------------------------------------------------
def corrupt_checkpoint_file(ckpt_dir: str, *, file_index: int = 0,
                            byte_offset: int = 0) -> str:
    """Flip one byte of one ``.npy`` file in ``ckpt_dir`` (deterministic:
    sorted file order, offset clamped into the file).  Returns the path of
    the corrupted file.  The manifest is left intact — exactly the torn /
    bit-rotted artifact the checksum walk must reject."""
    files = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".npy"))
    if not files:
        raise FaultPlanError(f"no .npy files to corrupt under {ckpt_dir}")
    target = os.path.join(ckpt_dir, files[file_index % len(files)])
    size = os.path.getsize(target)
    off = min(byte_offset, size - 1)
    with open(target, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))
    return target
