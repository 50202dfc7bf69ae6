"""A cell's files, found by name: ``workloads/<cell>.json`` names its
configuration (``configs/<config>.json``) and its traffic mix
(``traffic/<traffic>.json``), and its ``kind`` the driver that runs it
(``drivers/<kind>.py``); a configuration's ``family`` names its layout
(``families/<family>.py``).  Adding a cell, a configuration, a mix, a
driver or a family is adding files."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from bench import families

BENCH = Path(__file__).resolve().parents[1]


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict

    @property
    def kind(self) -> str:
        return self.workload["kind"]


def _load(sub: str, name: str) -> dict:
    path = BENCH / sub / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {sub[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_cell(name: str) -> Cell:
    w = _load("workloads", name)
    return Cell(name, w, _load("configs", w["config"]), _load("traffic", w["traffic"]))


def model_config(conf: dict):
    """The port's ``ModelConfig`` of a configuration file, by its family."""
    from repro_torch.models.common import ModelConfig
    return ModelConfig(**families.of(conf).port_fields(conf))


def benchmark_json() -> dict | None:
    path = BENCH.parent / "BENCHMARK.json"
    return json.loads(path.read_text()) if path.is_file() else None
