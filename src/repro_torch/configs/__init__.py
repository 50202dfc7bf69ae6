"""Architecture registry: ``--arch <id>`` resolution (the dense
attention-stack token models the port runs so far; the other families come
later).  ``paper-*`` configs resolve but are kept out of ``list_archs()``,
as in the JAX registry."""
from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

ARCHS = {
    "yi-6b": "yi_6b",
    "granite-20b": "granite_20b",
    "gemma-2b": "gemma_2b",
    "gemma2-9b": "gemma2_9b",
    "paper-x32": "paper_x",
}


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG


def list_archs() -> list[str]:
    return [a for a in ARCHS if not a.startswith("paper-")]
