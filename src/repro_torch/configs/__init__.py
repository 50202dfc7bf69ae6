"""Architecture registry: ``--arch <id>`` resolution (the token-input
families the port runs so far: dense and mixture-of-experts attention stacks,
the attention-free RWKV-6 and the Mamba-2 hybrid; the multimodal input modes
come later).  ``paper-*`` configs resolve
but are kept out of ``list_archs()``, as in the JAX registry."""
from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

ARCHS = {
    "dbrx-132b": "dbrx_132b",
    "yi-6b": "yi_6b",
    "zamba2-7b": "zamba2_7b",
    "granite-20b": "granite_20b",
    "gemma-2b": "gemma_2b",
    "rwkv6-3b": "rwkv6_3b",
    "gemma2-9b": "gemma2_9b",
    "arctic-480b": "arctic_480b",
    "paper-x32": "paper_x",
}


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG


def list_archs() -> list[str]:
    return [a for a in ARCHS if not a.startswith("paper-")]
