"""Architecture registry: ``--arch <id>`` resolution for every entry point,
in the JAX registry's order (dense and mixture-of-experts attention stacks,
the attention-free RWKV-6, the Mamba-2 hybrid, and the two input modes beside
tokens: musicgen-large's frame embeddings and llava-next's vision prefix).
``paper-*`` configs resolve but are kept out of ``list_archs()``, as in the
JAX registry."""
from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

ARCHS = {
    "dbrx-132b": "dbrx_132b",
    "yi-6b": "yi_6b",
    "zamba2-7b": "zamba2_7b",
    "granite-20b": "granite_20b",
    "gemma-2b": "gemma_2b",
    "musicgen-large": "musicgen_large",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
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
