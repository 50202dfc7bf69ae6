"""Paged KV cache: fixed-size blocks, per-request block tables, free list
(counterpart of ``repro/serving/cache.py``).

Pool layout, one pool per K and V:

    [n_slots, num_blocks + 1, Hkv, block_size, head_dim]

The ``+ 1`` is the *trash block*: writes for padded prompt chunks and idle
engine slots go to pool index ``num_blocks``; no live position reads it.  The
allocator hands out ids ``[0, num_blocks)`` only.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.dist import LOCAL, AxisCtx
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    """Shape of the paged pool."""

    num_blocks: int              # allocatable blocks (pool holds one extra)
    block_size: int              # tokens per block
    max_blocks_per_seq: int      # block-table width (max context / block_size)

    @property
    def trash_block(self) -> int:
        """Pool index absorbing masked writes; never allocated, never read."""
        return self.num_blocks

    @property
    def max_context(self) -> int:
        return self.max_blocks_per_seq * self.block_size

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks covering ``n_tokens`` written positions."""
        return -(-n_tokens // self.block_size)


def init_paged_cache(cfg: ModelConfig, pcfg: PagedCacheConfig, device,
                     axis: AxisCtx = LOCAL) -> dict:
    """Zeroed K and V pools for the attention stack on ``device``: this
    rank's KV heads of the model group (``local_kv_heads``), every block (the
    pool is the same on every data rank: block tables name blocks, not
    rows)."""
    if cfg.block_kind != "attn":
        raise ValueError(f"paged serving needs block_kind='attn' (got {cfg.block_kind!r})")
    shape = (cfg.num_attn_slots(), pcfg.num_blocks + 1, local_kv_heads(cfg, axis.tp),
             pcfg.block_size, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


def local_kv_heads(cfg: ModelConfig, tp: int) -> int:
    """KV heads cached per model shard at tensor-parallel width ``tp`` (1
    when the KV heads are replicated and each shard caches its own GQA
    group)."""
    if tp > 1 and cfg.num_kv_heads % tp == 0:
        return cfg.num_kv_heads // tp
    return cfg.num_kv_heads if tp == 1 else 1


def kv_bytes_per_token(cfg: ModelConfig, tp: int = 1) -> int:
    """K+V bytes cached per token on one model shard (the planner's serving
    costs read it at every ``tp``)."""
    itemsize = torch.empty((), dtype=cfg.torch_dtype).element_size()
    return 2 * cfg.num_attn_slots() * local_kv_heads(cfg, tp) * cfg.head_dim * itemsize


class BlockAllocator:
    """Free-list allocator over pool ids ``[0, num_blocks)``.

    ``alloc`` is all-or-nothing (None when it cannot be satisfied — the
    scheduler then preempts or defers); ``free`` rejects double frees and ids
    it never issued.
    """

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, -1, -1))   # LIFO: reuse warm ids
        self._used: set[int] = set()

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        return len(self._used)

    def alloc(self, n: int) -> list[int] | None:
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._used.update(out)
        return out

    def free(self, ids) -> None:
        ids = list(ids)
        for b in ids:
            if b not in self._used:
                raise ValueError(f"free of unallocated block {b}")
        for b in ids:
            self._used.remove(b)
            self._free.append(b)
