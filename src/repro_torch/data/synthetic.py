"""Deterministic synthetic LM data (counterpart of
``repro/data/synthetic.py``): an order-1 latent Markov token stream with
per-sequence drift plus noise, so training shows a real loss decrease while
staying offline and seeded.  The stream is numpy's, so a batch is bit-equal
to the JAX package's for the same config and step.  The two modality
frontends are stubs, as in the JAX package: musicgen's precomputed frame
embeddings (``make_audio_batch``) and llava's projected patch embeddings
prepended to the text tokens (``make_vlm_batch``), both fp32
``[M, B/M, S|P, d_model]`` from numpy's normal stream.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.dist import LOCAL, AxisCtx
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_microbatches: int = 1
    seed: int = 0
    noise: float = 0.1          # fraction of uniformly resampled tokens


def _sequence(rng: np.random.Generator, cfg: DataConfig) -> np.ndarray:
    """One learnable sequence: x_{t+1} = (a*x_t + b) mod V with noise."""
    v = cfg.vocab_size
    a = int(rng.integers(2, 8))
    b = int(rng.integers(0, v))
    x = np.empty(cfg.seq_len + 1, np.int64)
    x[0] = rng.integers(0, v)
    for t in range(cfg.seq_len):
        if rng.random() < cfg.noise:
            x[t + 1] = rng.integers(0, v)
        else:
            x[t + 1] = (a * x[t] + b) % v
    return x


def make_batch(cfg: DataConfig, step: int) -> dict:
    """Global micro-batched batch: int32 CPU tensors [M, B/M, S]."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    B, S, M = cfg.global_batch, cfg.seq_len, cfg.n_microbatches
    if B % M:
        raise ValueError(f"global batch {B} is not a multiple of {M} micro-batches")
    seqs = np.stack([_sequence(rng, cfg) for _ in range(B)])
    tokens = seqs[:, :-1].reshape(M, B // M, S).astype(np.int32)
    labels = seqs[:, 1:].reshape(M, B // M, S).astype(np.int32)
    return {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels),
            "mask": torch.ones(tokens.shape, dtype=torch.int32)}


def batches(cfg: DataConfig, n_steps: int, start: int = 0) -> Iterator[dict]:
    """The global batches of steps ``start .. start + n_steps - 1``."""
    for step in range(start, start + n_steps):
        yield make_batch(cfg, step)


def make_audio_batch(cfg: DataConfig, model: ModelConfig, step: int) -> dict:
    """MusicGen-style: precomputed EnCodec frame embeddings ``embeds``
    ``[M, B/M, S, d_model]`` fp32 and the codec labels of ``make_batch``."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, 1]))
    B, S, M = cfg.global_batch, cfg.seq_len, cfg.n_microbatches
    embeds = rng.standard_normal((M, B // M, S, model.d_model), np.float32)
    base = make_batch(cfg, step)
    return {"embeds": torch.from_numpy(embeds), "labels": base["labels"],
            "mask": base["mask"]}


def make_vlm_batch(cfg: DataConfig, model: ModelConfig, step: int) -> dict:
    """LLaVA-style: ``vision_embeds`` ``[M, B/M, P, d_model]`` fp32 (P =
    ``vision_prefix_len``) before ``seq_len - P`` text tokens; the labels and
    the mask are 0 over the vision prefix, so the loss covers the text."""
    P = model.vision_prefix_len
    S_text = cfg.seq_len - P
    if S_text <= 0:
        raise ValueError(f"seq_len {cfg.seq_len} leaves no text after the {P}-position "
                         f"vision prefix")
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, 2]))
    B, M = cfg.global_batch, cfg.n_microbatches
    base = make_batch(dataclasses.replace(cfg, seq_len=S_text), step)
    vis = rng.standard_normal((M, B // M, P, model.d_model), np.float32)
    pad = torch.zeros((M, B // M, P), dtype=torch.int32)
    return {"tokens": base["tokens"], "vision_embeds": torch.from_numpy(vis),
            "labels": torch.cat([pad, base["labels"]], dim=-1),
            "mask": torch.cat([pad, base["mask"]], dim=-1)}


def local_rows(batch: dict, axis: AxisCtx) -> dict:
    """This rank's rows of a micro-batched global batch: the micro-batch dim
    ``[M, B/M, ...]`` split over the (pod, data) ranks, pod major, as the
    JAX package's ``batch_specs`` shard it; every rank of a model group gets
    the same rows."""
    mb = batch["labels"].shape[1]
    if mb % axis.dp:
        raise ValueError(f"micro-batch of {mb} rows does not split over {axis.dp} "
                         f"data ranks")
    n, i = mb // axis.dp, axis.dp_index
    return {k: v[:, i * n:(i + 1) * n] for k, v in batch.items()}


def batch_for(model: ModelConfig, cfg: DataConfig, step: int,
              axis: AxisCtx = LOCAL) -> dict:
    """This rank's rows of the global batch of ``step``, in ``model``'s
    input mode."""
    if model.input_mode == "embeddings":
        batch = make_audio_batch(cfg, model, step)
    elif model.input_mode == "vlm":
        batch = make_vlm_batch(cfg, model, step)
    else:
        batch = make_batch(cfg, step)
    return local_rows(batch, axis)
