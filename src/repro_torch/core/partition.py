"""The ZeRO training-state layout (counterpart of ``repro/core/partition.py``).

Every parameter leaf is stored as flat fp32 chunks ``[L?, n_model, n_data,
chunk]``: stacked layer leaves keep their leading ``L`` dim, outer leaves
are ``[n_model, n_data, chunk]``.  The port runs in one process, so
``n_model = n_data = 1`` and a chunk holds the whole (model-local) leaf;
the layout is kept so that tensor parallelism and the ZeRO collectives can
come later without a new layout.  With one data shard, "gather" is a cast to
the compute dtype of a view of the chunk, and "scatter" is the same view of
the fp32 gradient chunk, which the accumulation adds each layer's gradient
into (``full_view``).

``host_partition_leaf`` / ``host_unpartition_leaf`` are the numpy forms for
any ``n_data`` and ``tp``, bit-compatible with the JAX package's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

N_MODEL = 1
N_DATA = 1


def chunk_size(local_numel: int, n_data: int) -> int:
    return math.ceil(local_numel / n_data)


def partition(leaf: torch.Tensor, *, stacked: bool) -> torch.Tensor:
    """A full leaf -> its fp32 chunk ``[L?, 1, 1, chunk]`` (a view when the
    leaf is already a contiguous fp32 tensor)."""
    x = leaf.float()
    lead = (x.shape[0],) if stacked else ()
    return x.reshape(*lead, N_MODEL, N_DATA, -1)


def full_view(chunk: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """A ``[1, 1, chunk]`` fp32 chunk (or one layer of a stacked leaf) -> a
    view of it in the leaf's full shape."""
    return chunk.reshape(-1)[:math.prod(shape)].view(shape)


def gather(chunk: torch.Tensor, shape: tuple[int, ...], dtype) -> torch.Tensor:
    """The compute copy of a leaf: cast to ``dtype`` (always a fresh tensor,
    so the optimizer's in-place update never aliases it)."""
    return full_view(chunk, shape).to(dtype, copy=True)


# ---------------------------------------------------------------------------
# Host-side layout conversion (numpy)
# ---------------------------------------------------------------------------
def host_partition_leaf(full: np.ndarray, tp: int, n_data: int, *, stacked: bool,
                        model_dim: int | None = None) -> np.ndarray:
    """Global full leaf -> ALL devices' fp32 chunks ``[L?, n_model, n_data,
    chunk]``.  ``model_dim`` is the dim sharded over the model axis (None:
    replicated).  Pure reshape/pad/moveaxis, so values move bit-identically."""
    x = np.asarray(full, dtype=np.float32)
    lead = (x.shape[0],) if stacked else ()
    if tp > 1 and model_dim is not None:
        if x.shape[model_dim] % tp:
            raise ValueError(f"tp={tp} does not divide dim {model_dim} of shape "
                             f"{x.shape}")
        x = x.reshape(*x.shape[:model_dim], tp, x.shape[model_dim] // tp,
                      *x.shape[model_dim + 1:])
        x = np.moveaxis(x, model_dim, len(lead))
        n_model = tp
    else:
        x = x.reshape(*lead, 1, *x.shape[len(lead):])
        n_model = 1
    flat = x.reshape(*lead, n_model, -1)
    c = chunk_size(flat.shape[-1], n_data)
    flat = np.pad(flat, [(0, 0)] * (flat.ndim - 1) + [(0, c * n_data - flat.shape[-1])])
    return flat.reshape(*lead, n_model, n_data, c)


def host_unpartition_leaf(chunks: np.ndarray, global_shape: tuple[int, ...], tp: int,
                          *, stacked: bool, model_dim: int | None = None) -> np.ndarray:
    """The exact inverse of ``host_partition_leaf`` (drops the chunk padding,
    keeps the chunks' dtype)."""
    x = np.asarray(chunks)
    lshape = list(global_shape)
    if tp > 1 and model_dim is not None:
        lshape[model_dim] //= tp
    lead = tuple(lshape[:1]) if stacked else ()
    body = tuple(lshape[1:]) if stacked else tuple(lshape)
    n_model = x.shape[1] if stacked else x.shape[0]
    flat = x.reshape(*lead, n_model, -1)[..., :math.prod(body)]
    loc = flat.reshape(*lead, n_model, *body)
    if n_model > 1 and model_dim is not None:
        return np.moveaxis(loc, len(lead), model_dim).reshape(global_shape)
    return loc.reshape(global_shape)
