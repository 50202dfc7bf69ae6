"""One rank of a data x model grid of processes on gloo serving a model, for
``tests/test_torch_serve_dist.py``.  It imports torch and the port only.

    PYTHONPATH=src python tests/torch_serve_ranks.py JOB RANK

``JOB`` is ``torch_dist_ranks``' pickle; each case brings its config, the
JAX parameter tree as numpy and its tokens.  A runner takes this rank's
block of the weights (``convert.params_from_numpy`` with its axis) and returns the
logits of every call (the vocabulary whole) and the collective counts of
every call.  The test runs the same runners with ``dist.LOCAL`` in its own
process for the port's one-rank run.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.core import stepfn
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.serving import steps
from repro_torch.serving.cache import PagedCacheConfig, init_paged_cache
from torch_dist_ranks import _counts, main


def _record(out: list, counts: list, axis, call):
    """Run ``call()`` with the counters at zero; keep its logits and counts."""
    axis.reset_counts()
    logits, cache = call()
    out.append(logits.numpy().copy())
    counts.append(_counts(axis))
    return cache


def run_dense(job, case, axis):
    """The dense-cache steps: a prefill of the first ``prefill`` tokens when
    given (or this rank's block of ``cache``, a whole cache filled with the
    first ``from_prefill`` tokens, by ``stepfn.shard_cache``), then one
    decode step for each later token (the case's tokens, not the argmax: the
    two runs see the same inputs).  This rank's rows (every row under
    ``seq_shard``)."""
    cfg = ModelConfig(**case["cfg"])
    seq = case.get("seq_shard", False)
    params = params_from_numpy(cfg, case["params"], axis=axis)
    toks = torch.from_numpy(case["tokens"])
    if not seq:
        toks = toks.chunk(axis.ndata)[axis.data_index]
    if "cache" in case:
        # a filled cache of every row and position: this rank's shard of it
        whole = {k: v if k == "pos" else torch.tensor(v) for k, v in case["cache"].items()}
        cache = stepfn.shard_cache(cfg, whole, axis, seq_shard=seq)
    else:
        cache = T.init_cache(cfg, toks.shape[0], case["max_seq"],
                             stepfn.serve_axis(cfg, axis, seq_shard=seq))
    out, counts = [], []
    n_pre = case.get("prefill", 0)
    if n_pre:
        prefill = stepfn.build_prefill_step(cfg, axis=axis)
        cache = _record(out, counts, axis,
                        lambda: prefill(params, cache, {"tokens": toks[:, :n_pre]}))
    serve = stepfn.build_serve_step(cfg, axis=axis, seq_shard=seq)
    for t in range(n_pre or case.get("from_prefill", 0), toks.shape[1]):
        cache = _record(out, counts, axis, lambda: serve(params, cache, toks[:, t]))
    return {"logits": np.stack(out, 1), "counts": counts, "pos": cache["pos"]}


def run_paged(job, case, axis):
    """The paged steps, every slot on every rank: a ragged prefill of
    ``prompt`` (its true lengths ``lens``) when given, then one decode step
    for each column of ``tokens`` at lengths ``lens + i`` (``lens`` 0 without
    a prefill)."""
    cfg = ModelConfig(**case["cfg"])
    params = params_from_numpy(cfg, case["params"], axis=axis)
    pcfg = PagedCacheConfig(**case["pcfg"])
    cache = init_paged_cache(cfg, pcfg, "cpu", axis)
    tables = torch.from_numpy(case["tables"])
    toks = torch.from_numpy(case["tokens"])
    lens = torch.zeros(toks.shape[0], dtype=torch.int32)
    out, counts = [], []
    if "prompt" in case:
        lens = torch.from_numpy(case["lens"])
        prefill = steps.build_paged_prefill_fn(cfg, stepfn.serve_axis(cfg, axis))
        batch = {"tokens": torch.from_numpy(case["prompt"]), "lens": lens}
        cache = _record(out, counts, axis, lambda: prefill(params, cache, batch, tables))
    serve = steps.build_paged_serve_step(cfg, axis=axis)
    for i in range(toks.shape[1]):
        cache = _record(out, counts, axis,
                        lambda: serve(params, cache, tables, lens + i, toks[:, i]))
    return {"logits": np.stack(out, 1), "counts": counts,
            "pool_heads": cache["k"].shape[2]}


RUNNERS = {"dense": run_dense, "paged": run_paged}

if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), RUNNERS)
