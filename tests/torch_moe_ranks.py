"""One rank of a data x model grid of processes on gloo, for
``tests/test_torch_moe.py``.  It imports torch and the port only.

    PYTHONPATH=src python tests/torch_moe_ranks.py JOB RANK

``JOB`` is a pickle as ``tests/torch_dist_ranks.py`` reads it, with an MoE
config; the cases are train steps with or without expert parallelism
(``mtrain``) and the all-to-all dispatch against the dense one (``a2a``).
"""
from __future__ import annotations

import sys

import torch

from repro_torch import tree
from repro_torch.convert import storage_from_numpy
from repro_torch.core import dist, partition as zp, stepfn
from repro_torch.core.accumulation import AccumConfig
from repro_torch.data.synthetic import DataConfig, local_rows, make_batch
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adam import AdamConfig, adam_init
from torch_dist_ranks import _counts, _numpy, main


def run_mtrain(job, case, axis):
    """``case["steps"]`` steps of the classic or the fused train step, the
    expert stacks resident when ``case["ep"]``; the records and this rank's
    final storage."""
    cfg = ModelConfig(**job["cfg"])
    data = DataConfig(**case["data"])
    acc = AccumConfig(case["method"], True, data.n_microbatches, expert_parallel=case["ep"])
    build = stepfn.build_fused_train_step if case["fused"] else stepfn.build_train_step
    step = build(cfg, acc, AdamConfig(**case["opt"]), axis=axis)
    storage = storage_from_numpy(cfg, job["params"], partitioned=True, axis=axis,
                                 expert_resident=case["ep"])
    opt = adam_init(storage)
    recs = []
    for i in range(case["steps"]):
        axis.reset_counts()
        storage, opt, m = step(storage, opt, local_rows(make_batch(data, i), axis))
        recs.append({k: m[k].item() for k in ("loss", "grad_norm", "lr", "aux")}
                    | {"counts": _counts(axis)})
    return {"records": recs, "storage": _numpy(storage)}


def run_a2a(job, case, axis):
    """Layer 0's MoE on this rank's rows, dispatched by all-to-all over the
    data group (the experts resident: expert dim over data, hidden over
    model), and by the dense dispatch on the whole layer without groups;
    the outputs and the input gradients of ``sum(y * r)``.  ``case["x"]``,
    ``case["r"]``: the global ``[B, S, D]`` input and cotangent."""
    cfg = ModelConfig(**job["cfg"])
    full = tree.tree_map(lambda a: torch.tensor(a[0]), job["params"]["layers"]["moe"])
    x = torch.from_numpy(case["x"])
    n = x.shape[0] // axis.ndata
    x = x[axis.data_index * n:(axis.data_index + 1) * n]
    r = torch.from_numpy(case["r"])[axis.data_index * n:(axis.data_index + 1) * n]

    def run(p, ax):
        xx = x.clone().requires_grad_()
        y, _ = moe.apply_moe(cfg, p, xx, ax, capacity_factor=case["cf"])
        (g,) = torch.autograd.grad((y * r).sum(), [xx])
        return y.detach().numpy(), g.numpy()

    def shard(path, t, spec):
        path = ("moe",) + path
        if zp.is_expert_path(path):
            return zp.resident_shard(t[None], zp.expert_resident_spec(path, axis.tp), axis)[0]
        return zp.model_shard(t, spec, axis.tp, axis.model_index)

    local = tree.tree_map_with_path(shard, full, T.layer_specs(cfg, axis.tp)["moe"])
    axis = dist.with_expert_group(axis)
    axis.reset_counts()
    y, g = run(local, axis)
    counts = _counts(axis)
    y_ref, g_ref = run(full, dist.LOCAL)
    return {"y": y, "g": g, "y_ref": y_ref, "g_ref": g_ref, "counts": counts}


RUNNERS = {"mtrain": run_mtrain, "a2a": run_a2a}


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), RUNNERS)
