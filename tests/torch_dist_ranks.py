"""One rank of a data x model grid of processes on gloo, for
``tests/test_torch_dist.py``.  It imports torch and the port only.

    PYTHONPATH=src python tests/torch_dist_ranks.py JOB RANK

``JOB`` is a pickle the test wrote: the mesh, a file-store path, the model
config, the JAX parameter tree as numpy, a batch, and a list of cases.  The
rank runs every case in order, printing a line as each ends, and pickles its
results to ``JOB.RANK``.
``tests/torch_pipeline_ranks.py`` runs the pipeline's cases through
``main`` with its own runners.
"""
from __future__ import annotations

import pickle
import sys

import torch
import torch.distributed as tdist

from repro_torch import tree
from repro_torch.convert import storage_from_numpy
from repro_torch.core import dist, stepfn
from repro_torch.core.accumulation import AccumConfig, make_grad_fn
from repro_torch.data.synthetic import DataConfig, batch_for, local_rows
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adam import AdamConfig, adam_init


def _numpy(t: dict) -> dict:
    return tree.tree_map(lambda x: x.detach().numpy().copy(), t)


def _counts(axis: dist.AxisCtx) -> dict:
    return {k: tuple(v) for k, v in axis.counts.items()}


def run_grads(job, case, axis):
    """One ``grad_fn`` call: this rank's gradients in its storage layout.  A
    case may bring its own config, weights and batch."""
    cfg = ModelConfig(**case.get("cfg", job["cfg"]))
    part, span = case["part"], case.get("span", False)
    storage = storage_from_numpy(cfg, case.get("params", job["params"]), partitioned=part,
                                 axis=axis, span_pods=span)
    batch = local_rows({k: torch.from_numpy(v) for k, v in case.get("batch", job["batch"]).items()},
                       axis)
    acc = AccumConfig(method=case["method"], partitioned=part,
                      n_microbatches=batch["tokens"].shape[0],
                      reduce_dtype=case.get("reduce_dtype", "float32"), span_pods=span)
    grad_fn = make_grad_fn(cfg, acc, stepfn.full_template(cfg), axis=axis)
    axis.reset_counts()
    grads, m = grad_fn(storage, batch)
    return {"grads": _numpy(grads), "loss": m["loss"].item(), "ntok": m["ntok"].item(),
            "counts": _counts(axis)}


def run_train(job, case, axis):
    """``case["steps"]`` steps of the classic or the fused train step, on
    the batches of the config's input mode.  A case may bring its own config
    and weights, and its method, layout and ``span`` (layered, partitioned
    over the data group when it does not)."""
    cfg = ModelConfig(**case.get("cfg", job["cfg"]))
    data = DataConfig(**case["data"])
    part, span = case.get("part", True), case.get("span", False)
    acc = AccumConfig(case.get("method", "layered"), part, data.n_microbatches,
                      span_pods=span)
    build = stepfn.build_fused_train_step if case["fused"] else stepfn.build_train_step
    step = build(cfg, acc, AdamConfig(**case["opt"]), axis=axis)
    storage = storage_from_numpy(cfg, case.get("params", job["params"]), partitioned=part,
                                 axis=axis, span_pods=span)
    opt = adam_init(storage)
    recs = []
    for i in range(case["steps"]):
        axis.reset_counts()
        storage, opt, m = step(storage, opt, batch_for(cfg, data, i, axis))
        recs.append({k: m[k].item() for k in ("loss", "grad_norm", "lr")}
                    | {"counts": _counts(axis)})
    return {"records": recs, "storage": _numpy(storage)}


def run_layout(job, case, axis):
    """This rank's storage made two ways, from the numpy tree
    (``host_partition_leaf``) and from torch tensors (``storage_from_params``,
    the path ``init_storage`` takes), in both layouts; and ``gather_params``
    of the partitioned one: this rank's model shards."""
    cfg = ModelConfig(**job["cfg"])
    full = {k: tree.tree_map(lambda a: torch.tensor(a), v)
            for k, v in job["params"].items() if k != "shared"}
    out = {}
    for part in (False, True):
        a = storage_from_numpy(cfg, job["params"], partitioned=part, axis=axis)
        b = stepfn.storage_from_params(cfg, full, partitioned=part, axis=axis)
        out[part] = (_numpy(a), _numpy(b))
    storage = storage_from_numpy(cfg, job["params"], partitioned=True, axis=axis)
    params = stepfn.gather_params(cfg, storage, partitioned=True, axis=axis)
    return {"storage": out,
            "params": dict({k: _numpy(v) for k, v in params.items() if k != "layers"},
                           layers=[_numpy(lp) for lp in params["layers"]])}


RUNNERS = {"grads": run_grads, "train": run_train, "layout": run_layout}


def main(job_path: str, rank: int, runners: dict = RUNNERS) -> None:
    """``JOB``'s mesh is ``(data, model)`` or ``(stage, data, model)``, or
    ``(pod, data, model)`` when the job says ``pods``."""
    torch.set_num_threads(1)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    nlead, ndata, tp = (1, *job["mesh"]) if len(job["mesh"]) == 2 else job["mesh"]
    tdist.init_process_group("gloo", init_method=f"file://{job['store']}", rank=rank,
                             world_size=nlead * ndata * tp)
    try:
        if job.get("pods"):
            axis = dist.make_axis(ndata, tp, npod=nlead)
        else:
            axis = dist.make_axis(ndata, tp, nlead)
        out = []
        for i, c in enumerate(job["cases"]):
            out.append(runners[c["kind"]](job, c, dist.LOCAL if c.get("local") else axis))
            # the spawn's progress: its wait fails only when no rank moves on
            print(f"rank {rank}: case {i} ({c['kind']}) done", flush=True)
        out = {"rank": rank, "data_index": axis.data_index,
               "model_index": axis.model_index, "stage_index": axis.stage_index,
               "pod_index": axis.pod_index,
               "results": out}
    finally:
        tdist.destroy_process_group()
    with open(f"{job_path}.{rank}", "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
