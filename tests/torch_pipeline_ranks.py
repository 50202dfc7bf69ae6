"""One rank of a stage x data x model grid of processes on gloo, for
``tests/test_torch_pipeline.py``.  It imports torch and the port only.

    PYTHONPATH=src python tests/torch_pipeline_ranks.py JOB RANK

``JOB`` is a pickle as ``tests/torch_dist_ranks.py`` reads it, with a
``(stage, data, model)`` mesh; the cases are pipeline gradient passes
(``pgrads``), pipelined train steps (``ptrain``) and a pipelined run saved
and resumed from a checkpoint (``pckpt``).
"""
from __future__ import annotations

import sys

import torch

from repro_torch.convert import pipeline_storage_from_numpy
from repro_torch.core import pipeline as pp
from repro_torch import tree
from repro_torch.core import stepfn
from repro_torch.core.schedules import PipeSpec
from repro_torch.data.synthetic import DataConfig, batch_for, local_rows
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adam import AdamConfig, adam_init
from repro_torch.resilience import reshard
from torch_dist_ranks import _counts, _numpy, main


def _spec(cfg: ModelConfig, axis, case: dict, n_mb: int) -> PipeSpec:
    return PipeSpec(n_stages=axis.nstage, layers_per_stage=cfg.num_layers // axis.nstage,
                    n_microbatches=n_mb, schedule=case["schedule"],
                    split_backward=case.get("split", False))


def run_pgrads(job, case, axis):
    """One pipelined gradient pass: this rank's gradients in its storage
    layout, the loss and the step's collective counts.  A case may bring its
    own config, weights and batch."""
    cfg = ModelConfig(**case.get("cfg", job["cfg"]))
    batch = local_rows({k: torch.from_numpy(v) for k, v in case.get("batch", job["batch"]).items()},
                       axis)
    spec = _spec(cfg, axis, case, batch["labels"].shape[0])
    storage = pipeline_storage_from_numpy(cfg, case.get("params", job["params"]), spec,
                                          partitioned=case["part"], axis=axis)
    grad_fn = pp.make_pipeline_grad_fn(cfg, spec, stepfn.full_template(cfg),
                                       partitioned=case["part"], axis=axis)
    axis.reset_counts()
    grads, m = grad_fn(storage, batch)
    return {"grads": _numpy(grads), "loss": m["loss"].item(), "ntok": m["ntok"].item(),
            "counts": _counts(axis)}


def run_ptrain(job, case, axis):
    """``case["steps"]`` pipelined train steps from the job's weights (or
    the case's, of its config) on its input mode's batches; the parameters
    ``gather_pipeline_params`` gives before the first, and this rank's
    storage after the last."""
    cfg = ModelConfig(**case.get("cfg", job["cfg"]))
    data = DataConfig(**case["data"])
    spec = _spec(cfg, axis, case, data.n_microbatches)
    storage = pipeline_storage_from_numpy(cfg, case.get("params", job["params"]), spec,
                                          partitioned=True, axis=axis)
    params = stepfn.gather_pipeline_params(cfg, storage, spec, partitioned=True, axis=axis)
    step = stepfn.build_pipeline_train_step(cfg, spec, AdamConfig(**case["opt"]),
                                            partitioned=True, axis=axis)
    opt = adam_init(storage)
    recs = []
    for i in range(case["steps"]):
        axis.reset_counts()
        storage, opt, m = step(storage, opt, batch_for(cfg, data, i, axis))
        recs.append({k: m[k].item() for k in ("loss", "grad_norm", "lr")}
                    | {"counts": _counts(axis)})
    return {"records": recs,
            "params": dict({k: _numpy(v) for k, v in params.items() if k != "layers"},
                           layers=[_numpy(lp) for lp in params["layers"]]),
            "storage": _numpy(storage)}


def run_pckpt(job, case, axis):
    """``case["steps"]`` partitioned pipelined steps of the case's config and
    weights, saving a params + moments bundle after step ``case["save"]``
    into ``case["dir"]``; then the state zeroed, that bundle restored and
    the steps after it run again.  Returns both runs' losses and final
    storage."""
    cfg = ModelConfig(**case["cfg"])
    data = DataConfig(**case["data"])
    spec = _spec(cfg, axis, case, data.n_microbatches)
    layout = reshard.layout_of(axis, partitioned=True, schedule=case["schedule"],
                               n_microbatches=data.n_microbatches)
    step = stepfn.build_pipeline_train_step(cfg, spec, AdamConfig(**case["opt"]),
                                            partitioned=True, axis=axis)

    def bundle(storage, opt):
        return {"params": storage, "mu": opt["mu"], "nu": opt["nu"], "opt_step": opt["step"]}

    storage = pipeline_storage_from_numpy(cfg, case["params"], spec, partitioned=True, axis=axis)
    opt = adam_init(storage)
    losses = []
    for i in range(case["steps"]):
        storage, opt, m = step(storage, opt, batch_for(cfg, data, i, axis))
        losses.append(m["loss"].item())
        if i + 1 == case["save"]:
            reshard.save_bundle(case["dir"], bundle(storage, opt), cfg, layout, axis,
                                step=i + 1, meta={"layout": layout.to_meta()})
    ref = _numpy(storage)
    tree.tree_map(lambda t: t.zero_(), bundle(storage, opt))
    start = reshard.restore_bundle(case["dir"], bundle(storage, opt), cfg, layout, axis)
    resumed = []
    for i in range(start, case["steps"]):
        storage, opt, m = step(storage, opt, batch_for(cfg, data, i, axis))
        resumed.append(m["loss"].item())
    return {"losses": losses, "start": start, "resumed": resumed, "storage": ref,
            "resumed_storage": _numpy(storage)}


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), {"pgrads": run_pgrads, "ptrain": run_ptrain,
                                         "pckpt": run_pckpt})
