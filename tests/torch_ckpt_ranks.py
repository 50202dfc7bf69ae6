"""One rank of a (stage x) data x model grid of processes on gloo, for
``tests/test_torch_checkpoint.py``.  It imports torch and the port only.

    PYTHONPATH=src python tests/torch_ckpt_ranks.py JOB RANK

``JOB`` is a pickle as ``tests/torch_dist_ranks.py`` reads it.  A ``bundle``
case builds this rank's storage from the job's JAX weights, makes moments
from it, writes the global checkpoint (``reshard.save_bundle``: rank 0
writes, the blocks gathered leaf by leaf), restores it into zeroed tensors
(``reshard.restore_bundle``) and reports whether every block came back bit
for bit.  A ``gate`` case runs one pipelined train step whose gate refuses
the update and reports whether any tensor of the state changed.
"""
from __future__ import annotations

import sys

import torch

from repro_torch import tree
from repro_torch.convert import pipeline_storage_from_numpy, storage_from_numpy
from repro_torch.core import stepfn
from repro_torch.data.synthetic import DataConfig, local_rows, make_batch
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adam import AdamConfig, adam_init
from repro_torch.resilience import reshard
from torch_dist_ranks import _numpy, main


def _storage(cfg, job, layout, axis):
    if layout.stages > 1:
        return pipeline_storage_from_numpy(cfg, job["params"], layout.pipe_spec(cfg),
                                           partitioned=layout.partitioned, axis=axis)
    return storage_from_numpy(cfg, job["params"], partitioned=layout.partitioned, axis=axis)


def run_bundle(job, case, axis):
    cfg = ModelConfig(**job["cfg"])
    layout = reshard.MeshLayout(**case["layout"])
    storage = _storage(cfg, job, layout, axis)
    bundle = {"params": storage, "mu": tree.tree_map(lambda t: 2 * t + 1, storage),
              "nu": tree.tree_map(lambda t: t * t, storage),
              "opt_step": torch.tensor(7, dtype=torch.int32)}
    reshard.save_bundle(case["root"], bundle, cfg, layout, axis, step=3,
                        meta={"layout": layout.to_meta(), "moment_dtype": "float32"})
    back = tree.tree_map(torch.zeros_like, bundle)
    step = reshard.restore_bundle(case["root"], back, cfg, layout, axis)
    equal = all(torch.equal(a, b) for a, b in zip(tree.leaves(bundle), tree.leaves(back)))
    return {"step": step, "equal": equal, "storage": _numpy(storage)}


def run_gate(job, case, axis):
    cfg = ModelConfig(**job["cfg"])
    layout = reshard.MeshLayout(**case["layout"])
    storage = _storage(cfg, job, layout, axis)
    data = DataConfig(**case["data"])
    step = stepfn.build_pipeline_train_step(cfg, layout.pipe_spec(cfg), AdamConfig(),
                                            partitioned=layout.partitioned, axis=axis,
                                            gate=lambda loss, gnorm: False)
    opt = adam_init(storage)
    state = {"params": storage, "mu": opt["mu"], "nu": opt["nu"], "step": opt["step"]}
    before = tree.tree_map(torch.clone, state)
    storage, opt2, m = step(storage, opt, local_rows(make_batch(data, 0), axis))
    after = {"params": storage, "mu": opt2["mu"], "nu": opt2["nu"], "step": opt2["step"]}
    return {"skipped": bool(m.get("skipped")), "same_opt": opt2 is opt,
            "unchanged": all(torch.equal(a, b) for a, b in zip(tree.leaves(before),
                                                               tree.leaves(after)))}


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), {"bundle": run_bundle, "gate": run_gate})
