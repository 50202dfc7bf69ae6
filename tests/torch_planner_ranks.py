"""One rank of a (stage x) data x model grid of processes on gloo, for
``tests/test_torch_planner.py``.  It imports torch and the port only.

    PYTHONPATH=src python tests/torch_planner_ranks.py JOB RANK

``JOB`` is a pickle as ``tests/torch_dist_ranks.py`` reads it (no weights,
no batch: the runs draw their own); its cases are the planner's composition
checks, ``accum`` (``validate.accum_composition``) and ``pipe``
(``validate.pipeline_composition``), each returning this rank's predicted
and measured composition.
"""
from __future__ import annotations

import sys

from repro_torch.core.schedules import PipeSpec
from repro_torch.models.common import ModelConfig
from repro_torch.planner import validate as V
from torch_dist_ranks import main


def run_accum(job, case, axis):
    return V.accum_composition(ModelConfig(**job["cfg"]), axis, method=case["method"],
                               partitioned=case["part"], n_microbatches=case["M"],
                               mb=case["mb"], seq=case["seq"])


def run_pipe(job, case, axis):
    cfg = ModelConfig(**job["cfg"])
    spec = PipeSpec(n_stages=axis.nstage, layers_per_stage=cfg.num_layers // axis.nstage,
                    n_microbatches=case["M"], schedule=case["schedule"])
    return V.pipeline_composition(cfg, spec, case["M"], case["mb"], case["seq"], axis=axis)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), {"accum": run_accum, "pipe": run_pipe})
