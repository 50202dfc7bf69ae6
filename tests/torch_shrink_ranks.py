"""One rank of a (stage x) data x model grid of processes on gloo, for
``tests/test_torch_shrink.py``.  It imports torch and the port only.

    PYTHONPATH=src python tests/torch_shrink_ranks.py JOB RANK

``JOB`` is a pickle as ``tests/torch_dist_ranks.py`` reads it.  A ``sup``
case builds its own grid, ``(stages, data, model)`` over the global ranks
it names (``dist.make_axis``; a rank outside them sits the case out), runs
the supervised loop (``resilience/supervisor.py``) there under a fault plan,
and reports its result and history, the grid it ended on, and its final
state (params and moments: this rank's blocks, their moments' dtypes, and on
the grid's first rank the whole state in the full layout) or the error that
stopped it, with the state's digest there.  A rank that leaves in a failure-shrink goes on to the next
case: the default group still holds it.
"""
from __future__ import annotations

import sys

from repro_torch import tree
from repro_torch.core import dist
from repro_torch.data.synthetic import DataConfig
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adam import AdamConfig
from repro_torch.resilience import faults as flt
from repro_torch.resilience import reshard
from repro_torch.resilience.reshard import MeshLayout
from repro_torch.resilience.supervisor import (Supervisor, SupervisorConfig, SupervisorError,
                                               state_digest)
from torch_dist_ranks import main


def _full(bundle: dict, cfg: ModelConfig, layout: MeshLayout, axis) -> dict | None:
    """The grid's bundle gathered to its first rank and put in the full
    layout there (host numpy, bf16 widened); None on the other ranks."""
    got: dict = {}
    for path, leaf in reshard.global_leaves(bundle, cfg, layout, axis):
        if leaf is not None:
            d = got
            for k in path[:-1]:
                d = d.setdefault(k, {})
            d[path[-1]] = leaf
    return {k: reshard.to_full_state(v, cfg, layout) for k, v in got.items()} or None


def run_sup(job, case, _):
    stages, ndata, tp = case["grid"]
    axis = dist.make_axis(ndata, tp, stages, ranks=case["ranks"])
    if axis is None:
        return None
    cfg = ModelConfig(**job["cfg"])
    plan = flt.FaultPlan([flt.Fault(**f) for f in case["faults"]])
    sv = Supervisor(cfg, AdamConfig(**case["opt"]), DataConfig(**case["data"]),
                    MeshLayout(**case["layout"]), ckpt_root=case["root"],
                    sup=SupervisorConfig(**case["sup"]), fault_plan=plan, axis=axis,
                    plan_execution=case.get("plan"))
    out = {}
    try:
        out["result"] = sv.run(case["steps"])
    except SupervisorError as e:
        out["error"] = str(e)
        out["digest"] = state_digest(sv._bundle())
    out["history"] = sv.history_by_step()
    out["grid"] = (sv.axis.nstage, sv.axis.ndata, sv.axis.tp, sv.axis.stage_index,
                   sv.axis.data_index, sv.axis.model_index)
    out["events"] = [io["op"] for io in sv.io]
    if sv.storage is not None and "error" not in out:
        bundle = {"params": sv.storage, "mu": sv.opt["mu"], "nu": sv.opt["nu"]}
        out["state"] = tree.tree_map(reshard._np, bundle)
        out["moment_dtypes"] = sorted({str(t.dtype) for k in ("mu", "nu")
                                       for t in tree.leaves(bundle[k])})
        out["full"] = _full(bundle, cfg, sv.layout, sv.axis)
        out["digest"] = state_digest(sv._bundle())
    return out


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), {"sup": run_sup})
