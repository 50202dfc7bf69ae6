"""The distributed-training planner (counterpart of ``repro/planner``; its
modules are copies, which the port may not import):

  simulator.py   the discrete-event simulator of pipeline schedules and the
                 executable tick tables ``core/pipeline.py`` runs;
  search.py      the pruned search over (schedule, accumulation method,
                 partition, n_a, n_l, b_mu, n_mu) for the paper's X_[x]
                 family, with ``core/calculator.py``'s constraints, ranked
                 by simulated step time; and the serving search;
  plan.py        the JSON plan contract and the executable plans that
                 ``launch.train --plan`` runs;
  validate.py    the predicted composition of a step against the port's
                 counted work (``core/roofline.py``'s counter and
                 ``core/dist.py``'s collective counts).

CLI: ``python -m repro_torch.launch.plan``.
"""
# no function re-exports: they would shadow the submodule names
# (``repro_torch.planner.search`` must stay the module, not the function)
from repro_torch.planner import plan, search, simulator  # noqa: F401
from repro_torch.planner.search import Plan  # noqa: F401
from repro_torch.planner.simulator import CostModel, SimConfig, SimResult  # noqa: F401
