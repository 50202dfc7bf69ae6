"""Model families, one module each, found by the ``family`` key of a
configuration file: ``bench/families/<family>.py``.  A family module gives
the weight layout the seed fills (``matrix_shapes``), the parameters the
flop count takes (``product_params``) and the port's ``ModelConfig``
fields (``port_fields``).  It imports nothing of the port; its reference
layer is ``bench/reference/families/<family>.py``.  Adding a family is
adding those two files."""
from __future__ import annotations

import importlib


def of(conf: dict):
    """The family module of a configuration file."""
    return importlib.import_module(f"bench.families.{conf['family']}")
