"""The reference's layer of each model family, one module each:
``bench/reference/families/<family>.py`` for a configuration whose
``family`` is ``<family>``."""
from __future__ import annotations

import importlib


def of(conf: dict):
    return importlib.import_module(f"bench.reference.families.{conf['family']}")
