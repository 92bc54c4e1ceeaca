"""The benchmark's plain reference models, one module per model family
(`configs/<config>.json` names its `family`). Nothing here imports the
program under test."""

from __future__ import annotations

import importlib


def family(name: str):
    """The reference module of a model family ("two_stream", ...)."""
    if not name.replace("_", "").isalnum():
        raise ValueError(f"family {name!r}")
    return importlib.import_module(f"{__name__}.{name}")
