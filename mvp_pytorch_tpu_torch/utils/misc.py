"""Misc utilities: this package's copy of the JAX package's `utils/misc.py`
parts the port reads (reference `oscar/utils/misc.py`)."""

from __future__ import annotations

from typing import Any


def load_from_yaml_file(path: str) -> Any:
    """The YAML file's contents. PyYAML is imported here, at the first call,
    so that only a multi-corpus manifest (`--dataset_yaml`) needs it."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(f"--dataset_yaml {path} needs PyYAML (the `yaml` "
                          f"module), which is not installed") from e
    with open(path) as f:
        return yaml.safe_load(f)
