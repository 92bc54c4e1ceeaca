"""Misc utilities: this package's copy of the JAX package's `utils/misc.py`
(reference `oscar/utils/misc.py`)."""

from __future__ import annotations

import errno
import os
import random
from typing import Any, Sequence

import numpy as np


def mkdir(path: str) -> None:
    """`os.makedirs`, quiet when the directory exists."""
    try:
        os.makedirs(path)
    except OSError as e:
        if e.errno != errno.EEXIST:
            raise


def set_seed(seed: int, _n_gpu: int = 0) -> None:
    """Seed Python's and numpy's global streams, as the JAX package does.
    Torch's draws come from the explicit generators the port passes around
    (`Trainer.generator`, the models' `seed=`), never from a global seed."""
    random.seed(seed)
    np.random.seed(seed)


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


def weighted_sample(weights: Sequence[float], rng: random.Random) -> int:
    """An index drawn with probability proportional to `weights`, one
    `rng.random()` a draw (reference misc.py:weighted_sample)."""
    total = float(sum(weights))
    r = rng.random() * total
    acc = 0.0
    for i, w in enumerate(weights):
        acc += w
        if r <= acc:
            return i
    return len(weights) - 1
