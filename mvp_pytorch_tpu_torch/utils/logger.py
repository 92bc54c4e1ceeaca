"""Logging setup: this package's copy of the JAX package's
`utils/logger.py`.

Parity target: reference `oscar/utils/logger.py:83-101` — named logger with
console + file handlers on rank 0, silent elsewhere; the reference's
reopen-per-emit FileHandler (for fuse-mounted blob storage) is kept as an
opt-in flag.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional


class ReopeningFileHandler(logging.Handler):
    """Close+reopen the file per emit so fuse/blob mounts see appends
    (reference utils/logger.py:9-76)."""

    def __init__(self, filename: str):
        super().__init__()
        self.filename = filename

    def emit(self, record):
        msg = self.format(record)
        with open(self.filename, "a") as f:
            f.write(msg + "\n")


def setup_logger(name: str, save_dir: Optional[str] = None, rank: int = 0,
                 filename: str = "log.txt", reopen_per_emit: bool = False
                 ) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    # a second call (another run in the same process) replaces the first
    # call's handlers, so each run logs to its own save_dir
    for h in logger.handlers:
        h.close()
    if rank > 0:
        logger.handlers = [logging.NullHandler()]
        return logger
    logger.handlers = []
    fmt = logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s: %(message)s")
    ch = logging.StreamHandler(stream=sys.stdout)
    ch.setLevel(logging.DEBUG)
    ch.setFormatter(fmt)
    logger.addHandler(ch)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, filename)
        fh = (ReopeningFileHandler(path) if reopen_per_emit
              else logging.FileHandler(path))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
