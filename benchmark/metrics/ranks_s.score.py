"""Seconds a sweep of the `retrieval.ranks` stage (the scores read back and
R@K on the host), from the program's span records: the median over the
untraced window's `two_stage_scoring` records (`host_fwd_ms.train.py`)."""

import os

from benchmark import harness

_fwd = harness.load_module(os.path.join(os.path.dirname(__file__),
                                        "host_fwd_ms.train.py"))


def read(r):
    return _fwd.span_median(r, "two_stage_scoring", "retrieval.ranks", 1e-9)
