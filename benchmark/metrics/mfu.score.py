"""Model FLOPs of a retrieval sweep (`flops/<config>.py`) over the window's
sweep time, against the card's peak (moves score_pairs_per_s)."""

from benchmark.metrics.shared import mfu


def read(r):
    return mfu(r, r.extra["flops_per_sweep"])
