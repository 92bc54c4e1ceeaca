"""Model FLOPs of a training step (`flops/<config>.py`) over the window's
step time, against the card's peak (moves train_samples_per_s)."""

from benchmark.metrics.shared import mfu


def read(r):
    return mfu(r, r.extra["flops_per_step"])
