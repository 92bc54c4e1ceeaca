"""The device's idle share of a unit of work: busy seconds from the trace,
the unit's time from the untraced window (`metrics/shared.py`)."""

from benchmark.metrics.shared import device_idle


def read(r):
    return device_idle(r)
