"""Arithmetic that several readers share."""

from benchmark.flops.attention import bound_s


def mfu(readings, flops_per_unit: float):
    """Model FLOPs of the window's steps or sweeps over its host-clock
    seconds, as a percentage of the card's dense peak at the model's
    dtype."""
    w = readings.window
    if not w["units"] or w["seconds"] <= 0:
        return None
    return (100.0 * flops_per_unit * w["units"] / w["seconds"]
            / readings.peak_flops())


def attn_roofline(readings):
    """The traced attention forward calls' least time (`flops/attention.py`)
    over the device time of the kernels launched inside them, in %."""
    s = readings.summary
    t = s.range_s("bench.attn_fwd") if s is not None else None
    if not t or not s.attn_calls:
        return None
    return 100.0 * sum(bound_s(*call) for call in s.attn_calls) / t


def range_ms(readings, name: str):
    """Device milliseconds a step or sweep under the benchmark's range."""
    s = readings.summary
    t = s.range_s(name) if s is not None else None
    if t is None or not s.units:
        return None
    return 1e3 * t / s.units


def device_idle(readings):
    """The share of a step's (or sweep's) time, in %, in which no device
    operation ran: the traced window's device-busy seconds a unit, over the
    untraced window's seconds a unit of the same run (the profiler's host
    overhead stretches the traced window's own length)."""
    s, w = readings.summary, readings.window
    if s is None or not s.units or s.busy_s <= 0 or not w["units"]:
        return None
    return 100.0 * (1.0 - (s.busy_s / s.units) / (w["seconds"] / w["units"]))
