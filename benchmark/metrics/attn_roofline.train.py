"""The attention forward's share of its roofline in the traced window."""

from benchmark.metrics.shared import attn_roofline


def read(r):
    return attn_roofline(r)
