"""Device ms a step of the attention backward (the kernels launched inside
the autograd function's backward)."""

from benchmark.metrics.shared import range_ms


def read(r):
    return range_ms(r, "bench.attn_bwd")
