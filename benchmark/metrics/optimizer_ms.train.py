"""Device ms a step of the optimizer update (the kernels launched inside
the trainer's call of AdamW's `step`)."""

from benchmark.metrics.shared import range_ms


def read(r):
    return range_ms(r, "bench.optimizer")
