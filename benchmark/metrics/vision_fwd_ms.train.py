"""Device ms a step of the vision tower's forward: the kernels launched
under `bench.vision_fwd`, the range the SigLIP driver opens around the
program's `vision_model` forward while tracing."""

from benchmark.metrics.shared import range_ms


def read(r):
    return range_ms(r, "bench.vision_fwd")
