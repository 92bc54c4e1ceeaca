"""Host ms a step of the trainer's `trainer.forward` span, from the
program's own span records (`training/profiler.py`), which the profiler
does not stretch: the median, over the untraced window's steps, of the
span's host time in each step's `train_step` record. `span_median` is the
reading that the other `host_*` and `ranks_s` readers share."""

import statistics


def span_median(r, root: str, span: str, scale: float):
    """The median of `span`'s summed host ns in the window's `root` records,
    times `scale`: the last `units` records kept with the profiler off (the
    checked steps or the warm-up sweep come before them, the traced ones
    after). None where the program keeps no such records."""
    try:
        from mvp_pytorch_tpu_torch.training.profiler import records
    except ImportError:
        return None
    n = r.window["units"]
    kept = [x for x in records(root) if not x.profiled][-n:] if n else []
    if not kept:
        return None
    return statistics.median(x.spans.get(span, (0, 0))[1]
                             for x in kept) * scale


def read(r):
    return span_median(r, "train_step", "trainer.forward", 1e-6)
