"""The attention backward's share of its roofline in the traced window: the
least time of the traced calls' backwards (`flops/attention_bwd.py`, one
backward for each forward call a training step logs) over the device time
under `bench.attn_bwd`, in %."""

from benchmark.flops.attention_bwd import bound_s


def read(r):
    s = r.summary
    t = s.range_s("bench.attn_bwd") if s is not None else None
    if not t or not s.attn_calls:
        return None
    return 100.0 * sum(bound_s(*call) for call in s.attn_calls) / t
