"""Seconds of a sweep's rerank stage, as the program's own stage clock
(`two_stage_scoring`'s `seconds["rerank"]`, host clock after a device
synchronise) gives it, averaged over the window's sweeps."""


def read(r):
    s = r.extra.get("rerank_s")
    return sum(s) / len(s) if s else None
