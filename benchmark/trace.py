"""The traced window: `torch.profiler` over a few steps or sweeps, with the
benchmark's own ranges around the program's calls, reduced to what the
per-layer readers read.

Ranges (`record_function`, opened by wrappers this module installs only
while tracing, so untraced runs carry none of them):
- `bench.window`: the whole traced window, closed after a synchronise;
- `bench.attn_fwd`: each call of the model's attention entry
  (`models.layers.masked_attention`), whose shapes are logged for the
  roofline;
- `bench.attn_bwd`: each backward of the attention's autograd function
  (`ops.attention.MaskedAttentionFn.backward`);
- whatever the driver adds (the optimizer's `step`).
A range's device time is the time of the kernels launched inside it, on
its thread, as the profiler's event tree attributes them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "bench.window"
ATTN_FWD = "bench.attn_fwd"
ATTN_BWD = "bench.attn_bwd"


def _device_us(event) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def _kernels(event):
    """The device operations launched under a host event, its children's
    included."""
    yield from getattr(event, "kernels", ())
    for ch in event.cpu_children:
        yield from _kernels(ch)


def _union(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Summary:
    """What the readers take from a traced window: seconds of the window,
    device-busy seconds in it, each range's device seconds and count,
    attention calls' shapes, the top device operations and the longest
    idle gaps labelled by what the host was doing."""

    def __init__(self, window_s: float, busy_s: float,
                 ranges: Dict[str, Tuple[float, int]], attn_calls: list,
                 device_ops: list, idle_gaps: list, units: int):
        self.window_s = window_s
        self.busy_s = busy_s
        self.ranges = ranges
        self.attn_calls = attn_calls
        self.device_ops = device_ops
        self.idle_gaps = idle_gaps
        self.units = units          # steps or sweeps in the window
        self.notes: List[str] = []

    def range_s(self, name: str) -> Optional[float]:
        """Device seconds under range `name`, or None if it never ran or
        launched nothing."""
        s, n = self.ranges.get(name, (0.0, 0))
        return s if n and s > 0 else None


class Tracer:
    """`with Tracer(extra) as tr: ... ; summary = tr.summary(units)`.
    `extra`: (object, attribute, range name) of further calls to wrap."""

    def __init__(self, extra=()):
        self.extra = list(extra)
        self.attn_calls: list = []
        self._undo: list = []
        self.prof = None

    def _wrap(self, owner, attr, name, log=None, static=False):
        own = owner.__dict__ if hasattr(owner, "__dict__") else {}
        self._undo.append((owner, attr, attr in own, own.get(attr)))
        orig = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            if log is not None:
                log(*args, **kwargs)
            with torch.profiler.record_function(name):
                return orig(*args, **kwargs)
        setattr(owner, attr, staticmethod(wrapped) if static else wrapped)

    def _log_attn(self, q, k, v, bias=None, *, layout="bhld", **_):
        if layout == "blhd":
            b, lq, h, d = q.shape
            lk = k.shape[1]
        else:
            b, h, lq, d = q.shape
            lk = k.shape[2]
        nbytes = 0 if bias is None else bias.numel() * bias.element_size()
        self.attn_calls.append((b, h, lq, lk, d, str(q.dtype).split(".")[-1],
                                nbytes))

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        from mvp_pytorch_tpu_torch.models import layers
        from mvp_pytorch_tpu_torch.ops.attention import MaskedAttentionFn
        self._wrap(layers, "masked_attention", ATTN_FWD, log=self._log_attn)
        self._wrap(MaskedAttentionFn, "backward", ATTN_BWD, static=True)
        for owner, attr, name in self.extra:
            self._wrap(owner, attr, name)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._range.__exit__(*exc)
        self.prof.__exit__(*exc)
        for owner, attr, had, value in reversed(self._undo):
            if had:
                setattr(owner, attr, value)
            else:
                delattr(owner, attr)
        self._undo.clear()
        return False

    def summary(self, units: int) -> Summary:
        from torch.autograd import DeviceType
        events = list(self.prof.events())
        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        # the profiler mirrors each range on the device's timeline as an
        # annotation spanning its kernels: those are not device work
        dev = [e for e in events if e.device_type != DeviceType.CPU
               and not e.name.startswith("bench.")]
        win = [e for e in cpu if e.name == WINDOW]
        w0 = min(e.time_range.start for e in win)
        w1 = max(e.time_range.end for e in win)
        spans = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
                 for e in dev]
        busy = _union([(s, e) for s, e in spans if e > s])
        ranges: Dict[str, Tuple[float, int]] = {}
        inside: Dict[str, Dict[str, float]] = {}
        for e in cpu:
            if e.name.startswith("bench.") and e.name != WINDOW:
                s, n = ranges.get(e.name, (0.0, 0))
                ranges[e.name] = (s + _device_us(e) * 1e-6, n + 1)
                per = inside.setdefault(e.name, {})
                for k in _kernels(e):
                    per[k.name] = per.get(k.name, 0.0) + k.duration * 1e-6
        by_name: Dict[str, float] = {}
        for e in dev:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) * 1e-6
        device_ops = [[n[:160], s] for n, s in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]]
        gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
        if busy:
            gaps = [(w0, busy[0][0])] + gaps + [(busy[-1][1], w1)]
        gaps = sorted((g for g in gaps if g[1] > g[0]),
                      key=lambda g: g[0] - g[1])[:10]
        main = win[0].thread
        host = sorted((e for e in cpu if e.thread == main
                       and e.name != WINDOW),
                      key=lambda e: e.time_range.start)
        idle_gaps = [[self._host_label(host, (a + b) / 2), (b - a) * 1e-6]
                     for a, b in gaps]
        out = Summary((w1 - w0) * 1e-6, sum(e - s for s, e in busy) * 1e-6,
                      ranges, list(self.attn_calls), device_ops, idle_gaps,
                      units)
        out.notes = [f"trace {name}: " + "; ".join(
            f"{k[:70]} {v:.6f}" for k, v in sorted(
                per.items(), key=lambda kv: -kv[1])[:4])
            for name, per in inside.items()]
        return out

    @staticmethod
    def _host_label(host, t) -> str:
        """The innermost host operation on the main thread at time t, or
        the last one that ended before it."""
        best, last = None, None
        for e in host:
            if e.time_range.start > t:
                break
            if e.time_range.end >= t:
                if best is None or e.time_range.end - e.time_range.start \
                        < best.time_range.end - best.time_range.start:
                    best = e
            elif last is None or e.time_range.end > last.time_range.end:
                last = e
        if best is not None:
            return best.name[:160]
        return "after " + last.name[:150] if last is not None else "(none)"
