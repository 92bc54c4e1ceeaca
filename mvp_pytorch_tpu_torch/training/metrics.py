"""Metric meters and writer, the JAX package's `training/metrics.py`.

`SmoothedValue` keeps the median of a window of 20 beside the global
average; `MetricLogger` groups meters by name; `MetricsWriter` appends JSON
lines to `metrics.jsonl`.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict, deque
from typing import Dict


class SmoothedValue:
    """A series with its median over a window and its global average."""

    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        v = float(value)
        self.deque.append(v)
        self.count += 1
        self.total += v

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        n = len(d)
        if n == 0:
            return 0.0
        return d[n // 2] if n % 2 else (d[n // 2 - 1] + d[n // 2]) / 2

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class MetricLogger:
    """Grouped meters with a printable summary."""

    def __init__(self):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self):
        return "  ".join(f"{name}: {m.median:.4f} ({m.global_avg:.4f})"
                         for name, m in self.meters.items())


class MetricsWriter:
    """JSON-lines metrics sink: one line per step."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def write(self, step: int, metrics: Dict[str, float],
              prefix: str = "train"):
        rec = {"step": step, "time": time.time(),
               **{f"{prefix}/{k}": float(v) for k, v in metrics.items()}}
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()

    def close(self):
        self.jsonl.close()
