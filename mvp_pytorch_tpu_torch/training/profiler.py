"""Profiling hooks: the JAX package's `training/profiler.py` on torch.

`StepTimer` splits each step's host time into named parts (the reference's
`time_info` meters, run_pretrain_ml.py:517,595-683); `device_memory_gb`
reads the CUDA allocator (what the reference logs on every line,
run_pretrain_ml.py:682); `step_memory_gb` measures one step's peak, the
counterpart of the JAX package's `compiled_memory_gb`; `device_trace`
captures a `torch.profiler` trace of a block into one Chrome/Perfetto
trace file, and `annotate` names a region inside it.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Any, Callable, Dict, Iterable, Tuple

import torch

GB = 1024.0 ** 3


class StepTimer:
    """The data/compute split of a step (the reference's time_info group):
    `mark(name)` adds the seconds since the last mark to `name`; `pop()`
    returns the sums and starts again."""

    def __init__(self):
        self.t: Dict[str, float] = {}
        self._mark = time.time()

    def mark(self, name: str) -> None:
        now = time.time()
        self.t[name] = self.t.get(name, 0.0) + (now - self._mark)
        self._mark = now

    def pop(self) -> Dict[str, float]:
        out, self.t = self.t, {}
        self._mark = time.time()
        return out


def device_memory_gb(device=None) -> Dict[str, float]:
    """The CUDA allocator's telemetry under the JAX package's keys:
    `hbm_peak_gb` (`max_memory_allocated`), `hbm_gb` (`memory_allocated`)
    and `hbm_limit_gb` (the card's total, from `mem_get_info`). On a CPU
    device, `{}`: the JAX package's CPU fallback `hbm_live_gb` sums the live
    jax arrays, which torch has no registry of."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    return {"hbm_peak_gb": torch.cuda.max_memory_allocated(device) / GB,
            "hbm_gb": torch.cuda.memory_allocated(device) / GB,
            "hbm_limit_gb": torch.cuda.mem_get_info(device)[1] / GB}


def tensor_bytes(tensors: Iterable[Any]) -> int:
    """The bytes of the tensors among `tensors` (a dict's values, nested
    dicts and lists included)."""
    total = 0
    for t in tensors:
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        elif isinstance(t, dict):
            total += tensor_bytes(t.values())
        elif isinstance(t, (list, tuple)):
            total += tensor_bytes(t)
    return total


def step_memory_gb(run: Callable[[], Any], device, arg_bytes: int
                   ) -> Tuple[Any, Dict[str, float]]:
    """`run()` once, and its memory, measured, not compiled: XLA's static
    buffer assignment (`compiled_memory_gb`) has no torch counterpart, so
    the allocator's peak is reset before the call and read after it.
    `step_peak_gb` is that peak, `step_args_gb` the `arg_bytes` the step
    takes in (parameters, optimizer state and batch), `step_temp_gb` the
    rest. Returns (run's result, those keys); on a CPU device the keys are
    `{}`."""
    device = torch.device(device)
    if device.type != "cuda":
        return run(), {}
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = run()
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    return out, {"step_peak_gb": peak / GB, "step_args_gb": arg_bytes / GB,
                 "step_temp_gb": (peak - arg_bytes) / GB}


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A `torch.profiler` trace of the block (CPU and, with a card, CUDA
    activity), written on exit as one Chrome trace file,
    `<log_dir>/<host>_<pid>.<ms>.pt.trace.json`, which TensorBoard's
    profiler plugin and Perfetto open. The CUDA events are CUPTI's, so a
    kernel launched outside the torch dispatcher (`ops/_kernels.py`) is in
    it too."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        name = (f"{socket.gethostname()}_{os.getpid()}."
                f"{int(time.time() * 1e3)}.pt.trace.json")
        prof.export_chrome_trace(os.path.join(log_dir, name))


def annotate(name: str):
    """A named region inside a trace (`torch.profiler.record_function`)."""
    return torch.profiler.record_function(name)
