"""Profiling hooks: the JAX package's `training/profiler.py` on torch.

`StepTimer` splits each step's host time into named parts (the reference's
`time_info` meters, run_pretrain_ml.py:517,595-683); `device_memory_gb`
reads the CUDA allocator (what the reference logs on every line,
run_pretrain_ml.py:682); `step_memory_gb` measures one step's peak, the
counterpart of the JAX package's `compiled_memory_gb`; `device_trace`
captures a `torch.profiler` trace of a block into one Chrome/Perfetto
trace file.

`annotate` is the program's span: every span adds its host time to the
record of the root span open on its thread, whose records `records` reads
back, and under a profiler it is also a named range of the trace. The
program's spans:
- `train_step` (root): `Trainer.step`; inside it `trainer.prologue`,
  `trainer.forward` and `trainer.backward` (each micro batch),
  `trainer.update`, `trainer.collectives` (under a mesh) and
  `trainer.readback` (the host reading the step's numbers off the card);
- `two_stage_scoring` (root): `tasks/retrieval.py::two_stage_scoring`;
  inside it `retrieval.encode_text`, `.encode_image`, `.coarse`,
  `.rerank` and `.ranks`, each closed after a device synchronise;
- `siglip.vision`, `siglip.text` and `siglip.loss`: `models/siglip.py`'s
  forward (the towers and the sigmoid loss), inside `trainer.forward`.
"""

from __future__ import annotations

import contextlib
import os
import socket
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Iterable, List, Tuple

import torch
from torch.autograd import profiler as _torch_profiler

GB = 1024.0 ** 3
RING = 1024     # root records kept, the newest last

_ring: Deque["SpanRecord"] = deque(maxlen=RING)
_open = threading.local()       # `.root`: the record of this thread's root
_user_ranges = 0                # > 0 while a `device_trace` is open


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
    it too. Inside it the program's spans are user annotations
    (`_range`)."""
    global _user_ranges
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    _user_ranges += 1
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        _user_ranges -= 1
        prof.stop()
        name = (f"{socket.gethostname()}_{os.getpid()}."
                f"{int(time.time() * 1e3)}.pt.trace.json")
        prof.export_chrome_trace(os.path.join(log_dir, name))


class SpanRecord:
    """One closed root span: its `name`, its own host `ns`, for each span
    nested in it at any depth `spans[name] = [count, summed host ns]`, and
    `profiled`: whether the torch profiler was on at an edge of any of its
    spans (its times then carry the profiler's cost)."""

    __slots__ = ("name", "ns", "spans", "profiled")

    def __init__(self, name: str):
        self.name = name
        self.ns = 0
        self.spans: Dict[str, List[int]] = {}
        self.profiled = False


def records(name: str) -> List[SpanRecord]:
    """The kept records (the last `RING` roots of any name) of root spans
    named `name`, oldest first."""
    return [r for r in list(_ring) if r.name == name]


def _range(name: str):
    """The profiler's range of a span. Inside `device_trace` a user
    annotation, which the trace draws on the host thread and, over the
    kernels launched inside it, on the device's timeline. Under a profiler
    started elsewhere a host-only range: it labels the host's time and puts
    no event on the device's timeline, so whoever reads that profile's
    device events reads kernels only."""
    if _user_ranges:
        return torch.profiler.record_function(name)
    return torch._C._profiler._RecordFunctionFast(name)


class annotate:
    """`with annotate(name):` a span of the program. Its host wall time
    (`time.perf_counter_ns`) goes to the record of the root span open on
    its thread; opened with none open there, it is that root, and its
    record goes to the ring that `records` reads when it closes. With the
    torch profiler on, it is also a range of the profile (`_range`); off,
    it costs two clock reads and a dict update."""

    __slots__ = ("name", "_root", "_own", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "annotate":
        root = getattr(_open, "root", None)
        self._own = root is None
        if root is None:
            root = _open.root = SpanRecord(self.name)
        self._root = root
        self._range = None
        if _torch_profiler._is_profiler_enabled:
            root.profiled = True
            self._range = _range(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        ns = time.perf_counter_ns() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        root = self._root
        if _torch_profiler._is_profiler_enabled:
            root.profiled = True
        if self._own:
            root.ns = ns
            _open.root = None
            _ring.append(root)
        else:
            got = root.spans.get(self.name)
            if got is None:
                root.spans[self.name] = [1, ns]
            else:
                got[0] += 1
                got[1] += ns
        return False
