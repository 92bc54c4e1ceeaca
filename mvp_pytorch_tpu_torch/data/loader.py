"""Deterministic, resumable batches, prefetched by worker processes and
copied to the card one step ahead.

`EpochShuffler` and `BatchSampler` are the JAX package's `data/loader.py`
index math: a batch is a pure function of (seed, step), so the same seed
gives the same batches at every step and resuming at step k is an O(1)
skip. Each process owns its sampler (no lock: no threads share it).

`ProcessLoader` is this package's own prefetch design, for a training step
whose host thread is the bottleneck (it launches the step's kernels), so
that the main thread does almost nothing per step:
- worker processes (not threads, which would take the interpreter lock
  from the launch loop) run `fetch(indices, epoch)` for whole batches
  (`fetch(indices)` when `fetch` takes no `epoch`: `_epoch_aware`). Worker w
  owns the steps start + w, start + w + W, ... and a ring of shared-memory
  slots; it writes each batch into a free slot and sends only
  (step, slot, its milliseconds) through its queue;
- on a CUDA device the consumer registers every slot with
  `cudaHostRegister` once, so each slot is page-locked. Per step it enqueues
  one `non_blocking` copy of the next step's whole slot (all arrays of the
  batch, laid out at aligned offsets) into a fresh device buffer on a side
  stream, records an event, and hands the current step's buffer to the
  compute stream (`wait_event`, `record_stream`) as views of its arrays. A
  slot goes back to its worker once its copy's event has completed. No
  per-step copy-out, pickling of arrays or pageable copy is left on the
  main thread;
- on the CPU the consumer copies the arrays out of the slot.

Batches come in step order. A worker's exception reaches the consumer as a
`RuntimeError` with the worker's traceback; a worker that dies, or sends
nothing for `timeout` seconds, raises too, never hangs. The start method is
explicit (`multiprocessing_context`): `fork` shares the parent's dataset
without pickling it; `spawn` pickles `fetch` and the sampler and starts
clean, which a parent holding threads that must not be forked needs.
Workers ignore SIGTERM, so that a scheduler's signal to the process group
reaches the training loop (its preemption checkpoint) and not them: the
consumer stops them (`close`, killing one that does not stop), and a worker
whose parent has gone exits by itself.
"""

from __future__ import annotations

import inspect
import multiprocessing
import os
import queue
import signal
import time
import traceback
import uuid
from collections import deque
from multiprocessing import shared_memory
from typing import Callable, Dict

import numpy as np
import torch

_ALIGN = 256                 # byte alignment of each array in a slot
SLOTS_PER_WORKER = 2         # a worker fills one slot while one is in use


class EpochShuffler:
    """Deterministic per-epoch permutation, a few recent epochs cached."""

    def __init__(self, n: int, seed: int = 0, shuffle: bool = True):
        self.n = n
        self.seed = seed
        self.shuffle = shuffle
        self._cache: Dict[int, np.ndarray] = {}

    def _perm(self, epoch: int) -> np.ndarray:
        p = self._cache.get(epoch)
        if p is None:
            if self.shuffle:
                rng = np.random.default_rng((self.seed, epoch))
                p = rng.permutation(self.n)
            else:
                p = np.arange(self.n)
            self._cache[epoch] = p
            if len(self._cache) > 8:
                for k in sorted(self._cache)[:-8]:
                    del self._cache[k]
        return p


class BatchSampler:
    """The indices of the batch at any step, forever (the reference's
    IterationBasedBatchSampler role).

    `rank`/`world_size`: each rank receives its contiguous
    batch_size/world_size shard of the global batch (the reference's
    DistributedSampler role). `drop_last=True` skips the per-epoch tail
    that cannot fill a global batch (the reference wraps
    BatchSampler(drop_last=True)); batches never mix epochs then. With
    n < batch_size the tail-skip would drop everything, so it falls back
    to wrap-around."""

    def __init__(self, n: int, batch_size: int, seed: int = 0,
                 shuffle: bool = True, drop_last: bool = True,
                 rank: int = 0, world_size: int = 1):
        if batch_size % max(world_size, 1) or not (
                0 <= rank < max(world_size, 1)):
            raise ValueError(f"batch {batch_size} over world {world_size}, "
                             f"rank {rank}")
        self.n = n
        self.global_batch = batch_size
        self.local_batch = batch_size // max(world_size, 1)
        self.shuffler = EpochShuffler(n, seed, shuffle)
        self.rank = rank
        self.world_size = world_size
        if drop_last and n >= batch_size:
            self.epoch_len = (n // batch_size) * batch_size
        else:
            self.epoch_len = n

    def _index(self, global_pos: int) -> int:
        epoch, offset = divmod(global_pos, self.epoch_len)
        return int(self.shuffler._perm(epoch)[offset])

    def batch_at(self, step: int) -> np.ndarray:
        base = step * self.global_batch + self.rank * self.local_batch
        return np.asarray([self._index(base + i)
                           for i in range(self.local_batch)])

    def epoch_at(self, step: int) -> int:
        return (step * self.global_batch) // self.epoch_len


def _epoch_aware(fetch: Callable) -> Callable[[np.ndarray, int], Dict]:
    """`fetch` under the (indices, epoch) calling convention (the JAX
    package's `data/loader.py` `_epoch_aware`).

    A dataset whose masking rng is keyed on the epoch takes
    `fetch(indices, epoch)`: the loader must pass the sampler's epoch, or
    every epoch repeats epoch 0's masks (the reference re-masks each epoch
    through its per-`__getitem__` random state and
    `DistributedSampler.set_epoch`). Any other fetch gets `fetch(indices)`."""
    try:
        takes_epoch = "epoch" in inspect.signature(fetch).parameters
    except (TypeError, ValueError):
        takes_epoch = False
    if takes_epoch:
        return lambda idx, epoch: fetch(idx, epoch)
    return lambda idx, epoch: fetch(idx)


def _layout(batch: Dict[str, np.ndarray]):
    """[(key, shape, dtype string, byte offset)] at aligned offsets, and the
    slot's size in bytes."""
    out, total = [], 0
    for k in sorted(batch):
        a = batch[k]
        out.append((k, tuple(a.shape), a.dtype.str, total))
        total += -(-a.nbytes // _ALIGN) * _ALIGN
    return out, max(total, _ALIGN)


def _slot_name(tag: str, worker: int, slot: int) -> str:
    return f"mvpt_{tag}_{worker}_{slot}"


def _worker(wid: int, n_workers: int, fetch, sampler, start_step: int,
            n_slots: int, tag: str, q, free, stop) -> None:
    """Worker process: fetch the steps start + wid + k n_workers (each with
    its epoch, where `fetch` takes one) into the
    slot ring, sending ("spec", layout, size) once, then ("batch", step,
    slot, fetch ms, fill ms) per batch, or ("error", traceback)."""
    shms = []
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    parent = os.getppid()
    try:
        call = _epoch_aware(fetch)
        step = start_step + wid
        t0 = time.perf_counter()
        batch = call(sampler.batch_at(step), sampler.epoch_at(step))
        fetch_ms = (time.perf_counter() - t0) * 1e3
        layout, size = _layout(batch)
        for s in range(n_slots):
            shm = shared_memory.SharedMemory(
                create=True, size=size, name=_slot_name(tag, wid, s))
            shms.append(shm)
            # the consumer unlinks; untrack here so this process's resource
            # tracker does not unlink or warn about it at exit
            from multiprocessing import resource_tracker
            resource_tracker.unregister(shm._name, "shared_memory")
        q.put(("spec", layout, size))
        slot = 0
        while not stop.is_set() and os.getppid() == parent:
            if not free.acquire(timeout=0.2):
                continue
            t0 = time.perf_counter()
            buf = shms[slot].buf
            for k, shape, dt, off in layout:
                np.ndarray(shape, dt, buffer=buf, offset=off)[...] = batch[k]
            del buf
            fill_ms = (time.perf_counter() - t0) * 1e3
            q.put(("batch", step, slot, fetch_ms, fill_ms))
            slot = (slot + 1) % n_slots
            step += n_workers
            t0 = time.perf_counter()
            batch = call(sampler.batch_at(step), sampler.epoch_at(step))
            fetch_ms = (time.perf_counter() - t0) * 1e3
    except BaseException:  # noqa: BLE001 - reported to the consumer
        q.put(("error", traceback.format_exc()))
    finally:
        for shm in shms:
            shm.close()


class ProcessLoader:
    """Single-use iterator of (step, batch) from `start_step` on, where
    batch maps the names of `fetch`'s arrays to tensors on `device`.

    `fetch(indices[, epoch]) -> {name: numpy array}` must give the same
    shapes and dtypes at every step; a fetch that takes `epoch` gets the
    sampler's epoch of the step. `device` has no default: each rank's loader
    moves its batches to that rank's own device. After each step, `timing()` gives the worker's
    milliseconds for the batch just yielded and, on CUDA, its copy's device
    milliseconds (read it once the step has synchronised)."""

    def __init__(self, fetch: Callable[..., Dict[str, np.ndarray]],
                 sampler: BatchSampler, *, device, start_step: int = 0,
                 num_workers: int = 4,
                 multiprocessing_context: str = "fork",
                 timeout: float = 600.0):
        if num_workers < 1:
            raise ValueError(f"num_workers {num_workers} < 1")
        self.fetch = fetch
        self.sampler = sampler
        self.start_step = start_step
        self.num_workers = num_workers
        self.device = torch.device(device)
        self.timeout = timeout
        self._ctx = multiprocessing.get_context(multiprocessing_context)
        self._tag = uuid.uuid4().hex[:12]
        self._procs: list = []
        self._qs: list = []
        self._free: list = []
        self._stop = None
        self._started = False
        self._specs: Dict[int, tuple] = {}     # worker -> (layout, size)
        self._shms: Dict[int, list] = {}       # worker -> SharedMemory
        self._hosts: Dict[int, list] = {}      # worker -> uint8 tensors
        self._registered: list = []            # pinned host pointers
        self._inflight: deque = deque()        # (copy done event, worker)
        self._side = None
        self._timing: dict = {}

    # ------------------------------------------------------------ workers
    def _start(self) -> None:
        self._stop = self._ctx.Event()
        for w in range(self.num_workers):
            q = self._ctx.Queue()
            free = self._ctx.BoundedSemaphore(SLOTS_PER_WORKER)
            p = self._ctx.Process(
                target=_worker, daemon=True,
                args=(w, self.num_workers, self.fetch, self.sampler,
                      self.start_step, SLOTS_PER_WORKER, self._tag, q, free,
                      self._stop))
            self._qs.append(q)
            self._free.append(free)
            self._procs.append(p)
            p.start()

    def _get(self, w: int):
        """Worker w's next message; raises on its error, death or
        silence past `timeout`."""
        deadline = time.monotonic() + self.timeout
        while True:
            try:
                msg = self._qs[w].get(timeout=0.5)
            except queue.Empty:
                p = self._procs[w]
                if not p.is_alive():
                    try:      # a last message may have landed meanwhile
                        msg = self._qs[w].get(timeout=0.5)
                    except queue.Empty:
                        raise RuntimeError(
                            f"loader worker {w} died (exit code "
                            f"{p.exitcode}) without reporting an error"
                        ) from None
                elif time.monotonic() > deadline:
                    raise TimeoutError(
                        f"loader worker {w} sent nothing for "
                        f"{self.timeout:.0f} s")
                else:
                    continue
            if msg[0] == "error":
                raise RuntimeError(f"loader worker {w} failed:\n{msg[1]}")
            if msg[0] == "spec":
                self._open(w, msg[1], msg[2])
                continue
            return msg

    def _open(self, w: int, layout, size: int) -> None:
        shms = [shared_memory.SharedMemory(name=_slot_name(self._tag, w, s))
                for s in range(SLOTS_PER_WORKER)]
        hosts = [torch.frombuffer(s.buf, dtype=torch.uint8, count=size)
                 for s in shms]
        if self.device.type == "cuda":
            cudart = torch.cuda.cudart()
            for h in hosts:
                err = cudart.cudaHostRegister(h.data_ptr(), size, 0)
                if int(err) != 0:
                    raise RuntimeError(f"cudaHostRegister of a {size}-byte "
                                       f"loader slot failed: {err}")
                self._registered.append(h.data_ptr())
        # (key, shape, torch dtype, byte offset, bytes), made once
        layout = [(k, shape, torch.from_numpy(np.empty(0, dt)).dtype, off,
                   int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize)
                  for k, shape, dt, off in layout]
        self._specs[w] = (layout, size)
        self._shms[w] = shms
        self._hosts[w] = hosts

    # ------------------------------------------------------------ batches
    @staticmethod
    def _views(buf: torch.Tensor, layout) -> Dict[str, torch.Tensor]:
        return {k: buf[off:off + n].view(dtype).view(shape)
                for k, shape, dtype, off, n in layout}

    def _take_cpu(self, step: int):
        w = (step - self.start_step) % self.num_workers
        _, got, slot, fetch_ms, fill_ms = self._get(w)
        if got != step:
            raise RuntimeError(f"loader worker {w} sent step {got}, "
                               f"want {step}")
        layout, _ = self._specs[w]
        batch = {k: v.clone()
                 for k, v in self._views(self._hosts[w][slot], layout).items()}
        self._free[w].release()
        return batch, {"worker_ms": fetch_ms + fill_ms}

    def _enqueue(self, step: int):
        """Start the copy of `step`'s slot to the card on the side stream."""
        w = (step - self.start_step) % self.num_workers
        _, got, slot, fetch_ms, fill_ms = self._get(w)
        if got != step:
            raise RuntimeError(f"loader worker {w} sent step {got}, "
                               f"want {step}")
        layout, size = self._specs[w]
        with torch.cuda.stream(self._side):
            start = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            start.record()
            dev = torch.empty(size, dtype=torch.uint8, device=self.device)
            dev.copy_(self._hosts[w][slot], non_blocking=True)
            done.record()
        self._inflight.append((done, w))
        return dev, layout, {"worker_ms": fetch_ms + fill_ms,
                             "h2d": (start, done)}

    def _hand_over(self, pending):
        """The compute stream waits for the copy; the batch's views."""
        dev, layout, timing = pending
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(timing["h2d"][1])
        dev.record_stream(compute)
        return self._views(dev, layout), timing

    def _release_copied(self) -> None:
        while self._inflight and self._inflight[0][0].query():
            self._free[self._inflight.popleft()[1]].release()

    def worker_pids(self) -> list:
        """The process ids of the running workers (empty before the first
        batch and after `close`)."""
        return [p.pid for p in self._procs]

    def timing(self) -> dict:
        """worker_ms (and on CUDA h2d_ms) of the batch yielded last."""
        out = {"worker_ms": self._timing.get("worker_ms", 0.0)}
        if "h2d" in self._timing:
            start, done = self._timing["h2d"]
            out["h2d_ms"] = start.elapsed_time(done)
        return out

    def __iter__(self):
        if self._started:
            raise RuntimeError("ProcessLoader is single-use")
        self._started = True
        step = self.start_step
        try:
            self._start()
            if self.device.type != "cuda":
                while True:
                    batch, self._timing = self._take_cpu(step)
                    yield step, batch
                    step += 1
            self._side = torch.cuda.Stream(self.device)
            pending = self._enqueue(step)
            while True:
                batch, self._timing = self._hand_over(pending)
                pending = self._enqueue(step + 1)
                self._release_copied()
                yield step, batch
                step += 1
        finally:
            self.close()

    def close(self) -> None:
        """Stop and join the workers, unpin and unlink every slot."""
        if self._stop is not None:
            self._stop.set()
        if self._side is not None:
            self._side.synchronize()
        for w, p in enumerate(self._procs):
            deadline = time.monotonic() + 2.0
            while p.is_alive() and time.monotonic() < deadline:
                try:    # unblock a worker waiting for a free slot
                    self._free[w].release()
                except ValueError:
                    pass
                try:    # and one blocked on a full queue pipe
                    self._qs[w].get_nowait()
                except queue.Empty:
                    pass
                p.join(timeout=0.05)
            if p.is_alive():        # it ignores SIGTERM
                p.kill()
                p.join(timeout=5.0)
        if self._registered:
            cudart = torch.cuda.cudart()
            for ptr in self._registered:
                cudart.cudaHostUnregister(ptr)
        self._registered, self._hosts, self._inflight = [], {}, deque()
        for shms in self._shms.values():
            for shm in shms:
                try:
                    shm.close()
                except BufferError:     # a caller still holds a view
                    pass
        self._shms = {}
        # unlink by name: also the slots of a worker whose spec never came
        for w in range(len(self._procs)):
            for s in range(SLOTS_PER_WORKER):
                try:
                    shm = shared_memory.SharedMemory(
                        name=_slot_name(self._tag, w, s))
                except FileNotFoundError:
                    continue
                shm.close()
                shm.unlink()
        for q in self._qs:
            q.close()
            q.cancel_join_thread()
        self._procs, self._qs, self._free = [], [], []
