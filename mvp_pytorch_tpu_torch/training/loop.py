"""The training loop: the JAX package's `tasks/common.py` `TrainLoop.run`
on one device, shared by the retrieval and pretraining tasks and by the
dataset-driven command line (`tasks/common.py` `TrainLoop`).

`run_training` runs a `Trainer` with `make_optimizer`'s AdamW until `steps`,
over batches from a source that starts at any step (so that a resumed run
takes the batches it would have taken), logs the metrics, writes them as
JSON lines, saves a checkpoint every `ckpt_period` steps and after the last,
and resumes from the newest checkpoint found in `output_dir`. Each step's
metrics also carry `data_ms` (the host's milliseconds waiting for the batch)
and `step_ms` (from the end of the last step's `Trainer.step` to the end of
this one's, so that checkpoints and logging count too), and every
`log_period` steps the JAX loop's telemetry. It also takes the JAX loop's
`--async_ckpt`, `--profile_dir` trace window and SIGTERM preemption
checkpoint (`Preemption`). `train_on_batches` runs it over in-memory
batches.

With a `mesh` every rank runs it over its own batches: the Trainer steps as
one rank (`training/trainer.py`), rank 0 alone logs and writes the metrics
and the checkpoint's whole weights, every rank writes its pieces of the
optimizer state into the checkpoint's `opt_shards/`
(`training/sharded_checkpoint.py`), and a resume cuts whatever topology
wrote the checkpoint to its own. At the end the model is whole on every
rank (each pipe stage's layers from their owner, FSDP shards gathered).
"""

from __future__ import annotations

import contextlib
import itertools
import signal
import threading
import time
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from .checkpoint import AsyncSaver, CheckpointManager
from .metrics import MetricLogger, MetricsWriter
from .optim import make_optimizer
from .profiler import StepTimer, device_memory_gb, device_trace
from .trainer import LossFn, Trainer

# start step -> iterable of (step, batch of tensors on the model's device)
BatchSource = Callable[[int], Iterable[Tuple[int, Mapping[str, torch.Tensor]]]]


def batch_on(device, batch: Mapping, keys=None) -> Dict[str, torch.Tensor]:
    """The batch's arrays (numpy or tensors), or only `keys`, as tensors on
    `device`."""
    out = {}
    for k in (batch if keys is None else keys):
        v = batch[k]
        out[k] = (v if isinstance(v, torch.Tensor)
                  else torch.from_numpy(np.asarray(v))).to(device)
    return out


class Preemption:
    """SIGTERM as a request to stop: the handler only sets a flag, and
    `requested()` is read at each step boundary. Under a process group the
    ranks' flags are all-reduced (MAX) there, so that every rank stops and
    saves at the same step (the launcher forwards a SIGTERM to every rank;
    jax's preemption sync service has no torch counterpart). The handler is
    installed from the main thread only; `restore()` puts the old one back."""

    def __init__(self, device, distributed: bool):
        self.flag = False
        self.device = device
        self.distributed = distributed
        self.old = None
        self.installed = threading.current_thread() is threading.main_thread()
        if self.installed:
            self.old = signal.signal(signal.SIGTERM, self._on_term)

    def _on_term(self, signum, frame) -> None:
        self.flag = True

    def requested(self) -> bool:
        if not self.distributed:
            return self.flag
        import torch.distributed as dist
        t = torch.tensor([int(self.flag)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def restore(self) -> None:
        if self.installed:
            signal.signal(signal.SIGTERM,
                          signal.SIG_DFL if self.old is None else self.old)
            self.installed = False


def run_training(model, loss_fn: LossFn, source: BatchSource, steps: int, *,
                 learning_rate: float, warmup_steps: int = 0,
                 schedule: str = "linear", weight_decay: float = 0.01,
                 eps: float = 1e-8, max_grad_norm: Optional[float] = 1.0,
                 grad_accum: int = 1, seed: int = 0,
                 output_dir: Optional[str] = None,
                 metrics_dir: Optional[str] = None, ckpt_period: int = 0,
                 keep: int = 3, log_period: int = 0, logger=print,
                 saved_args: Optional[dict] = None,
                 on_checkpoint: Optional[Callable[[int], None]] = None,
                 timing: Optional[Callable[[], Dict[str, float]]] = None,
                 freeze_prefix: Optional[str] = None, freeze_steps: int = 0,
                 mesh=None, fsdp: bool = False,
                 pipeline_microbatches: int = 4,
                 batch_size: Optional[int] = None, async_ckpt: bool = False,
                 preempt_save: bool = False,
                 profile_dir: Optional[str] = None, profile_start: int = 2,
                 profile_steps: int = 3) -> List[Dict[str, float]]:
    """Train `model` with `loss_fn` for `steps` steps over `source`. Returns
    each step's metrics; the model is left in eval mode.

    `saved_args` goes into each checkpoint as `training_args.json`;
    `on_checkpoint(step)` runs after each save; `timing()` adds the batch's
    loader timings to the step's metrics. The parameters under
    `freeze_prefix` take no update for the first `freeze_steps` steps.

    Every `log_period` steps the metrics also carry the telemetry of the
    JAX package's loop: `steps_per_sec`, `examples_per_sec` (of
    `batch_size`, the global batch; by default the batch's rows times the
    data ranks), `time_data` and `time_compute` (seconds a step since the
    last log line), `profiler.device_memory_gb` and the Trainer's
    `step_memory`; the log line is followed by a `PROGRESS:` line.

    `async_ckpt` writes checkpoints on a background thread
    (`checkpoint.AsyncSaver`; one process only). `profile_dir` traces
    `profile_steps` steps from the first step at or past `profile_start`
    (0-based), once, on rank 0 (`profiler.device_trace`; each step is the
    trainer's `train_step` span). With `preempt_save` a SIGTERM stops
    the run at the next step boundary: it saves a checkpoint there, skips
    `on_checkpoint` and raises `SystemExit(0)`."""
    optimizer = make_optimizer(
        model, learning_rate, warmup_steps=warmup_steps, total_steps=steps,
        schedule=schedule, weight_decay=weight_decay, eps=eps,
        max_grad_norm=max_grad_norm, freeze_prefix=freeze_prefix,
        freeze_steps=freeze_steps)
    from ..parallel.distributed import is_main_process
    main = is_main_process()
    ckpt = latest = meta = None
    if output_dir is not None:
        ckpt = CheckpointManager(output_dir, keep=keep)
        latest = ckpt.latest()
        if latest is not None:      # the weights before any sharding
            meta = ckpt.restore(latest[1], model, mesh=mesh)
    trainer = Trainer(model, loss_fn, optimizer, grad_accum=grad_accum,
                      seed=seed, mesh=mesh, fsdp=fsdp,
                      pipeline_microbatches=pipeline_microbatches)
    if latest is not None:
        opt_state = ckpt.read_optimizer(latest[1])
        if opt_state is not None:
            trainer.load_optimizer_state(opt_state)
        trainer.step_count = int(meta.get("step", latest[0]))
        logger(f"resumed from {latest[1]} at step {trainer.step_count}")
    writer = (MetricsWriter(metrics_dir) if metrics_dir is not None and main
              else None)
    saver = AsyncSaver() if async_ckpt and mesh is None else None
    meter, history, timer = MetricLogger(), [], StepTimer()
    trace, traced = contextlib.ExitStack(), None
    data_ranks = 1 if mesh is None else mesh.data_size
    batches, stopped = None, False
    # before the source starts its loader: forked workers inherit the
    # handler, so a SIGTERM to the process group does not kill them
    preempt = (Preemption(model.device, mesh is not None) if preempt_save
               else None)
    try:
        batches = iter(source(trainer.step_count))
        t_end = t_last = time.perf_counter()
        t_log, n_since = time.time(), 0
        timer.pop()
        while trainer.step_count < steps:
            got, batch = next(batches)
            timer.mark("data")
            if got != trainer.step_count:
                raise RuntimeError(f"batch of step {got} at step "
                                   f"{trainer.step_count}")
            if (profile_dir and main and traced is None
                    and trainer.step_count >= profile_start):
                trace.enter_context(device_trace(profile_dir))
                traced = trainer.step_count
            data_ms = (time.perf_counter() - t_last) * 1e3
            metrics = trainer.step(batch)       # ends in a device sync
            now = time.perf_counter()
            metrics.update(data_ms=data_ms, step_ms=(now - t_end) * 1e3)
            t_end = now
            step = trainer.step_count
            if traced is not None and step == traced + profile_steps:
                trace.close()
                logger(f"profiler trace of steps {traced + 1}-{step} -> "
                       f"{profile_dir}")
            timer.mark("compute")
            n_since += 1
            if timing is not None:
                metrics.update(timing())
            logged = bool(log_period) and step % log_period == 0
            if logged:
                dt = time.time() - t_log
                rows = batch_size or (next(iter(batch.values())).shape[0]
                                      * data_ranks)
                metrics.update(steps_per_sec=n_since / dt,
                               examples_per_sec=n_since * rows / dt)
                metrics.update({f"time_{k}": v / n_since
                                for k, v in timer.pop().items()})
                metrics.update(device_memory_gb(model.device))
                metrics.update(trainer.step_memory or {})
                t_log, n_since = time.time(), 0
            history.append(metrics)
            meter.update(**metrics)
            if writer is not None:
                writer.write(step, metrics)
            if logged and main:
                logger(f"step {step}/{steps}  {meter}")
                logger(f"PROGRESS: {100.0 * step / steps:.2f}%")
            stopped = preempt is not None and preempt.requested()
            periodic = ckpt is not None and (
                (ckpt_period and step % ckpt_period == 0) or step == steps)
            if ckpt is not None and (periodic or stopped):
                if mesh is None:
                    ckpt.save(step, model, optimizer, config=model.config,
                              args=saved_args, saver=saver)
                else:
                    ckpt.save(step, model, config=model.config,
                              args=saved_args,
                              weights=trainer.full_state_dict(),
                              sharded_optimizer=trainer.optimizer_state_tree(),
                              main=main)
            if stopped:
                logger(f"preemption checkpoint saved at step {step}; "
                       "stopping")
                break
            if periodic and on_checkpoint is not None:
                trainer.finish()        # evaluate the whole model
                on_checkpoint(step)
            t_last = time.perf_counter()
        if not stopped:
            trainer.finish()    # collective: only once every rank got here
    finally:
        trace.close()       # a loop that ended inside the window
        if preempt is not None:
            preempt.restore()
        close = getattr(batches, "close", None)
        if close is not None:
            close()
        if writer is not None:
            writer.close()
        model.eval()
        if saver is not None:
            saver.wait()    # last: re-raises the writer's error
    if stopped:
        logger("exiting cleanly after the preemption checkpoint")
        raise SystemExit(0)
    return history


def train_on_batches(model, loss_fn: LossFn, batches: Sequence[Mapping],
                     steps: int, *, learning_rate: float,
                     warmup_steps: int = 0, schedule: str = "linear",
                     weight_decay: float = 0.01,
                     max_grad_norm: Optional[float] = 1.0,
                     grad_accum: int = 1, seed: int = 0,
                     output_dir: Optional[str] = None, ckpt_period: int = 0,
                     keep: int = 3, log_period: int = 0,
                     logger=print) -> List[Dict[str, float]]:
    """`run_training` cycling over in-memory `batches` (dicts of arrays,
    moved to the model's device once). With `output_dir`, metrics go to
    `metrics.jsonl` there."""
    on_device = [batch_on(model.device, b) for b in batches]

    def source(start):
        return ((s, on_device[s % len(on_device)])
                for s in itertools.count(start))
    return run_training(
        model, loss_fn, source, steps, learning_rate=learning_rate,
        warmup_steps=warmup_steps, schedule=schedule,
        weight_decay=weight_decay, max_grad_norm=max_grad_norm,
        grad_accum=grad_accum, seed=seed, output_dir=output_dir,
        metrics_dir=output_dir, ckpt_period=ckpt_period, keep=keep,
        log_period=log_period, logger=logger)
