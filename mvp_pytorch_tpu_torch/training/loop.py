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
this one's, so that checkpoints and logging count too).
`train_on_batches` runs it over in-memory batches.

With a `mesh` every rank runs it over its own batches: the Trainer steps as
one rank (`training/trainer.py`), rank 0 alone logs and writes the metrics
and the checkpoint's whole weights, every rank writes its pieces of the
optimizer state into the checkpoint's `opt_shards/`
(`training/sharded_checkpoint.py`), and a resume cuts whatever topology
wrote the checkpoint to its own. At the end the model is whole on every
rank (each pipe stage's layers from their owner, FSDP shards gathered).
"""

from __future__ import annotations

import itertools
import time
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from .checkpoint import CheckpointManager
from .metrics import MetricLogger, MetricsWriter
from .optim import make_optimizer
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
                 pipeline_microbatches: int = 4
                 ) -> List[Dict[str, float]]:
    """Train `model` with `loss_fn` for `steps` steps over `source`. Returns
    each step's metrics; the model is left in eval mode.

    `saved_args` goes into each checkpoint as `training_args.json`;
    `on_checkpoint(step)` runs after each save; `timing()` adds the batch's
    loader timings to the step's metrics. The parameters under
    `freeze_prefix` take no update for the first `freeze_steps` steps."""
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
    meter, history = MetricLogger(), []
    batches = iter(source(trainer.step_count))
    try:
        t_end = t_last = time.perf_counter()
        while trainer.step_count < steps:
            got, batch = next(batches)
            if got != trainer.step_count:
                raise RuntimeError(f"batch of step {got} at step "
                                   f"{trainer.step_count}")
            data_ms = (time.perf_counter() - t_last) * 1e3
            metrics = trainer.step(batch)       # ends in a device sync
            now = time.perf_counter()
            metrics.update(data_ms=data_ms, step_ms=(now - t_end) * 1e3)
            t_end = now
            if timing is not None:
                metrics.update(timing())
            step = trainer.step_count
            history.append(metrics)
            meter.update(**metrics)
            if writer is not None:
                writer.write(step, metrics)
            if log_period and step % log_period == 0 and main:
                logger(f"step {step}/{steps}  {meter}")
            if ckpt is not None and ((ckpt_period and step % ckpt_period == 0)
                                     or step == steps):
                if mesh is None:
                    ckpt.save(step, model, optimizer, config=model.config,
                              args=saved_args)
                else:
                    ckpt.save(step, model, config=model.config,
                              args=saved_args,
                              weights=trainer.full_state_dict(),
                              sharded_optimizer=trainer.optimizer_state_tree(),
                              main=main)
                if on_checkpoint is not None:
                    trainer.finish()        # evaluate the whole model
                    on_checkpoint(step)
            t_last = time.perf_counter()
        trainer.finish()        # collective: only once every rank got here
    finally:
        close = getattr(batches, "close", None)
        if close is not None:
            close()
        if writer is not None:
            writer.close()
        model.eval()
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
