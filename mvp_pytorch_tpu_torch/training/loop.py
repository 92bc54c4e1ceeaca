"""Training over in-memory batches: the JAX package's `tasks/common.py`
`TrainLoop.run` without the dataset plumbing, shared by the retrieval and
pretraining tasks.

`train_on_batches` runs a `Trainer` with `make_optimizer`'s AdamW for `steps`
steps, cycling over the batches, logs the metrics and, with `output_dir`,
writes `metrics.jsonl`, saves a checkpoint every `ckpt_period` steps and after
the last, and resumes from the newest checkpoint found there.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .checkpoint import CheckpointManager
from .metrics import MetricLogger, MetricsWriter
from .optim import make_optimizer
from .trainer import LossFn, Trainer


def batch_on(device, batch: Mapping, keys=None) -> Dict[str, torch.Tensor]:
    """The batch's arrays (numpy or tensors), or only `keys`, as tensors on
    `device`."""
    out = {}
    for k in (batch if keys is None else keys):
        v = batch[k]
        out[k] = (v if isinstance(v, torch.Tensor)
                  else torch.from_numpy(np.asarray(v))).to(device)
    return out


def train_on_batches(model, loss_fn: LossFn, batches: Sequence[Mapping],
                     steps: int, *, learning_rate: float,
                     warmup_steps: int = 0, schedule: str = "linear",
                     weight_decay: float = 0.01,
                     max_grad_norm: Optional[float] = 1.0,
                     grad_accum: int = 1, seed: int = 0,
                     output_dir: Optional[str] = None, ckpt_period: int = 0,
                     keep: int = 3, log_period: int = 0,
                     logger=print) -> List[Dict[str, float]]:
    """Train `model` with `loss_fn` for `steps` steps, cycling over
    `batches` (dicts of arrays, moved to the model's device here). Returns
    each step's metrics; the model is left in eval mode."""
    batches = [batch_on(model.device, b) for b in batches]
    optimizer = make_optimizer(
        model, learning_rate, warmup_steps=warmup_steps, total_steps=steps,
        schedule=schedule, weight_decay=weight_decay,
        max_grad_norm=max_grad_norm)
    trainer = Trainer(model, loss_fn, optimizer, grad_accum=grad_accum,
                      seed=seed)
    ckpt = writer = None
    if output_dir is not None:
        ckpt = CheckpointManager(output_dir, keep=keep)
        writer = MetricsWriter(output_dir)
        latest = ckpt.latest()
        if latest is not None:
            meta = ckpt.restore(latest[1], model, optimizer)
            trainer.step_count = int(meta.get("step", latest[0]))
    meter, history = MetricLogger(), []
    try:
        while trainer.step_count < steps:
            metrics = trainer.step(
                batches[trainer.step_count % len(batches)])
            step = trainer.step_count
            history.append(metrics)
            meter.update(**metrics)
            if writer is not None:
                writer.write(step, metrics)
            if log_period and step % log_period == 0:
                logger(f"step {step}  {meter}")
            if ckpt is not None and ((ckpt_period and step % ckpt_period == 0)
                                     or step == steps):
                ckpt.save(step, model, optimizer, config=model.config)
    finally:
        if writer is not None:
            writer.close()
        model.eval()
    return history
