"""Single-device trainer: the JAX package's `training/trainer.py` step
without the mesh, ZeRO, tensor and pipeline parallelism.

The loss_fn contract: loss_fn(model, batch, generator) -> (loss, metrics),
where `batch` maps names to tensors with the batch first and `generator` is a
`torch.Generator` on the model's device, derived from (seed, step, micro
batch), from which every random draw of the step comes. A loss_fn with a
`step` parameter is called loss_fn(model, batch, generator, step), `step`
being the number of optimizer steps taken before this one (the JAX package's
extended contract, for schedules such as VQA's kl -> bce switch). Gradients
land on the model's fp32 master parameters; the model computes in its
config's dtype.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from .optim import AdamW, global_norm

LossFn = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def takes_step(loss_fn: LossFn) -> bool:
    """Whether `loss_fn` has a `step` parameter."""
    try:
        return "step" in inspect.signature(loss_fn).parameters
    except (TypeError, ValueError):
        return False


class Trainer:
    def __init__(self, model: torch.nn.Module, loss_fn: LossFn,
                 optimizer: AdamW, *, grad_accum: int = 1, seed: int = 0):
        self.model = model
        self.loss_fn = loss_fn
        self.loss_takes_step = takes_step(loss_fn)
        self.optimizer = optimizer
        self.grad_accum = max(1, grad_accum)
        self.seed = seed
        self.step_count = 0
        self.device = next(model.parameters()).device

    def generator(self, step: int, micro: int = 0) -> torch.Generator:
        seed = np.random.SeedSequence([self.seed, step, micro])
        return torch.Generator(device=self.device).manual_seed(
            int(seed.generate_state(1, np.uint64)[0] >> np.uint64(1)))

    def step(self, batch: Mapping[str, torch.Tensor]) -> Dict[str, float]:
        """One optimizer step over `batch`, split into `grad_accum` micro
        batches (each array into equal shares of its rows) whose gradients,
        loss and metrics are averaged. Returns the
        metrics, the loss and the global norm of the unclipped gradients."""
        self.model.train()
        params = list(self.model.parameters())
        for p in params:
            p.grad = None
        n = self.grad_accum
        sizes = {v.shape[0] for v in batch.values()}
        if any(size % n for size in sizes):
            raise ValueError(f"batch sizes {sorted(sizes)} are not divisible "
                             f"by grad_accum {n}")
        loss_sum, metric_sums = 0.0, {}
        for i in range(n):
            # each array gives its own i-th share of rows: a batch may hold
            # sub-batches of different sizes (the pretraining extra stream)
            mb = batch if n == 1 else {
                k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
                for k, v in batch.items()}
            gen = self.generator(self.step_count, i)
            loss, metrics = (
                self.loss_fn(self.model, mb, gen, self.step_count)
                if self.loss_takes_step else self.loss_fn(self.model, mb, gen))
            loss.backward()
            loss_sum = loss_sum + loss.detach()
            for k, v in metrics.items():
                metric_sums[k] = metric_sums.get(k, 0.0) + v.detach()
        if n > 1:
            for p in params:
                if p.grad is not None:
                    p.grad.mul_(1.0 / n)
            loss_sum = loss_sum * (1.0 / n)
            metric_sums = {k: v * (1.0 / n) for k, v in metric_sums.items()}
        gnorm = global_norm(p.grad for p in params if p.grad is not None)
        self.optimizer.step()
        self.step_count += 1
        out = {k: float(v) for k, v in metric_sums.items()}
        out.update(loss=float(loss_sum), grad_norm=float(gnorm))
        return out
