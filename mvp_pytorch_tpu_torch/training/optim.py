"""AdamW with warmup schedules, global-norm clipping and the no-decay mask.

The JAX package's `training/optim.py` builds
`optax.chain(clip_by_global_norm(max), adamw(schedule, mask=decay_mask))`,
optionally wrapped in `freeze_prefix_until`. `AdamW` here is the same update,
written out so that it matches optax step by step:

- the schedule is read at optax's count, which starts at 0: with warmup the
  first step's learning rate is 0;
- clipping scales every gradient by max / ||g|| when ||g|| >= max (optax's
  formula, no epsilon);
- Adam's moments and bias corrections are optax's `scale_by_adam`; weight
  decay is added to the update before the learning rate, for every parameter
  but a `bias` or anything with `norm` in its name (with `decay_mask=False`,
  for every parameter: `optax.adamw` without a mask);
- a frozen prefix has its gradients zeroed before clipping (its moments still
  decay) and its updates zeroed while the count is below `freeze_steps`.

`partition` (the Trainer's ZeRO-2 / FSDP / TP / pipeline layouts) makes each
parameter's update and moments cover only the tensor this rank updates (a
shard of it, or nothing for another pipe stage's layer), with the clipping
norm summed over the ranks: `step(grads)` then takes those tensors'
gradients.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: init -> end over `steps`, then end."""
    if steps <= 0:
        return lambda count: init

    def sched(count):
        c = min(max(count, 0), steps)
        return (init - end) * (1 - c / steps) + end
    return sched


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """optax.join_schedules with one boundary."""
    return lambda count: (first(count) if count < boundary
                          else second(count - boundary))


def warmup_linear(lr: float, warmup_steps: int, total_steps: int) -> Schedule:
    """Linear warmup, then linear decay to 0."""
    return _join(_linear(0.0, lr, max(warmup_steps, 1)),
                 _linear(lr, 0.0, max(total_steps - warmup_steps, 1)),
                 warmup_steps)


def warmup_constant(lr: float, warmup_steps: int) -> Schedule:
    """Linear warmup, then constant."""
    return _join(_linear(0.0, lr, max(warmup_steps, 1)), lambda count: lr,
                 warmup_steps)


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int) -> Schedule:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, max(total, warmup
    + 1), 0)."""
    decay_steps = max(total_steps, warmup_steps + 1) - warmup_steps

    def cosine(count):
        c = min(count, decay_steps)
        return lr * 0.5 * (1 + math.cos(math.pi * c / decay_steps))
    return _join(_linear(0.0, lr, warmup_steps), cosine, warmup_steps)


SCHEDULES = {
    "linear": warmup_linear,
    "constant": lambda lr, w, t: warmup_constant(lr, w),
    "cosine": warmup_cosine,
}


def no_decay(name: str) -> bool:
    """A `bias`, or anything under a norm, takes no weight decay (the
    reference's two parameter groups)."""
    parts = name.split(".")
    return parts[-1] == "bias" or any("norm" in p.lower() for p in parts)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, in fp32, on their device
    (no host sync)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.stack(norms).pow(2).sum().sqrt()


class AdamW:
    """Clip by global norm, then AdamW with a schedule and the decay mask,
    over `named_params`, reading each parameter's `.grad` (a missing grad
    counts as zeros). `max_grad_norm=None` clips nothing; `decay_mask=False`
    decays every parameter."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 schedule: Schedule, *, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.01,
                 max_grad_norm: Optional[float] = 1.0,
                 freeze_prefix: Optional[str] = None, freeze_steps: int = 0,
                 decay_mask: bool = True):
        self.names, self.params = zip(*named_params)
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.decay = [not (decay_mask and no_decay(n)) for n in self.names]
        self.in_prefix = [freeze_prefix is not None
                          and n.split(".")[0] == freeze_prefix
                          for n in self.names]
        self.freeze_steps = freeze_steps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.targets = list(self.params)
        self.active = list(range(len(self.params)))
        self.norm_weights = None
        self.norm_group = None

    def partition(self, targets, norm_weights, norm_group) -> None:
        """Update `targets[i]` (a view or shard of parameter i this rank
        owns, or None for one it does not) with moments of its shape. The
        clipping norm is sqrt(sum_i w_i ||g_i||^2) summed over `norm_group`,
        where w_i is 1 / (the number of ranks that hold the same tensor).
        Call before the first step or restore."""
        self.targets = list(targets)
        self.active = [i for i, t in enumerate(targets) if t is not None]
        empty = torch.empty(0)
        self.mu = [torch.zeros_like(t) if t is not None else empty
                   for t in targets]
        self.nu = [torch.zeros_like(t) if t is not None else empty
                   for t in targets]
        self.norm_weights = list(norm_weights)
        self.norm_group = norm_group

    def clip_norm(self, grads, idx) -> torch.Tensor:
        """The global norm of `grads` (those of parameters `idx`), summed
        over the ranks under a partition."""
        if self.norm_group is None:
            return global_norm(grads)
        sq = torch._foreach_norm([g.float() for g in grads])
        w = torch.tensor([self.norm_weights[i] for i in idx],
                         dtype=torch.float32, device=grads[0].device)
        total = (torch.stack(sq).pow(2) * w).sum()
        import torch.distributed as dist
        dist.all_reduce(total, group=self.norm_group)
        return total.sqrt()

    @torch.no_grad()
    def step(self, grads=None) -> None:
        """One update. Every operation is a multi-tensor (`_foreach_`) op on
        the device, in optax's order of roundings; nothing waits for the
        device (but the clipping norm's all-reduce under a partition).
        `grads` (one per parameter, the shape of its target; None counts as
        zeros) defaults to the parameters' `.grad`."""
        frozen = self.count < self.freeze_steps
        idx = self.active
        if grads is None:
            grads = [p.grad for p in self.params]
        targets = [self.targets[i] for i in idx]
        grads = [torch.zeros_like(t) if grads[i] is None
                 or (frozen and self.in_prefix[i]) else grads[i]
                 for t, i in zip(targets, idx)]
        mu = [self.mu[i] for i in idx]
        nu = [self.nu[i] for i in idx]
        if self.max_grad_norm is not None and self.max_grad_norm > 0:
            # optax: g where ||g|| < max, else (g / ||g||) * max
            g_norm = self.clip_norm(grads, idx)
            keep = g_norm < self.max_grad_norm
            one = torch.ones_like(g_norm)
            grads = torch._foreach_div(grads, torch.where(keep, one, g_norm))
            torch._foreach_mul_(grads, torch.where(
                keep, one, torch.full_like(g_norm, self.max_grad_norm)))
        count = np.float32(self.count + 1)
        # optax takes the bias corrections in fp32
        bc1 = float(np.float32(1) - np.float32(self.b1) ** count)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** count)
        # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - self.b1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, sq)
        del sq, grads
        # u = (mu / bc1) / (sqrt(nu / bc2) + eps) [+ wd p], then p += -lr u
        u = torch._foreach_div(mu, bc1)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(u, denom)
        del denom
        decay = [j for j, i in enumerate(idx) if self.decay[i]]
        if decay and self.weight_decay:
            torch._foreach_add_(
                [u[j] for j in decay],
                torch._foreach_mul([targets[j] for j in decay],
                                   self.weight_decay))
        live = [j for j, i in enumerate(idx)
                if not (frozen and self.in_prefix[i])]
        torch._foreach_mul_(u, -self.schedule(self.count))
        torch._foreach_add_([targets[j] for j in live], [u[j] for j in live])
        self.count += 1

    def state_dict(self) -> Dict:
        """The count and the moments of the active parameters (their local
        shards under a partition)."""
        return {"count": self.count,
                "mu": {self.names[i]: self.mu[i] for i in self.active},
                "nu": {self.names[i]: self.nu[i] for i in self.active}}

    def load_state_dict(self, state: Dict) -> None:
        """The inverse of `state_dict`: moments of the targets' shapes."""
        self.count = int(state["count"])
        for i in self.active:
            n, t = self.names[i], self.targets[i]
            for key, moments in (("mu", self.mu), ("nu", self.nu)):
                v = torch.as_tensor(state[key][n])
                if tuple(v.shape) != tuple(t.shape):
                    raise ValueError(f"{key}[{n}] of shape {tuple(v.shape)} "
                                     f"for a target of {tuple(t.shape)}")
                moments[i] = v.to(t.device, t.dtype).clone()


def make_optimizer(model: torch.nn.Module, lr: float, *,
                   warmup_steps: int = 0, total_steps: int = 0,
                   schedule: str = "linear", weight_decay: float = 0.01,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   max_grad_norm: Optional[float] = 1.0,
                   freeze_prefix: Optional[str] = None,
                   freeze_steps: int = 0) -> AdamW:
    """The JAX package's `make_optimizer` (with `freeze_prefix_until` when
    `freeze_prefix` is given) over the model's parameters."""
    return AdamW(model.named_parameters(),
                 SCHEDULES[schedule](lr, warmup_steps, total_steps),
                 b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                 max_grad_norm=max_grad_norm, freeze_prefix=freeze_prefix,
                 freeze_steps=freeze_steps)
