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
  but a `bias` or anything with `norm` in its name;
- a frozen prefix has its gradients zeroed before clipping (its moments still
  decay) and its updates zeroed while the count is below `freeze_steps`.
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
    counts as zeros)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 schedule: Schedule, *, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.01,
                 max_grad_norm: Optional[float] = 1.0,
                 freeze_prefix: Optional[str] = None, freeze_steps: int = 0):
        self.names, self.params = zip(*named_params)
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.decay = [not no_decay(n) for n in self.names]
        self.in_prefix = [freeze_prefix is not None
                          and n.split(".")[0] == freeze_prefix
                          for n in self.names]
        self.freeze_steps = freeze_steps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        """One update. Every operation is a multi-tensor (`_foreach_`) op on
        the device, in optax's order of roundings; nothing waits for the
        device."""
        frozen = self.count < self.freeze_steps
        grads = [torch.zeros_like(p) if p.grad is None or (frozen and masked)
                 else p.grad for p, masked in zip(self.params, self.in_prefix)]
        if self.max_grad_norm is not None and self.max_grad_norm > 0:
            # optax: g where ||g|| < max, else (g / ||g||) * max
            g_norm = global_norm(grads)
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
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - self.b1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - self.b2)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(self.nu, sq)
        del sq, grads
        # u = (mu / bc1) / (sqrt(nu / bc2) + eps) [+ wd p], then p += -lr u
        u = torch._foreach_div(self.mu, bc1)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(u, denom)
        del denom
        decay = [i for i, d in enumerate(self.decay) if d]
        if decay and self.weight_decay:
            torch._foreach_add_(
                [u[i] for i in decay],
                torch._foreach_mul([self.params[i] for i in decay],
                                   self.weight_decay))
        live = [i for i, m in enumerate(self.in_prefix)
                if not (frozen and m)]
        torch._foreach_mul_(u, -self.schedule(self.count))
        torch._foreach_add_([self.params[i] for i in live],
                            [u[i] for i in live])
        self.count += 1

    def state_dict(self) -> Dict:
        return {"count": self.count,
                "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        for i, (n, p) in enumerate(zip(self.names, self.params)):
            self.mu[i] = state["mu"][n].to(p.device, p.dtype)
            self.nu[i] = state["nu"][n].to(p.device, p.dtype)


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
