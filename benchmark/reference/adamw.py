"""Plain AdamW (Loshchilov and Hutter) as the program's trainer configures
it: gradients clipped to a global norm (scaled by max / norm when the norm
reaches max), Adam's moments with bias correction, decoupled weight decay
added to the update for every parameter but biases and LayerNorm
parameters, and a constant learning rate."""

from __future__ import annotations

from typing import Dict

import torch


def decays(name: str) -> bool:
    parts = name.split(".")
    return not (parts[-1] == "bias" or any("norm" in p.lower()
                                           for p in parts))


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float, *,
                 b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
                 max_grad_norm=1.0):
        self.p = params
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd, self.max_norm = weight_decay, max_grad_norm
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
        scale = 1.0 if float(norm) < self.max_norm else self.max_norm / norm
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for k, p in self.p.items():
            g = grads[k] * scale
            self.mu[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.nu[k].mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            u = (self.mu[k] / bc1) / ((self.nu[k] / bc2).sqrt() + self.eps)
            if self.wd and decays(k):
                u = u + self.wd * p
            p.add_(u, alpha=-self.lr)
