"""Prediction heads. This slice carries `ClassifierHead` only."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import Dense, compute_dtype, init_weights


class ClassifierHead(nn.Module):
    """Linear or MLP classifier over the pooled output, logits in fp32
    (reference modeling_vlbert.py:1730-1744, `cls_hidden_scale` widening).

    State-dict keys are the reference's: `weight`/`bias` for the linear head
    (an nn.Linear there), `0.*` and `2.*` for the MLP (an nn.Sequential)."""

    def __init__(self, config: ModelConfig, num_labels: Optional[int] = None):
        super().__init__()
        self.compute_dtype = compute_dtype(config)
        n = num_labels if num_labels is not None else config.num_labels
        h = config.hidden_size
        self.mlp = config.classifier == "mlp"
        if self.mlp:
            wide = h * config.cls_hidden_scale
            self.add_module("0", Dense(h, wide, self.compute_dtype))
            self.add_module("1", nn.ReLU())
            self.add_module("2", Dense(wide, n, self.compute_dtype))
        else:
            self.weight = nn.Parameter(torch.empty(n, h))
            self.bias = nn.Parameter(torch.zeros(n))

    @torch.no_grad()
    def init_weights(self, std: float, generator: torch.Generator) -> None:
        if self.mlp:
            init_weights(self, std, generator)
        else:
            self.weight.normal_(0.0, std, generator=generator)
            self.bias.zero_()

    def forward(self, pooled):
        if self.mlp:
            out = self._modules["2"](torch.relu(self._modules["0"](pooled)))
        else:
            dt = self.compute_dtype
            out = F.linear(pooled.to(dt), self.weight.to(dt), self.bias.to(dt))
        return out.float()
