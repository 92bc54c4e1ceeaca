"""Fixed-shape masked and span ops, the JAX package's `ops/masked.py` in
PyTorch.

- `gather_masked_positions`: up to `max_pred` labelled positions per example,
  labelled ones first in their original order.
- `masked_cross_entropy`: ignore-index cross entropy as a weighted mean.
- `cross_entropy`: mean cross entropy where an out-of-range label counts 0.
- `gather_span`: a [start, end) span per example into a fixed-width buffer
  with a validity mask; positions past the span or past L are masked out.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def gather_masked_positions(hidden: torch.Tensor, labels: torch.Tensor,
                            max_pred: int
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """hidden [B, L, H], labels [B, L] with -1 = unlabelled -> (gathered
    [B, P, H], labels [B, P] padded with -1, weights [B, P] float 0/1)."""
    l = hidden.shape[1]
    pos = torch.arange(l, device=hidden.device)[None, :]
    rank = torch.where(labels >= 0, pos, pos + l)
    order = torch.argsort(rank, dim=1)[:, :max_pred]
    gathered = hidden.gather(
        1, order[..., None].expand(-1, -1, hidden.shape[-1]))
    glabels = labels.gather(1, order)
    return gathered, glabels, (glabels >= 0).float()


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-log_softmax(logits)[label] in fp32, labels clipped into range."""
    v = logits.shape[-1]
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.clamp(0, v - 1).long()[..., None])[..., 0]


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """Mean CE over positions with weight > 0; labels >= V count as
    unlabelled. 0 when nothing is labelled."""
    weights = weights * (labels < logits.shape[-1])
    total = (_nll(logits, labels) * weights).sum()
    denom = weights.sum()
    return torch.where(denom > 0, total / denom.clamp(min=1.0),
                       torch.zeros_like(total))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE with integer labels; an out-of-range label contributes 0."""
    ok = (labels >= 0) & (labels < logits.shape[-1])
    nll = _nll(logits, labels)
    return torch.where(ok, nll, torch.zeros_like(nll)).mean()


def gather_span(seq: torch.Tensor, span: torch.Tensor, width: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """seq[i, span[i, 0]:span[i, 1]] into [B, width, H] -> (tokens, valid
    [B, width] float 0/1). Masked positions are gathered from index 0."""
    l = seq.shape[1]
    idx = span[:, :1] + torch.arange(width, device=seq.device)[None, :]
    valid = (idx < span[:, 1:2]) & (idx < l)
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    toks = seq.gather(1, idx[..., None].expand(-1, -1, seq.shape[-1]))
    return toks, valid.float()
