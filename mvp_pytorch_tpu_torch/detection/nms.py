"""Fixed-shape IoU and greedy NMS: the JAX package's `detection/nms.py`.

The reference runs NMS inside its TorchScript VinVL graph. Here greedy NMS
over K pre-selected proposals, keeping at most `max_out`, is a K x K IoU
matrix and a loop of exactly `max_out` iterations over the whole batch at
once: static shapes, and no host sync inside the loop. An invalid slot holds
index 0; `argmax` takes the first of equal scores, as `jnp.argmax` does.
"""

from __future__ import annotations

from typing import Tuple

import torch


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU between xyxy boxes a [..., M, 4] and b [..., N, 4] -> [..., M, N]
    (0 where the union is empty)."""
    area_a = ((a[..., 2] - a[..., 0]).clamp(min=0)
              * (a[..., 3] - a[..., 1]).clamp(min=0))
    area_b = ((b[..., 2] - b[..., 0]).clamp(min=0)
              * (b[..., 3] - b[..., 1]).clamp(min=0))
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
                iou_threshold: float = 0.5, score_threshold: float = 0.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of each image: boxes [B, K, 4], scores [B, K] ->
    (indices [B, max_out] int64, valid [B, max_out] bool). Each iteration
    takes the best live score, then suppresses it and every box overlapping
    it at IoU >= iou_threshold; a box starts live when its score exceeds
    score_threshold."""
    b, k = scores.shape
    iou = box_iou(boxes, boxes)                            # [B, K, K]
    live = scores > score_threshold
    neg_inf = torch.full_like(scores, float("-inf"))
    arange = torch.arange(k, device=scores.device)[None]
    sel_idx, sel_valid = [], []
    for _ in range(max_out):
        s = torch.where(live, scores, neg_inf)
        best = s.argmax(dim=1)                             # [B]
        ok = s.gather(1, best[:, None])[:, 0] > float("-inf")
        sel_idx.append(torch.where(ok, best, torch.zeros_like(best)))
        sel_valid.append(ok)
        row = iou.gather(1, best[:, None, None].expand(b, 1, k))[:, 0]
        suppress = (row >= iou_threshold) | (arange == best[:, None])
        live = live & (~suppress | ~ok[:, None])
    return torch.stack(sel_idx, 1), torch.stack(sel_valid, 1)


def nms(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
        iou_threshold: float = 0.5, score_threshold: float = 0.0
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over [K, 4] boxes -> (indices [max_out], valid
    [max_out])."""
    idx, valid = batched_nms(boxes[None], scores[None], max_out,
                             iou_threshold, score_threshold)
    return idx[0], valid[0]
