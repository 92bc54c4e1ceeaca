"""The synthetic detection corpus, its training loop and mAP@0.5: the JAX
package's `detection/synthetic_boxes.py` on the port's detector.

Coloured rectangles on noise, the class being the colour, so that
objectness, box regression and classification all learn from scratch: the
front-end's check that gradients flow and the stage learns (the reference
ships weights that are not here). `COLORS`, `make_batch`, `map50` and its
IoU are the JAX package's numpy, copied; the same seed gives the same
images.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..training.optim import AdamW
from .detector import Detector, DetectorConfig

COLORS = np.asarray([
    [0.9, 0.1, 0.1], [0.1, 0.9, 0.1], [0.1, 0.1, 0.9],
    [0.9, 0.9, 0.1], [0.1, 0.9, 0.9], [0.9, 0.1, 0.9],
], np.float32)


def make_batch(rng: np.random.RandomState, batch: int, canvas: int,
               max_boxes: int = 4) -> Dict[str, np.ndarray]:
    """Images in [-1, 1] with 1..max_boxes coloured rectangles."""
    imgs = rng.randn(batch, canvas, canvas, 3).astype(np.float32) * 0.05
    boxes = np.zeros((batch, max_boxes, 4), np.float32)
    classes = np.zeros((batch, max_boxes), np.int32)
    valid = np.zeros((batch, max_boxes), bool)
    for b in range(batch):
        n = rng.randint(1, max_boxes + 1)
        for i in range(n):
            w = rng.randint(canvas // 8, canvas // 2)
            h = rng.randint(canvas // 8, canvas // 2)
            x1 = rng.randint(0, canvas - w)
            y1 = rng.randint(0, canvas - h)
            c = rng.randint(len(COLORS))
            imgs[b, y1:y1 + h, x1:x1 + w] = (
                COLORS[c] - 0.5) * 2.0 + rng.randn(h, w, 3) * 0.02
            boxes[b, i] = [x1, y1, x1 + w, y1 + h]
            classes[b, i] = c
            valid[b, i] = True
    return dict(images=imgs, gt_boxes=boxes, gt_classes=classes,
                gt_valid=valid)


def train_detector(config: Optional[DetectorConfig] = None, steps: int = 60,
                   batch: int = 4, lr: float = 3e-4, seed: int = 0,
                   log_every: int = 0, logger=None, device="cuda"
                   ) -> Tuple[DetectorConfig, Detector, List[float]]:
    """Train a Detector (seeded from `seed`) on the synthetic corpus with
    `optax.adam(lr)`'s update (a constant rate, no weight decay, no
    clipping) -> (config, model, loss history). The default config is the
    JAX package's small one. The first batch drawn only advances the
    stream, as the JAX loop draws it for its init."""
    config = config or DetectorConfig(
        canvas=128, num_classes=len(COLORS), pre_nms_topk=64, max_regions=8,
        stage_channels=(64, 64, 64), stage_blocks=(1, 1, 1),
        head_channels=64, feat_dim=256)
    model = Detector(config, device=device, seed=seed)
    model.train()
    rng = np.random.RandomState(seed)
    make_batch(rng, batch, config.canvas)
    opt = AdamW(model.named_parameters(), lambda count: lr, weight_decay=0.0,
                max_grad_norm=None)
    history = []
    for i in range(steps):
        data = {k: torch.from_numpy(v).to(model.device)
                for k, v in make_batch(rng, batch, config.canvas).items()}
        model.zero_grad(set_to_none=True)
        loss, aux = model.loss(data["images"], data["gt_boxes"],
                               data["gt_classes"], data["gt_valid"])
        loss.backward()
        opt.step()
        history.append(loss.item())
        if log_every and (i + 1) % log_every == 0 and logger:
            logger.info(f"det step {i+1}/{steps} loss={history[-1]:.4f} "
                        + " ".join(f"{k}={v.item():.3f}"
                                   for k, v in aux.items()))
    model.eval()
    return config, model, history


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N,4] x [M,4] xyxy IoU."""
    area_a = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(
        a[:, 3] - a[:, 1], 0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(
        b[:, 3] - b[:, 1], 0)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def map50(detections, ground_truths, num_classes: int,
          iou_thresh: float = 0.5) -> float:
    """VOC2010-style (all-point interpolated) mean AP at IoU 0.5.

    detections: per image, dict(boxes [N,4], scores [N], classes [N]);
    ground_truths: per image, dict(boxes [M,4], classes [M]). Greedy
    per-class matching in score order, one match per gt box.
    """
    aps = []
    for c in range(num_classes):
        recs = []          # (score, is_tp) across all images
        n_gt = 0
        for det, gt in zip(detections, ground_truths):
            g_mask = gt["classes"] == c
            g_boxes = gt["boxes"][g_mask]
            n_gt += len(g_boxes)
            d_mask = det["classes"] == c
            d_boxes = det["boxes"][d_mask]
            d_scores = det["scores"][d_mask]
            if len(d_boxes) == 0:
                continue
            order = np.argsort(-d_scores)
            taken = np.zeros(len(g_boxes), bool)
            ious = (_iou_matrix(d_boxes, g_boxes)
                    if len(g_boxes) else np.zeros((len(d_boxes), 0)))
            for i in order:
                tp = False
                if ious.shape[1]:
                    j = int(np.argmax(np.where(taken, -1.0, ious[i])))
                    if not taken[j] and ious[i, j] >= iou_thresh:
                        taken[j] = True
                        tp = True
                recs.append((float(d_scores[i]), tp))
        if n_gt == 0:
            continue
        if not recs:
            aps.append(0.0)
            continue
        recs.sort(key=lambda x: -x[0])
        tps = np.cumsum([r[1] for r in recs])
        fps = np.cumsum([not r[1] for r in recs])
        recall = tps / n_gt
        precision = tps / np.maximum(tps + fps, 1)
        # all-point interpolation: the precision envelope over recall
        mrec = np.concatenate([[0.0], recall, [recall[-1]]])
        mpre = np.concatenate([[0.0], precision, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        aps.append(float(np.sum((mrec[idx + 1] - mrec[idx])
                                * mpre[idx + 1])))
    return float(np.mean(aps)) if aps else 0.0


@torch.no_grad()
def evaluate_map50(config: DetectorConfig, model: Detector,
                   n_images: int = 32, seed: int = 99,
                   score_thresh: float = 0.05) -> float:
    """Held-out synthetic mAP@0.5 of a trained Detector (batches of 4, the
    JAX package's stream)."""
    model.eval()
    rng = np.random.RandomState(seed)
    dets, gts = [], []
    bs = 4
    for _ in range(0, n_images, bs):
        data = make_batch(rng, bs, config.canvas)
        out = model(torch.from_numpy(data["images"]).to(model.device))
        boxes = out.boxes.cpu().numpy()
        scores = out.scores.cpu().numpy()
        cls = out.class_logits.argmax(-1).cpu().numpy()
        valid = out.valid.cpu().numpy()
        for b in range(bs):
            keep = valid[b] & (scores[b] >= score_thresh)
            dets.append(dict(boxes=boxes[b][keep], scores=scores[b][keep],
                             classes=cls[b][keep]))
            gv = data["gt_valid"][b]
            gts.append(dict(boxes=data["gt_boxes"][b][gv],
                            classes=data["gt_classes"][b][gv]))
    return map50(dets, gts, num_classes=config.num_classes)
