"""The detector: trunk -> anchor-free proposals -> NMS -> RoI-align -> RoI
head (2,048-d region features and tag classes). The JAX package's
`detection/detector.py` (`DetectorConfig`, `DetectorOutput`, `JaxDetector`
with `proposal_field`, `__call__` and `loss`) in PyTorch.

Its role is the reference's TorchScript VinVL detector (reference
`tools/img_feat_extract.py:71-74`: per image, boxes, tag class ids and
2,048-d features); its architecture is the JAX package's compact
single-stage design, not VinVL's:
- static shapes end to end: a fixed square canvas, a fixed pre-NMS top-K,
  at most `max_regions` regions with a validity mask (invalid slots zero);
- an anchor-free head: one objectness logit and four ltrb distances per
  stride-16 cell;
- greedy fixed-iteration NMS (`nms.py`), bilinear-gather RoI-align
  (`roi_align.py`), and an MLP RoI head to `feat_dim`.

Precision: `config.dtype` "bfloat16" runs the trunk, the proposal convs and
the RoI MLP in bf16 over fp32 weights, as the JAX `dtype=`; the objectness,
the box decode, RoI-align's samples and `cls_head` run in fp32 (the flax
`cls_head` has no `dtype`, and its input is cast to fp32).

The pooled RoI features are flattened channels-last, (p, p, c), as flax
flattens its NHWC pooling into `roi_fc1`'s rows: a JAX checkpoint's
`roi_fc1` loads as it is (`convert.detector_state_dict`).

Parameter names follow the flax tree: `trunk.*` (`backbone.py`),
`head_conv`, `obj_head`, `box_head`, `roi_fc1`, `roi_fc2`, `cls_head`.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Dense, resolve_device
from .backbone import Conv, GroupNorm, Trunk
from .nms import batched_nms
from .roi_align import batched_roi_align

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class DetectorConfig:
    canvas: int = 640                 # square input canvas (pixels)
    stride: int = 16
    stage_channels: Sequence[int] = (64, 128, 256)
    stage_blocks: Sequence[int] = (2, 2, 2)
    head_channels: int = 256
    num_classes: int = 1601           # VG-SGG-dicts vgoi6 label space
    feat_dim: int = 2048              # RoI feature width (the contract)
    pre_nms_topk: int = 256
    max_regions: int = 50
    nms_iou: float = 0.5
    score_threshold: float = 0.05
    roi_size: int = 7
    dtype: str = "float32"

    def to_dict(self):
        d = asdict(self)
        d["stage_channels"] = list(self.stage_channels)
        d["stage_blocks"] = list(self.stage_blocks)
        return d

    @classmethod
    def from_dict(cls, d):
        d = dict(d)
        d["stage_channels"] = tuple(d["stage_channels"])
        d["stage_blocks"] = tuple(d["stage_blocks"])
        return cls(**d)


class DetectorOutput(NamedTuple):
    boxes: torch.Tensor         # [B, N, 4] xyxy, canvas pixel coordinates
    scores: torch.Tensor        # [B, N] objectness (sigmoid)
    class_ids: torch.Tensor     # [B, N] argmax tag class
    class_logits: torch.Tensor  # [B, N, num_classes]
    feats: torch.Tensor         # [B, N, feat_dim]
    valid: torch.Tensor         # [B, N] bool


def _lecun_normal_(weight: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    """flax's default kernel init: a normal truncated at two deviations,
    scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    # inverse-CDF sampling of the truncated normal
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    weight.uniform_(2 * lo - 1, 1 - 2 * lo, generator=generator)
    weight.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)


class Detector(nn.Module):
    """The detector over images NHWC [B, canvas, canvas, 3] in [-1, 1].
    Weights are seeded (flax's default initialisers, drawn on the CPU from
    `seed`, so that every device gets the same ones), then moved to
    `device`: CUDA unless the caller asks for the CPU."""

    def __init__(self, config: DetectorConfig = DetectorConfig(), *,
                 device="cuda", seed: int = 0):
        super().__init__()
        self.config = config
        dt = DTYPES[config.dtype]
        c = config.stage_channels[-1]
        self.trunk = Trunk(config.stage_channels, config.stage_blocks, dt)
        self.head_conv = Conv(c, config.head_channels, 3, dtype=dt)
        self.obj_head = Conv(config.head_channels, 1, 3, dtype=dt)
        self.box_head = Conv(config.head_channels, 4, 3, dtype=dt)
        pooled = config.roi_size * config.roi_size * c
        self.roi_fc1 = Dense(pooled, config.feat_dim, dt)
        self.roi_fc2 = Dense(config.feat_dim, config.feat_dim, dt)
        self.cls_head = Dense(config.feat_dim, config.num_classes,
                              torch.float32)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (Conv, Dense)):
                    _lecun_normal_(m.weight, m.weight[0].numel(), gen)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, GroupNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.cls_head.weight.device

    # -- the dense proposal field ---------------------------------------

    def proposal_field(self, images
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """images [B, S, S, 3] -> (objectness logits [B, G, G] fp32, boxes
        [B, G, G, 4] fp32, the feature map [B, G, G, C]), G = S / stride;
        boxes are canvas xyxy decoded from ltrb distances (softplus, in
        stride units), clipped to the canvas."""
        cfg = self.config
        fmap = self.trunk(images)
        h = F.relu(self.head_conv(fmap.permute(0, 3, 1, 2)))
        obj = self.obj_head(h)[:, 0].float()
        ltrb = F.softplus(self.box_head(h).float()).permute(0, 2, 3, 1)
        g = fmap.shape[1]
        st = float(cfg.stride)
        centers = (torch.arange(g, dtype=torch.float32, device=obj.device)
                   + 0.5) * cfg.stride
        cy = centers[:, None]
        cx = centers[None, :]
        boxes = torch.stack([cx - ltrb[..., 0] * st, cy - ltrb[..., 1] * st,
                             cx + ltrb[..., 2] * st, cy + ltrb[..., 3] * st],
                            -1)
        return obj, boxes.clamp(0.0, float(cfg.canvas)), fmap

    # -- the pipeline's stages --------------------------------------------

    def top_proposals(self, obj, boxes) -> Tuple[torch.Tensor, torch.Tensor]:
        """The pre-NMS top-K of the field (K clamped to its size): (boxes
        [B, K, 4], sigmoid scores [B, K]), best first."""
        b = obj.shape[0]
        flat_obj = obj.reshape(b, -1)
        k = min(self.config.pre_nms_topk, flat_obj.shape[1])
        top_s, top_i = torch.topk(flat_obj, k, dim=1, sorted=True)
        top_boxes = boxes.reshape(b, -1, 4).gather(
            1, top_i[..., None].expand(b, k, 4))
        return top_boxes, torch.sigmoid(top_s)

    def select(self, top_boxes, probs):
        """NMS of each image -> (boxes [B, N, 4], scores [B, N], valid)."""
        cfg = self.config
        idx, valid = batched_nms(top_boxes, probs, cfg.max_regions,
                                 cfg.nms_iou, cfg.score_threshold)
        sel_boxes = top_boxes.gather(1, idx[..., None].expand(-1, -1, 4))
        return sel_boxes, probs.gather(1, idx), valid

    def pool(self, fmap, boxes) -> torch.Tensor:
        """RoI-align of boxes [B, N, 4] on the map -> [B, N, P, P, C]."""
        return batched_roi_align(fmap, boxes,
                                 output_size=self.config.roi_size,
                                 spatial_scale=1.0 / self.config.stride)

    def roi_head(self, pooled) -> Tuple[torch.Tensor, torch.Tensor]:
        """pooled [B, N, P, P, C] flattened channels-last -> (features
        [B, N, feat_dim] fp32, class logits [B, N, num_classes] fp32)."""
        b, n = pooled.shape[:2]
        h = F.relu(self.roi_fc1(pooled.reshape(b, n, -1)))
        feats = F.relu(self.roi_fc2(h)).float()
        return feats, self.cls_head(feats).float()

    def forward(self, images) -> DetectorOutput:
        obj, boxes, fmap = self.proposal_field(images)
        sel_boxes, sel_scores, valid = self.select(
            *self.top_proposals(obj, boxes))
        feats, logits = self.roi_head(self.pool(fmap, sel_boxes))
        vf = valid[..., None].float()
        return DetectorOutput(
            boxes=sel_boxes * vf, scores=sel_scores * valid,
            class_ids=logits.argmax(-1) * valid, class_logits=logits,
            feats=feats * vf, valid=valid)

    # -- the training loss (the synthetic corpus's and any real one's) ----

    def loss(self, images, gt_boxes, gt_classes, gt_valid):
        """Single-stage detection loss. gt_boxes [B, M, 4] canvas xyxy,
        gt_classes [B, M], gt_valid [B, M] -> (total, {obj_loss, box_loss,
        cls_loss}).

        Objectness: BCE, positives the cells whose center falls inside a gt
        box; box: L1 of the decoded corners against the owning gt's at the
        positives, in stride units; class: CE of the RoI head on the gt
        boxes (the smallest-area gt owns a cell, FCOS-style)."""
        cfg = self.config
        obj, boxes, fmap = self.proposal_field(images)
        g = obj.shape[1]
        st = float(cfg.stride)
        gt_valid = gt_valid.bool()
        centers = (torch.arange(g, dtype=torch.float32, device=obj.device)
                   + 0.5) * st
        cy = centers[:, None, None]                       # [g, 1, 1]
        cx = centers[None, :, None]                       # [1, g, 1]
        gx1, gy1, gx2, gy2 = (gt_boxes[:, None, None, :, i] for i in range(4))
        inside = ((cx[None] >= gx1) & (cx[None] <= gx2)
                  & (cy[None] >= gy1) & (cy[None] <= gy2)
                  & gt_valid[:, None, None, :])           # [B, g, g, M]
        area = ((gt_boxes[..., 2] - gt_boxes[..., 0])
                * (gt_boxes[..., 3] - gt_boxes[..., 1]))  # [B, M]
        inf = torch.full_like(area, float("inf"))
        area = torch.where(gt_valid, area, inf)
        pick_area = torch.where(inside, area[:, None, None, :],
                                float("inf"))
        owner = pick_area.argmin(dim=-1)                  # [B, g, g]
        pos = inside.any(-1)                              # [B, g, g]

        obj_tgt = pos.float()
        obj_loss = torch.mean(obj.clamp(min=0) - obj * obj_tgt
                              + torch.log1p(torch.exp(-obj.abs())))

        b, m = gt_boxes.shape[:2]
        own_box = gt_boxes.gather(
            1, owner.reshape(b, -1, 1).expand(-1, -1, 4)).reshape(
                b, g, g, 4)
        l1 = (boxes - own_box).abs().sum(-1) / st
        denom = pos.sum().clamp(min=1)
        box_loss = (l1 * pos).sum() / denom

        feats_logits = self.roi_head(self.pool(fmap, gt_boxes))[1]
        logp = torch.log_softmax(feats_logits, -1)
        nll = -logp.gather(-1, gt_classes.long().clamp(min=0)[..., None])[
            ..., 0]
        w = gt_valid.float()
        cls_loss = (nll * w).sum() / w.sum().clamp(min=1.0)

        total = obj_loss + box_loss + cls_loss
        return total, dict(obj_loss=obj_loss, box_loss=box_loss,
                           cls_loss=cls_loss)
