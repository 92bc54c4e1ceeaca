"""The detection front-end: raw image -> (boxes, tags, 2,048-d RoI features)
-> 2,054-d region features (the 2,048 and the normalised x1 y1 x2 y2 w h),
the contract of the reference's TorchScript VinVL detector
(`tools/img_feat_extract.py:71-74`, `oscar/modeling/modeling_pipeline.py:32`).

The JAX package's `detection/` in PyTorch: static shapes throughout (a fixed
canvas, a fixed pre-NMS top-K, at most `max_regions` regions with a validity
mask). Nothing here imports PIL until an image file is decoded.
"""

from .detector import Detector, DetectorConfig, DetectorOutput
from .frontend import (DetectionFrontend, load_detector, load_frontend,
                       save_detector)
from .nms import batched_nms, box_iou, nms
from .roi_align import batched_roi_align, roi_align

__all__ = [
    "Detector", "DetectorConfig", "DetectorOutput", "DetectionFrontend",
    "load_detector", "load_frontend", "save_detector", "batched_nms",
    "box_iou", "nms", "batched_roi_align", "roi_align",
]
