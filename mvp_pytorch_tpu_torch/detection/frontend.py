"""Raw image -> 2,054-d region features: the JAX package's
`detection/frontend.py` on the port's detector.

The pipeline's detector contract (reference
`oscar/modeling/modeling_pipeline.py:66-88`, `tools/img_feat_extract.py`):
`frontend(img_path) -> (features [N, 2054] float32, tags [N])`, features =
[the 2,048-d RoI feature ; x1 y1 x2 y2 w h normalised].

Preprocessing: the longest side resized to the canvas, padded bottom and
right, pixels scaled to [-1, 1]. Boxes come back normalised by the resized,
unpadded extent (the reference tool's geometry, img_feat_extract.py:96-110).
PIL is imported only where an image file is decoded.

A checkpoint directory holds `detector_config.json` (the JAX package's JSON)
and `detector.pt`, the detector's state dict. A JAX checkpoint
(`detector.msgpack`) is carried over with `convert.detector_state_dict`
where both packages are installed.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .detector import Detector, DetectorConfig, DetectorOutput

WEIGHTS_NAME = "detector.pt"
CONFIG_NAME = "detector_config.json"


def preprocess_image(img, canvas: int) -> Tuple[np.ndarray, int, int]:
    """PIL image -> ([canvas, canvas, 3] float32 in [-1, 1], new_w, new_h)."""
    w, h = img.size
    scale = canvas / max(w, h)
    nw, nh = max(1, int(round(w * scale))), max(1, int(round(h * scale)))
    # convert first: PIL resamples a palette image by NEAREST, and would
    # resize an RGBA alpha only to drop it
    img = img.convert("RGB").resize((nw, nh))
    x = np.asarray(img, np.float32) / 255.0
    out = np.zeros((canvas, canvas, 3), np.float32)
    out[:nh, :nw] = x
    return (out - 0.5) / 0.5, nw, nh


def default_label_map(num_classes: int) -> Dict[int, str]:
    return {i: f"class_{i}" for i in range(num_classes)}


def load_label_map(path: str) -> Dict[int, str]:
    """VG-SGG-dicts contract: {"label_to_idx": {name: idx}} (reference
    tools/img_feat_extract.py's label map), or {idx: name}."""
    with open(path) as f:
        d = json.load(f)
    if "label_to_idx" in d:
        return {int(v): k for k, v in d["label_to_idx"].items()}
    return {int(k): v for k, v in d.items()}


def save_detector(out_dir: str, config: DetectorConfig,
                  model: torch.nn.Module) -> None:
    """`detector_config.json` and `detector.pt` (the state dict, on the
    CPU) into `out_dir`."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, CONFIG_NAME), "w") as f:
        json.dump(config.to_dict(), f, indent=1)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               os.path.join(out_dir, WEIGHTS_NAME))


def load_detector(ckpt_dir: str, device="cuda") -> Detector:
    """The detector of a checkpoint directory on `device`; a missing
    weights file raises (no fallback to seeded weights)."""
    wpath = os.path.join(ckpt_dir, WEIGHTS_NAME)
    if not os.path.exists(wpath):
        raise FileNotFoundError(
            f"detector checkpoint {wpath} not found: an explicit checkpoint "
            f"directory never falls back to random weights")
    with open(os.path.join(ckpt_dir, CONFIG_NAME)) as f:
        config = DetectorConfig.from_dict(json.load(f))
    model = Detector(config, device=device)
    model.load_state_dict(torch.load(wpath, map_location=model.device,
                                     weights_only=True))
    return model


def host_output(out: DetectorOutput) -> DetectorOutput:
    """A `DetectorOutput` copied to numpy arrays on the host."""
    return DetectorOutput(*(x.detach().cpu().numpy() if
                            isinstance(x, torch.Tensor) else np.asarray(x)
                            for x in out))


class DetectionFrontend:
    """The callable detector backend (img_path -> (features, tags)).

    `ckpt_dir` loads trained weights; without one the detector is seeded
    from `seed` (the architecture, contract and latency run; tags are then
    placeholder classes). `label_map` names the classes (a VG-SGG-dicts
    json), else `class_<i>`. Runs on CUDA unless `device="cpu"`."""

    def __init__(self, ckpt_dir: Optional[str] = None,
                 config: Optional[DetectorConfig] = None,
                 label_map: Optional[str] = None, seed: int = 0,
                 device="cuda"):
        if ckpt_dir:
            self.model = load_detector(ckpt_dir, device)
        else:
            self.model = Detector(config or DetectorConfig(), device=device,
                                  seed=seed)
        self.model.eval()
        self.config = self.model.config
        if label_map and os.path.exists(label_map):
            self.labels = load_label_map(label_map)
        else:
            self.labels = default_label_map(self.config.num_classes)

    @property
    def device(self) -> torch.device:
        return self.model.device

    @torch.no_grad()
    def detect(self, images: np.ndarray) -> DetectorOutput:
        """[B, canvas, canvas, 3] -> DetectorOutput (tensors on the
        device)."""
        return self.model(torch.as_tensor(images, device=self.device))

    def _postprocess(self, out: DetectorOutput, i: int, nw: int, nh: int
                     ) -> Tuple[np.ndarray, List[str]]:
        """Image i of a batch's output (numpy from `host_output`, or
        tensors) -> (features [n_valid, 2054] float32, tags)."""
        boxes, feats, valid, cls = (
            x[i].detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.array(x[i], copy=True)
            for x in (out.boxes, out.feats, out.valid, out.class_ids))
        n = int(valid.sum())
        # stable: the default introsort permutes equal boolean keys, and
        # with them the NMS confidence order of the regions and tags
        order = np.argsort(~valid, kind="stable")
        boxes, feats, cls = boxes[order][:n], feats[order][:n], cls[order][:n]
        # clip to the unpadded extent and normalise (reference tool :96-110)
        boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]], 0, nw) / nw
        boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]], 0, nh) / nh
        w = (boxes[:, 2] - boxes[:, 0])[:, None]
        h = (boxes[:, 3] - boxes[:, 1])[:, None]
        full = np.concatenate([feats, boxes, w, h], axis=1)
        tags = [self.labels.get(int(c), "object") for c in cls]
        return full.astype(np.float32), tags

    def __call__(self, img_path: str) -> Tuple[np.ndarray, List[str]]:
        from PIL import Image
        x, nw, nh = preprocess_image(Image.open(img_path), self.config.canvas)
        return self._postprocess(host_output(self.detect(x[None])), 0, nw, nh)

    def batch_call(self, img_paths: List[str], batch_size: int = 8
                   ) -> List[Tuple[np.ndarray, List[str]]]:
        """One device forward per `batch_size` images; a partial chunk is
        zero-padded to `batch_size` (one shape for every forward) and its
        padded rows dropped from the results."""
        from PIL import Image
        results: List[Tuple[np.ndarray, List[str]]] = []
        for start in range(0, len(img_paths), batch_size):
            xs, dims = [], []
            for p in img_paths[start:start + batch_size]:
                x, nw, nh = preprocess_image(Image.open(p),
                                             self.config.canvas)
                xs.append(x)
                dims.append((nw, nh))
            while len(xs) < batch_size:
                xs.append(np.zeros_like(xs[0]))
            out = host_output(self.detect(np.stack(xs)))
            results.extend(self._postprocess(out, i, nw, nh)
                           for i, (nw, nh) in enumerate(dims))
        return results


def load_frontend(spec: str, label_map: Optional[str] = None,
                  device="cuda") -> Callable:
    """The pipeline's string spec: 'torch' (seeded weights) or
    'torch:<ckpt_dir>'."""
    if spec == "torch":
        return DetectionFrontend(label_map=label_map, device=device)
    if not spec.startswith("torch:"):
        raise ValueError(f"detector spec {spec!r}: 'torch' or "
                         f"'torch:<ckpt_dir>'")
    return DetectionFrontend(ckpt_dir=spec[len("torch:"):],
                             label_map=label_map, device=device)
