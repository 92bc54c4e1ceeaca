"""Image preprocessing for TorchScript detectors (numpy, PIL imported only
where an image is resized or flipped; no torchvision): the JAX package's
`tools/transforms.py`.

Parity target: reference `tools/transform_utils.py:124-155` build_transforms
with `tools/configs/vinvl_transform.json`: the shorter side resized to
MIN_SIZE_TEST, capped by MAX_SIZE_TEST (maskrcnn-benchmark geometry), a CHW
float array, optional BGR255 conversion, pixel-mean/std normalisation.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def resize_shape(w: int, h: int, min_size: int, max_size: int
                 ) -> Tuple[int, int]:
    """maskrcnn-benchmark resize rule: shorter side -> min_size unless that
    pushes the longer side past max_size (then scale to max_size)."""
    size = min_size
    mn, mx = (w, h) if w < h else (h, w)
    if mx / mn * size > max_size:
        size = int(round(max_size * mn / mx))
    if (w <= h and w == size) or (h <= w and h == size):
        return w, h
    if w < h:
        return size, int(size * h / w)
    return int(size * w / h), size


class VinVLTransform:
    def __init__(self, cfg: dict):
        self.min_size = cfg["MIN_SIZE_TEST"]
        self.max_size = cfg["MAX_SIZE_TEST"]
        self.to_bgr255 = cfg.get("TO_BGR255", True)
        self.mean = np.asarray(cfg["PIXEL_MEAN"], np.float32)
        self.std = np.asarray(cfg.get("PIXEL_STD", [1.0, 1.0, 1.0]),
                              np.float32)

    def __call__(self, pil_img) -> np.ndarray:
        from PIL import Image
        w, h = pil_img.size
        nw, nh = resize_shape(w, h, self.min_size, self.max_size)
        # torchvision F.resize (the reference's path, transform_utils.py:60)
        # interpolates BILINEAR; PIL's own default is BICUBIC
        img = pil_img.resize((nw, nh), Image.BILINEAR)
        x = np.asarray(img, np.float32) / 255.0          # HWC RGB [0,1]
        x = np.transpose(x, (2, 0, 1))                   # CHW
        if self.to_bgr255:
            x = x[::-1] * 255.0
        x = (x - self.mean[:, None, None]) / self.std[:, None, None]
        return x


class TrainTransform(VinVLTransform):
    """Train-time augmentation: colour jitter and random horizontal or
    vertical flips ahead of the inference transform (reference
    tools/transform_utils.py:124-155 build_transforms, which wires them with
    zero probabilities for inference; here they act when the caller passes
    nonzero knobs)."""

    def __init__(self, cfg: dict, *, flip_horizontal_prob: float = 0.0,
                 flip_vertical_prob: float = 0.0, brightness: float = 0.0,
                 contrast: float = 0.0, saturation: float = 0.0,
                 seed: int = 0):
        super().__init__(cfg)
        self.flip_h = flip_horizontal_prob
        self.flip_v = flip_vertical_prob
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.rng = np.random.RandomState(seed)

    def __call__(self, pil_img) -> np.ndarray:
        from PIL import Image
        img = pil_img.convert("RGB")
        if self.flip_h > 0 and self.rng.rand() < self.flip_h:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if self.flip_v > 0 and self.rng.rand() < self.flip_v:
            img = img.transpose(Image.FLIP_TOP_BOTTOM)
        x = super().__call__(img)                 # CHW, normalised
        # jitter in normalised space (torchvision-style multiplicative
        # factors drawn uniformly around 1)

        def factor(amount):
            return 1.0 + self.rng.uniform(-amount, amount)
        if self.brightness > 0:
            x = x * factor(self.brightness)
        if self.contrast > 0:
            mean = x.mean()
            x = (x - mean) * factor(self.contrast) + mean
        if self.saturation > 0:
            gray = x.mean(axis=0, keepdims=True)
            x = gray + (x - gray) * factor(self.saturation)
        return x.astype(np.float32)


def build_transforms(cfg: dict, *, is_train: bool = False,
                     **train_knobs) -> VinVLTransform:
    if is_train:
        return TrainTransform(cfg, **train_knobs)
    return VinVLTransform(cfg)
