"""RoI-align (bilinear, `sampling_ratio`^2 samples averaged a cell) as
tensor gathers: the JAX package's `detection/roi_align.py`.

The reference runs maskrcnn-benchmark's CUDA ROIAlign inside its TorchScript
artifact. At the front-end's scale (50 boxes x 7 x 7 cells x 4 samples over
a 40 x 40 map) the gathers are small next to the trunk, and the JAX package
wrote no Pallas kernel for them either.
"""

from __future__ import annotations

import torch


def _bilinear(fmap: torch.Tensor, y: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """Sample fmap [B, H, W, C] at float coordinates y, x [B, M] -> [B, M,
    C] in fp32. A sample outside [-1, H] x [-1, W] gives zero (the
    maskrcnn-benchmark kernel's empty-sample rule); inside, coordinates
    clamp to the border."""
    b, h, w, _ = fmap.shape
    valid = (y >= -1.0) & (y <= float(h)) & (x >= -1.0) & (x <= float(w))
    y = y.clamp(0.0, h - 1.0)
    x = x.clamp(0.0, w - 1.0)
    y0 = y.floor().long()
    x0 = x.floor().long()
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    wy = (y - y0)[..., None]
    wx = (x - x0)[..., None]
    rows = torch.arange(b, device=fmap.device)[:, None]
    v00 = fmap[rows, y0, x0]
    v01 = fmap[rows, y0, x1]
    v10 = fmap[rows, y1, x0]
    v11 = fmap[rows, y1, x1]
    out = ((1 - wy) * (1 - wx) * v00 + (1 - wy) * wx * v01
           + wy * (1 - wx) * v10 + wy * wx * v11)
    return out * valid[..., None].to(out.dtype)


def batched_roi_align(fmaps: torch.Tensor, boxes: torch.Tensor, *,
                      output_size: int = 7, spatial_scale: float = 1.0,
                      sampling_ratio: int = 2) -> torch.Tensor:
    """fmaps [B, H, W, C]; boxes [B, N, 4] xyxy in image coordinates
    (scaled onto the map by spatial_scale) -> [B, N, P, P, C] fp32.

    Continuous coordinates (no rounding), `sampling_ratio`^2 bilinear
    samples averaged per output cell: for cell (i, j) the samples sit at
    y1 + (i + (k + 0.5) / s) * cell_h, k in [0, s) (maskrcnn-benchmark,
    aligned=False)."""
    p, s = output_size, sampling_ratio
    bsz, n = boxes.shape[:2]
    bx = boxes.float() * spatial_scale
    x1, y1, x2, y2 = bx[..., 0], bx[..., 1], bx[..., 2], bx[..., 3]
    cell_w = (x2 - x1).clamp(min=1.0) / p                    # [B, N]
    cell_h = (y2 - y1).clamp(min=1.0) / p
    offs = (torch.arange(s, device=boxes.device, dtype=torch.float32)
            + 0.5) / s
    grid = (torch.arange(p, device=boxes.device,
                         dtype=torch.float32)[:, None] + offs[None])  # [p, s]
    ys = y1[..., None, None] + grid * cell_h[..., None, None]   # [B, N, p, s]
    xs = x1[..., None, None] + grid * cell_w[..., None, None]
    yy = ys[:, :, :, :, None, None].expand(bsz, n, p, s, p, s)
    xx = xs[:, :, None, None, :, :].expand(bsz, n, p, s, p, s)
    vals = _bilinear(fmaps, yy.reshape(bsz, -1), xx.reshape(bsz, -1))
    return vals.reshape(bsz, n, p, s, p, s, -1).mean(dim=(3, 5))


def roi_align(fmap: torch.Tensor, boxes: torch.Tensor, **kw) -> torch.Tensor:
    """fmap [H, W, C]; boxes [N, 4] -> [N, P, P, C]."""
    return batched_roi_align(fmap[None], boxes[None], **kw)[0]
