"""The detection front-end's convolutional trunk: the JAX package's
`detection/backbone.py` (flax `ResBlock` and `Trunk`) as `nn.Module`s.

A ResNet-18-shaped trunk to stride 16: a 7x7 stride-2 stem, GroupNorm (32
groups, no running statistics), a 3x3 stride-2 max pool, then stages of
basic residual blocks. Images come in NHWC, as the JAX trunk takes them;
inside, the convolutions run on the NCHW view of that memory (PyTorch's
channels-last format, which cuDNN's NHWC kernels take as it is), and the
feature map goes back out NHWC.

Flax's "SAME" padding is asymmetric where the total is odd: (total // 2)
before, the rest after (a 7x7 stride-2 stem over an even side pads 2 and 3;
a 3x3 stride-2 conv pads 0 and 1). `torch.nn.Conv2d(padding=...)` pads
symmetrically, which keeps the output size but shifts it by one pixel, so
every convolution and the pool pad explicitly (`same_pad`). Flax's
GroupNorm epsilon is 1e-6; its statistics and affine run in fp32 under a
bf16 `dtype`, the output cast to it, as here.

Parameter names follow the flax tree: `stem_conv.weight`, `stem_gn.weight`,
`stage0_block0.conv1.weight`, `stage0_block0.gn1.bias`, `...proj.weight`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

GN_GROUPS = 32
GN_EPS = 1e-6                        # flax GroupNorm's epsilon


def _same(size: int, k: int, s: int) -> Tuple[int, int]:
    """(before, after) padding of one side of length `size` for a window k,
    stride s under "SAME" (lax.padtype_to_pads)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def same_pad(x: torch.Tensor, k: int, s: int,
             value: float = 0.0) -> torch.Tensor:
    """x [B, C, H, W] padded for a k x k window at stride s under "SAME"."""
    top, bottom = _same(x.shape[2], k, s)
    left, right = _same(x.shape[3], k, s)
    if not (top or bottom or left or right):
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


class Conv(nn.Conv2d):
    """A flax `nn.Conv` with "SAME" padding, computing in `dtype` (input and
    kernel cast to it, as flax's `dtype=`). Weight [out, in, kh, kw]."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, k, stride=stride, padding=0, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(same_pad(x.to(dt), self.kernel_size[0],
                                 self.stride[0]),
                        self.weight.to(dt), b, self.stride)


class GroupNorm(nn.GroupNorm):
    """Flax `nn.GroupNorm(num_groups=32)`: fp32 statistics and affine, the
    output in the input's dtype."""

    def __init__(self, channels: int):
        super().__init__(GN_GROUPS, channels, eps=GN_EPS)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps).to(x.dtype)


class ResBlock(nn.Module):
    """Basic residual block: 3x3 conv -> GN -> relu -> 3x3 conv -> GN, a
    1x1 projection (and its GN) where the shape changes."""

    def __init__(self, cin: int, channels: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(cin, channels, 3, stride, bias=False, dtype=dtype)
        self.gn1 = GroupNorm(channels)
        self.conv2 = Conv(channels, channels, 3, bias=False, dtype=dtype)
        self.gn2 = GroupNorm(channels)
        # flax projects when the residual's shape differs from the output's
        self.has_proj = stride != 1 or cin != channels
        if self.has_proj:
            self.proj = Conv(cin, channels, 1, stride, bias=False,
                             dtype=dtype)
            self.gn_proj = GroupNorm(channels)

    def forward(self, x):
        r = x
        x = F.relu(self.gn1(self.conv1(x)))
        x = self.gn2(self.conv2(x))
        if self.has_proj:
            r = self.gn_proj(self.proj(r))
        return F.relu(x + r)


class Trunk(nn.Module):
    """Stem (stride 4) + stages -> the stride-16 feature map. Takes images
    NHWC [B, S, S, 3], returns [B, S/16, S/16, C] (NHWC)."""

    def __init__(self, stage_channels: Sequence[int] = (64, 128, 256),
                 stage_blocks: Sequence[int] = (2, 2, 2),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.stem_conv = Conv(3, 64, 7, 2, bias=False, dtype=dtype)
        self.stem_gn = GroupNorm(64)
        cin = 64
        self.blocks = []
        for si, (ch, nb) in enumerate(zip(stage_channels, stage_blocks)):
            for bi in range(nb):
                stride = 2 if (bi == 0 and si > 0) else 1
                name = f"stage{si}_block{bi}"
                self.add_module(name, ResBlock(cin, ch, stride, dtype))
                self.blocks.append(name)
                cin = ch

    def forward(self, images):
        x = images.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = F.relu(self.stem_gn(self.stem_conv(x)))
        x = F.max_pool2d(same_pad(x, 3, 2, float("-inf")), 3, 2)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x.permute(0, 2, 3, 1)
