"""Feature Pyramid Network + RetinaNet class/box subnets.

P3-P5 from 1x1 laterals, top-down nearest upsample-add and 3x3 smoothing;
P6 by a stride-2 conv on C5, P7 by a stride-2 conv on ReLU(P6). The class
and box subnets are shared across levels. The head returns the per-level
raw maps in the JAX package's layout, ``[(cls (N, H, W, K*C), box (N, H, W,
K*4)), ...]``, channel ``k*C + c``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ssd_tpu_torch.constants import CLASS_PRIOR
from ssd_tpu_torch.models.layers import Conv, ConvBN


def upsample_nearest(x: torch.Tensor, target_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest upsample of NCHW ``x``. Exactly 2x is a repeat; any other
    size follows ``jax.image.resize(method="nearest")``, whose half-pixel
    centres are torch's ``"nearest-exact"`` (not ``"nearest"``)."""
    h, w = x.shape[-2:]
    th, tw = target_hw
    if (th, tw) == (2 * h, 2 * w):
        return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    return F.interpolate(x, size=(th, tw), mode="nearest-exact")


class FPN(nn.Module):
    """Builds P3..P7 from backbone ``{c3, c4, c5}``."""

    def __init__(self, in_channels: tuple[int, int, int], channels: int = 128):
        super().__init__()
        c3_ch, c4_ch, c5_ch = in_channels
        lat = lambda i: ConvBN(i, channels, 1, use_norm=False, act=None)  # noqa: E731
        smooth = lambda: ConvBN(channels, channels, 3, use_norm=False,  # noqa: E731
                                act=None)
        self.lateral3, self.lateral4, self.lateral5 = (
            lat(c3_ch), lat(c4_ch), lat(c5_ch))
        self.smooth3, self.smooth4, self.smooth5 = smooth(), smooth(), smooth()
        self.p6 = ConvBN(c5_ch, channels, 3, 2, use_norm=False, act=None)
        self.p7 = ConvBN(channels, channels, 3, 2, use_norm=False, act=None)

    def forward(self, feats: dict) -> list:
        c3, c4, c5 = feats["c3"], feats["c4"], feats["c5"]
        p5 = self.lateral5(c5)
        p4 = self.lateral4(c4) + upsample_nearest(p5, c4.shape[-2:])
        p3 = self.lateral3(c3) + upsample_nearest(p4, c3.shape[-2:])
        p3, p4, p5 = self.smooth3(p3), self.smooth4(p4), self.smooth5(p5)
        p6 = self.p6(c5)
        p7 = self.p7(F.relu(p6))
        return [p3, p4, p5, p6, p7]


class Subnet(nn.Module):
    """``depth`` 3x3 conv + ReLU layers, then the prediction conv."""

    def __init__(self, depth: int, in_ch: int, channels: int,
                 out_channels: int, final_kernel: int = 3,
                 final_bias_init: float = 0.0):
        super().__init__()
        self.depth = depth
        self.final_bias_init = final_bias_init
        for i in range(depth):
            self.add_module(f"conv{i}", Conv(in_ch if i == 0 else channels,
                                             channels, 3))
        self.predict = Conv(channels if depth else in_ch, out_channels,
                            final_kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return self.predict(x)


class RetinaHead(nn.Module):
    """Class + box subnets over all levels -> per-level NHWC raw maps."""

    def __init__(self, in_ch: int, num_classes: int, anchors_per_cell: int,
                 depth: int = 4, channels: int = 128, final_kernel: int = 3):
        super().__init__()
        k = anchors_per_cell
        self.class_net = Subnet(
            depth, in_ch, channels, k * num_classes, final_kernel,
            final_bias_init=-math.log((1.0 - CLASS_PRIOR) / CLASS_PRIOR))
        self.box_net = Subnet(depth, in_ch, channels, k * 4, final_kernel)

    def forward(self, pyramid: list) -> list:
        return [(self.class_net(p).permute(0, 2, 3, 1),
                 self.box_net(p).permute(0, 2, 3, 1)) for p in pyramid]
