"""Feature Pyramid Network + RetinaNet class/box subnets.

P3-P5 from 1x1 laterals, top-down nearest upsample-add and 3x3 smoothing;
P6 by a stride-2 conv on C5, P7 by a stride-2 conv on ReLU(P6). The class
and box subnets are shared across levels. The head returns the per-level
raw maps in the JAX package's layout, ``[(cls (N, H, W, K*C), box (N, H, W,
K*4)), ...]``, channel ``k*C + c``; ``flatten_levels`` concatenates them
into the flat ``(N, A, C)``/``(N, A, 4)`` outputs; ``RetinaHead.trunks``
returns the subnets' trunks without the prediction convs, for the fused
1x1 head (``ops/fused_head.py``). The JAX package's
inference-only fusion barriers have no counterpart in eager PyTorch, so
train and eval run the same code here.

With ``quant`` (int8 with ``int8_neck``) every FPN conv and every subnet
conv is a ``QuantConv`` that requires a calibrated scale: their inputs are
unbounded sums. The subnets are shared across levels, so they hold one
scale per level, keyed by input shape.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ssd_tpu_torch.constants import CLASS_PRIOR
from ssd_tpu_torch.models.layers import Conv, ConvBN, QuantConv
from ssd_tpu_torch.parallel import spatial


def upsample_nearest(x: torch.Tensor, target_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest upsample of NCHW ``x``. Exactly 2x is a repeat; any other
    size follows ``jax.image.resize(method="nearest")``, whose half-pixel
    centres are torch's ``"nearest-exact"`` (not ``"nearest"``). Inside a
    height split (``parallel.spatial``) ``x`` and the target are strips of
    rows and the rows are mapped over the whole maps."""
    strips = spatial.current()
    if strips is not None:
        return strips.upsample_nearest(x, target_hw)
    h, w = x.shape[-2:]
    th, tw = target_hw
    if (th, tw) == (2 * h, 2 * w):
        return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    return F.interpolate(x, size=(th, tw), mode="nearest-exact")


class FPN(nn.Module):
    """Builds P3..P7 from backbone ``{c3, c4, c5}``."""

    def __init__(self, in_channels: tuple[int, int, int], channels: int = 128,
                 quant: bool = False):
        super().__init__()
        c3_ch, c4_ch, c5_ch = in_channels

        def conv(i: int, k: int, stride: int = 1) -> ConvBN:
            return ConvBN(i, channels, k, stride, use_norm=False, act=None,
                          quant=quant, require_scale=True)

        self.lateral3, self.lateral4, self.lateral5 = (
            conv(c3_ch, 1), conv(c4_ch, 1), conv(c5_ch, 1))
        self.smooth3, self.smooth4, self.smooth5 = (
            conv(channels, 3), conv(channels, 3), conv(channels, 3))
        self.p6 = conv(c5_ch, 3, 2)
        self.p7 = conv(channels, 3, 2)

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
                 final_bias_init: float = 0.0, quant: bool = False):
        super().__init__()
        self.depth = depth
        self.final_bias_init = final_bias_init

        def conv(i: int, o: int, k: int) -> Conv:
            return QuantConv(i, o, k, require_scale=True) if quant else Conv(
                i, o, k)

        for i in range(depth):
            self.add_module(f"conv{i}", conv(in_ch if i == 0 else channels,
                                             channels, 3))
        self.predict = conv(channels if depth else in_ch, out_channels,
                            final_kernel)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """The ``depth`` conv + ReLU layers alone (``trunk_only``)."""
        for i in range(self.depth):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.predict(self.trunk(x))


class RetinaHead(nn.Module):
    """Class + box subnets over all levels -> per-level NHWC raw maps."""

    def __init__(self, in_ch: int, num_classes: int, anchors_per_cell: int,
                 depth: int = 4, channels: int = 128, final_kernel: int = 3,
                 quant: bool = False):
        super().__init__()
        k = anchors_per_cell
        self.class_net = Subnet(
            depth, in_ch, channels, k * num_classes, final_kernel,
            final_bias_init=-math.log((1.0 - CLASS_PRIOR) / CLASS_PRIOR),
            quant=quant)
        self.box_net = Subnet(depth, in_ch, channels, k * 4, final_kernel,
                              quant=quant)

    def forward(self, pyramid: list) -> list:
        return [(self.class_net(p).permute(0, 2, 3, 1),
                 self.box_net(p).permute(0, 2, 3, 1)) for p in pyramid]

    def level_trunks(self, pyramid: list) -> list:
        """The class and box trunks of each level, NCHW."""
        return [(self.class_net.trunk(p), self.box_net.trunk(p))
                for p in pyramid]

    def trunks(self, pyramid: list) -> tuple[torch.Tensor, torch.Tensor]:
        """The class and box trunks of every level, each ``(N, cells,
        channels)`` with cells in (level, row, col) order (the JAX head's
        ``trunk_only=True`` outputs)."""
        return flatten_trunks(self.level_trunks(pyramid))


def flatten_trunks(levels: list) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-level NCHW ``(cls, box)`` trunks -> ``RetinaHead.trunks``'s."""
    def cells(t: torch.Tensor) -> torch.Tensor:
        return t.permute(0, 2, 3, 1).reshape(t.shape[0], -1, t.shape[1])

    return (torch.cat([cells(c) for c, _ in levels], 1),
            torch.cat([cells(b) for _, b in levels], 1))


def flatten_levels(raw: list, num_classes: int):
    """Per-level raw maps -> ``(logits (N, A, C), deltas (N, A, 4))``,
    anchors in (level, row, col, anchor) order (the JAX head's
    ``flatten=True`` outputs)."""
    n = raw[0][0].shape[0]
    logits = torch.cat([c.reshape(n, -1, num_classes) for c, _ in raw], 1)
    deltas = torch.cat([b.reshape(n, -1, 4) for _, b in raw], 1)
    return logits, deltas
