"""ResNet-50 feature extractor, for the RetinaNet ResNet-50-FPN config.

Counterpart of ``ssd_tpu/models/resnet.py``: bottleneck ResNet-v1.5 (the
stride in the 3x3), a 7x7 stride-2 SAME stem (pads 2 before and 3 after at
640) with ReLU, a SAME 3x3/2 max-pool, and stages of 3, 4, 6 and 3 blocks;
the stride-8/16/32 maps ``c3``, ``c4``, ``c5`` have 512, 1024 and 2048
channels. Each block adds its residual in the compute dtype, then the ReLU.

With ``int8`` every conv is a ``QuantConv`` (ResNet has no depthwise conv).
ReLU does not bound the activations, so the static ReLU6 bound (6) the
JAX package falls back to is only a placeholder: such a model is served on
calibrated scales (``quant.py``; ``check_supported`` requires
``int8_neck``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ssd_tpu_torch.constants import BATCH_NORM_MOMENTUM
from ssd_tpu_torch.models.layers import ConvBN, max_pool_same

# (name prefix, bottleneck width, blocks, first stride); taps after s2-s4
_STAGES = (("s1", 64, 3, 1), ("s2", 128, 4, 2), ("s3", 256, 6, 2),
           ("s4", 512, 3, 2))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (``stride``) -> 1x1 to ``4 * features``, each norm +
    relu but the last; a 1x1 projection shortcut where the shape changes;
    ``relu(y + residual)``."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 bn_momentum: float = BATCH_NORM_MOMENTUM,
                 norm: str = "batch", int8: bool = False):
        super().__init__()
        out_ch = 4 * features
        kw = dict(bn_momentum=bn_momentum, norm=norm, quant=int8)
        self.proj = (ConvBN(in_ch, out_ch, 1, stride, act=None, **kw)
                     if in_ch != out_ch or stride != 1 else None)
        self.conv1 = ConvBN(in_ch, features, 1, act="relu", **kw)
        self.conv2 = ConvBN(features, features, 3, stride, act="relu", **kw)
        self.conv3 = ConvBN(features, out_ch, 1, act=None, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.proj is None else self.proj(x)
        return F.relu(self.conv3(self.conv2(self.conv1(x))) + residual)


class ResNet50(nn.Module):
    """``forward(images NHWC, dtype) -> {"c3", "c4", "c5"}`` in NCHW; the
    images as ``models/mobilenet_v2.InvertedResidualNet`` takes them."""

    def __init__(self, bn_momentum: float = BATCH_NORM_MOMENTUM,
                 norm: str = "batch", stem_stride: int = 2,
                 int8: bool = False):
        super().__init__()
        kw = dict(bn_momentum=bn_momentum, norm=norm, int8=int8)
        self.stem = ConvBN(3 if stem_stride == 2 else 12, 64, 7, stem_stride,
                           act="relu", bn_momentum=bn_momentum, norm=norm,
                           quant=int8)  # /2, then the pool: /4
        in_ch = 64
        for prefix, width, blocks, stride in _STAGES:
            for i in range(blocks):
                self.add_module(f"{prefix}_b{i}", Bottleneck(
                    in_ch, width, stride if i == 0 else 1, **kw))
                in_ch = 4 * width
        self.out_channels = tuple(4 * w for _, w, _, _ in _STAGES[1:])

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> dict:
        x = max_pool_same(self.stem(x.permute(0, 3, 1, 2).to(dtype)))
        taps = {}
        for (prefix, _, blocks, _), tap in zip(_STAGES,
                                               (None, "c3", "c4", "c5")):
            for i in range(blocks):
                x = getattr(self, f"{prefix}_b{i}")(x)
            if tap:
                taps[tap] = x
        return taps
