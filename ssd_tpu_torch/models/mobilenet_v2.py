"""MobileNet-v2 feature extractor: inverted residuals, linear bottlenecks.

Counterpart of ``ssd_tpu/models/mobilenet_v2.py``: the standard schedule
(Sandler et al. 2018) with ReLU6 and a width multiplier, returning the
stride-8/16/32 maps ``c3``, ``c4``, ``c5`` for the FPN. ``InvertedResidual``
is shared with EfficientNet-lite (``models/efficientnet.py``), which adds
5x5 depthwise kernels.

The residual add runs in the compute dtype, as flax adds two bf16 ``ConvBN``
outputs: in bf16 it rounds once, after the add.

With ``int8`` every dense conv (the stem, each expand and project) is a
``QuantConv``; the depthwise convs stay bf16. The stem's static bound is 3
(its input is the normalized image), the others' ReLU6's 6: the JAX
package's ``act_range``s, which serve only where no calibrated scale is.
"""

from __future__ import annotations

import torch
from torch import nn

from ssd_tpu_torch.constants import BATCH_NORM_MOMENTUM
from ssd_tpu_torch.models.layers import ConvBN


def _width(ch: int, multiplier: float) -> int:
    return max(8, int(ch * multiplier + 0.5) // 8 * 8)


# (expand_ratio, out_channels, num_blocks, first_stride)
_SCHEDULE = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),    # /4
    (6, 32, 3, 2),    # /8  -> c3
    (6, 64, 4, 2),    # /16
    (6, 96, 3, 1),    #     -> c4
    (6, 160, 3, 2),   # /32
    (6, 320, 1, 1),   #     -> c5
)
_TAPS = {2: "c3", 4: "c4", 6: "c5"}  # stage index -> tap


class InvertedResidual(nn.Module):
    """expand 1x1 + relu6 (absent at ratio 1), depthwise ``kernel`` + relu6,
    project 1x1 without activation; ``+ x`` when the shape is kept."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 expand: int = 6, kernel: int = 3,
                 bn_momentum: float = BATCH_NORM_MOMENTUM,
                 norm: str = "batch", int8: bool = False):
        super().__init__()
        mid = in_ch * expand
        kw = dict(bn_momentum=bn_momentum, norm=norm, quant=int8)
        self.expand = ConvBN(in_ch, mid, 1, **kw) if expand != 1 else None
        self.depthwise = ConvBN(mid, mid, kernel, stride, groups=mid, **kw)
        self.project = ConvBN(mid, out_ch, 1, act=None, **kw)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x if self.expand is None else self.expand(x)
        h = self.project(self.depthwise(h))
        return h + x if self.residual else h


class InvertedResidualNet(nn.Module):
    """A stem ``ConvBN`` (3x3, relu6) and stages of ``InvertedResidual``
    blocks named ``block{stage}_{i}``; ``forward(images NHWC, dtype) ->
    {"c3", "c4", "c5"}`` in NCHW.

    ``schedule``: ``(expand, out_ch, blocks, first_stride, kernel)`` per
    stage, widths already applied. The images are normalized floats,
    ``(N, H, W, 3)`` with ``stem_stride=2`` or space-to-depth(2)-packed
    ``(N, H/2, W/2, 12)`` with ``stem_stride=1``; they are cast to
    ``dtype`` first. ``int8``: the dense convs quantized (module
    docstring).
    """

    def __init__(self, stem_ch: int, schedule: tuple,
                 bn_momentum: float = BATCH_NORM_MOMENTUM,
                 norm: str = "batch", stem_stride: int = 2,
                 int8: bool = False):
        super().__init__()
        kw = dict(bn_momentum=bn_momentum, norm=norm)
        # act_range 3: the stem's input is the normalized image
        self.stem = ConvBN(3 if stem_stride == 2 else 12, stem_ch, 3,
                           stem_stride, quant=int8, act_range=3.0,
                           **kw)  # /2
        self.blocks = []
        in_ch = stem_ch
        for gi, (t, ch, n, s, k) in enumerate(schedule):
            for bi in range(n):
                name = f"block{gi}_{bi}"
                self.add_module(name, InvertedResidual(
                    in_ch, ch, s if bi == 0 else 1, t, k, int8=int8, **kw))
                self.blocks.append((name, _TAPS.get(gi) if bi == n - 1
                                    else None))
                in_ch = ch
        self.out_channels = tuple(schedule[g][1] for g in sorted(_TAPS))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> dict:
        x = self.stem(x.permute(0, 3, 1, 2).to(dtype))
        taps = {}
        for name, tap in self.blocks:
            x = getattr(self, name)(x)
            if tap:
                taps[tap] = x
        return taps


class MobileNetV2(InvertedResidualNet):
    def __init__(self, width_multiplier: float = 1.0,
                 bn_momentum: float = BATCH_NORM_MOMENTUM,
                 norm: str = "batch", stem_stride: int = 2,
                 int8: bool = False):
        w = lambda ch: _width(ch, width_multiplier)  # noqa: E731
        super().__init__(w(32), tuple((t, w(c), n, s, 3)
                                      for t, c, n, s in _SCHEDULE),
                         bn_momentum, norm, stem_stride, int8)
