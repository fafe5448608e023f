"""ShuffleNet-v2 feature extractor.

Counterpart of ``ssd_tpu/models/shufflenet.py``: channel-split blocks with
channel shuffle (Ma et al. 2018), returning the stride-8/16/32 maps ``c3``,
``c4``, ``c5`` for the FPN. ``width_multiplier`` picks the nearest of the
0.5x/1.0x/1.5x/2.0x stage widths.

In NCHW the split takes channels ``[:C/2]`` as the shortcut, the shuffle
permutes dim 1 (``layers.channel_shuffle``), and the SAME max-pool pads 0
before and 1 after (``layers.max_pool_same``). The depthwise convs have no
activation.

With ``int8`` every dense conv (the stem and the 1x1s) is a ``QuantConv``;
the depthwise convs stay bf16. The 1x1s after a depthwise conv take its
output without activation, unbounded: served on calibrated scales
(``check_supported`` requires ``int8_neck``).
"""

from __future__ import annotations

import torch
from torch import nn

from ssd_tpu_torch.constants import BATCH_NORM_MOMENTUM
from ssd_tpu_torch.models.layers import ConvBN, channel_shuffle, max_pool_same

# out_channels per stage for the canonical multipliers
_STAGE_WIDTHS = {
    0.5: (48, 96, 192),
    1.0: (116, 232, 464),
    1.5: (176, 352, 704),
    2.0: (244, 488, 976),
}
_STAGE_BLOCKS = (3, 7, 3)


def _stage_widths(multiplier: float) -> tuple[int, int, int]:
    key = min(_STAGE_WIDTHS, key=lambda k: abs(k - multiplier))
    return _STAGE_WIDTHS[key]


class ShuffleBlock(nn.Module):
    """Basic unit: split channels, transform the second half (pw, dw, pw),
    concatenate, shuffle."""

    def __init__(self, channels: int, bn_momentum: float = BATCH_NORM_MOMENTUM,
                 norm: str = "batch", int8: bool = False):
        super().__init__()
        c = channels // 2
        kw = dict(bn_momentum=bn_momentum, norm=norm, quant=int8)
        self.pw1 = ConvBN(c, c, 1, **kw)
        self.dw = ConvBN(c, c, 3, groups=c, act=None, **kw)
        self.pw2 = ConvBN(c, c, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1] // 2
        shortcut, branch = x[:, :c], x[:, c:]
        branch = self.pw2(self.dw(self.pw1(branch)))
        return channel_shuffle(torch.cat([shortcut, branch], dim=1), 2)


class ShuffleDownBlock(nn.Module):
    """Stride-2 unit: both branches transformed, spatial /2, channels to
    ``features``."""

    def __init__(self, in_ch: int, features: int,
                 bn_momentum: float = BATCH_NORM_MOMENTUM,
                 norm: str = "batch", int8: bool = False):
        super().__init__()
        c = features // 2
        kw = dict(bn_momentum=bn_momentum, norm=norm, quant=int8)
        self.left_dw = ConvBN(in_ch, in_ch, 3, 2, groups=in_ch, act=None,
                              **kw)
        self.left_pw = ConvBN(in_ch, c, 1, **kw)
        self.right_pw1 = ConvBN(in_ch, c, 1, **kw)
        self.right_dw = ConvBN(c, c, 3, 2, groups=c, act=None, **kw)
        self.right_pw2 = ConvBN(c, c, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        left = self.left_pw(self.left_dw(x))
        right = self.right_pw2(self.right_dw(self.right_pw1(x)))
        return channel_shuffle(torch.cat([left, right], dim=1), 2)


class ShuffleNetV2(nn.Module):
    """``forward(images NHWC, dtype) -> {"c3", "c4", "c5"}`` in NCHW; the
    images as ``models/mobilenet_v2.InvertedResidualNet`` takes them."""

    def __init__(self, width_multiplier: float = 1.0,
                 bn_momentum: float = BATCH_NORM_MOMENTUM,
                 norm: str = "batch", stem_stride: int = 2,
                 int8: bool = False):
        super().__init__()
        kw = dict(bn_momentum=bn_momentum, norm=norm, int8=int8)
        widths = _stage_widths(width_multiplier)
        self.stem = ConvBN(3 if stem_stride == 2 else 12, 24, 3, stem_stride,
                           bn_momentum=bn_momentum, norm=norm,
                           quant=int8)  # /2, then the pool: /4
        in_ch = 24
        for stage, (width, blocks) in enumerate(zip(widths, _STAGE_BLOCKS),
                                                start=2):
            self.add_module(f"stage{stage}_down",
                            ShuffleDownBlock(in_ch, width, **kw))
            for i in range(blocks):
                self.add_module(f"stage{stage}_b{i}",
                                ShuffleBlock(width, **kw))
            in_ch = width
        self.out_channels = widths

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> dict:
        x = max_pool_same(self.stem(x.permute(0, 3, 1, 2).to(dtype)))
        taps = {}
        for stage, tap in zip((2, 3, 4), ("c3", "c4", "c5")):
            x = getattr(self, f"stage{stage}_down")(x)
            for i in range(_STAGE_BLOCKS[stage - 2]):
                x = getattr(self, f"stage{stage}_b{i}")(x)
            taps[tap] = x
        return taps
