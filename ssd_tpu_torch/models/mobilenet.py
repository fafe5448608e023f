"""MobileNet-v1 feature extractor on the dense4 schedule.

Returns the stride-8/16/32 maps ``c3``, ``c4``, ``c5`` for the FPN. The
dense4 stem packs the image space-to-depth(4) to ``(H/4, W/4, 48)`` and runs
one dense 3x3 conv to ``w(128)`` channels at stride 4, with the ImageNet
normalize affine folded into that conv (``FoldedS2DConv``); ds3-ds13 follow
the MobileNet-v1 table. The ``reference`` schedule (stem at stride 2, ds1,
ds2) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ssd_tpu_torch.constants import MEAN_RGB, STD_RGB
from ssd_tpu_torch.models.layers import (BatchNorm, DepthwiseSeparable,
                                         activation)


def _width(ch: int, multiplier: float) -> int:
    return max(8, int(ch * multiplier + 0.5) // 8 * 8)


def s2d_pack(images_nhwc: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) -> (N, 48, H/4, W/4), channel ``(4*dy + dx)*3 + c``
    holding pixel ``(dy, dx)`` channel ``c`` of each 4x4 block (the layout of
    ``ops/ingest.pack_s2d``; ``F.pixel_unshuffle`` orders ``(c, dy, dx)``)."""
    n, h, w, c = images_nhwc.shape
    x = images_nhwc.reshape(n, h // 4, 4, w // 4, 4, c)
    x = x.permute(0, 2, 4, 5, 1, 3)  # (N, dy, dx, c, H/4, W/4)
    return x.reshape(n, 16 * c, h // 4, w // 4)


def _border_correction(wp: torch.Tensor, ph: int, pw: int,
                       const48: torch.Tensor) -> torch.Tensor:
    """``conv(constant image, wp)`` under the stem's zero padding, (1, F, ph,
    pw) f32.

    Interior outputs all share one value, so a 5x5 probe (edge, interior,
    edge per axis) covers every border class and the map is assembled by
    broadcasting the interior. Below 5 packed cells the edge windows
    overlap, so the probe is the full size.
    """
    if ph < 5 or pw < 5:
        img = const48.view(1, 48, 1, 1).expand(1, 48, ph, pw)
        return F.conv2d(img, wp, padding=1)
    probe = F.conv2d(const48.view(1, 48, 1, 1).expand(1, 48, 5, 5), wp,
                     padding=1)[0]  # (F, 5, 5)

    def expand(p: torch.Tensor, n: int, dim: int) -> torch.Tensor:
        mid = p.narrow(dim, 1, 1)
        shape = list(p.shape)
        shape[dim] = n - 2
        return torch.cat([p.narrow(dim, 0, 1), mid.expand(shape),
                          p.narrow(dim, 4, 1)], dim)

    return expand(expand(probe, ph, 1), pw, 2)[None]


class FoldedS2DConv(nn.Module):
    """The dense4 stem conv: one ``(features, 48, 3, 3)`` kernel over the
    space-to-depth(4) packing of the image.

    ``fold_normalize``: the input is the raw uint8 image (or the packed s8
    feed) and the normalize affine is folded in. Weights are divided by the
    packed STD; the mean term is a border-aware correction map subtracted
    from the conv result, so zero padding of the raw input reproduces the
    normalized path tap for tap. The packed feed holds ``p - 128``, so its
    correction uses ``128 - mean`` and is added. The conv runs in f32 on
    operands rounded to the compute dtype, because the correction cancels a
    term of comparable magnitude; the result is rounded once, after it.
    """

    def __init__(self, features: int, fold_normalize: bool = False):
        super().__init__()
        self.fold_normalize = fold_normalize
        self.weight = nn.Parameter(torch.empty(features, 48, 3, 3))
        std48 = torch.from_numpy(np.tile(STD_RGB, 16))
        mean48 = torch.from_numpy(np.tile(MEAN_RGB, 16))
        self.register_buffer("std48", std48, persistent=False)
        self.register_buffer("mean48", mean48, persistent=False)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        packed_in = x.dtype == torch.int8
        if packed_in:  # (N, H/4, W/4, 48) s8 = packed pixels - 128
            if not self.fold_normalize:
                raise ValueError("packed ingest requires fold_normalize")
            xs = x.permute(0, 3, 1, 2).to(dtype)
        else:  # (N, H, W, 3) raw (or pre-normalized) image
            xs = s2d_pack(x).to(dtype)
        xs = xs.contiguous(memory_format=torch.channels_last)
        if not self.fold_normalize:
            return F.conv2d(xs, self.weight.to(dtype), padding=1)
        wp = (self.weight / self.std48.view(1, 48, 1, 1)).to(dtype).float()
        y = F.conv2d(xs.float(), wp, padding=1)
        ph, pw = xs.shape[-2:]
        if packed_in:
            corr = _border_correction(wp, ph, pw, 128.0 - self.mean48)
            return (y + corr).to(dtype)
        corr = _border_correction(wp, ph, pw, self.mean48)
        return (y - corr).to(dtype)


class Dense4Stem(nn.Module):
    """dense4 early schedule: image -> (N, features, H/4, W/4), BN + ReLU6."""

    def __init__(self, features: int, fold_normalize: bool = False):
        super().__init__()
        self.conv = FoldedS2DConv(features, fold_normalize)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return activation(self.bn(self.conv(x, dtype)), "relu6")


class MobileNetV1(nn.Module):
    """``forward(images NHWC, dtype) -> {"c3", "c4", "c5"}`` in NCHW."""

    def __init__(self, width_multiplier: float = 1.0,
                 stem_schedule: str = "dense4",
                 stem_fold_normalize: bool = False):
        super().__init__()
        if stem_schedule != "dense4":
            raise NotImplementedError(
                f"stem_schedule={stem_schedule!r}: the port builds dense4; "
                "the reference schedule is queued in ROADMAP.md")
        w = lambda ch: _width(ch, width_multiplier)  # noqa: E731
        self.stem = Dense4Stem(w(128), stem_fold_normalize)  # /4
        table = [("ds3", 128, 1), ("ds4", 256, 2), ("ds5", 256, 1),
                 ("ds6", 512, 2)] + [(f"ds{7 + i}", 512, 1) for i in range(5)]
        table += [("ds12", 1024, 2), ("ds13", 1024, 1)]
        in_ch = w(128)
        for name, ch, stride in table:
            self.add_module(name, DepthwiseSeparable(in_ch, w(ch), stride))
            in_ch = w(ch)
        self.out_channels = (w(256), w(512), w(1024))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> dict:
        x = self.stem(x, dtype)
        for name in ("ds3", "ds4", "ds5"):
            x = getattr(self, name)(x)
        c3 = x
        for i in range(6, 12):
            x = getattr(self, f"ds{i}")(x)
        c4 = x
        c5 = self.ds13(self.ds12(x))
        return {"c3": c3, "c4": c4, "c5": c5}
