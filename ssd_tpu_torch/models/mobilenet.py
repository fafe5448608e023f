"""MobileNet-v1 feature extractor, on either early schedule.

Returns the stride-8/16/32 maps ``c3``, ``c4``, ``c5`` for the FPN. Two
schedules reach stride 4, then ds3-ds13 follow the MobileNet-v1 table:

* ``reference``: the table itself. ``stem`` is a 3x3 ``ConvBN`` to ``w(32)``
  at stride 2 on the normalized image (stride 1 when the image arrives
  space-to-depth(2)-packed, 12 channels), then ``ds1`` (``w(32)`` to
  ``w(64)``) and ``ds2`` (``w(64)`` to ``w(128)``, stride 2).
  ``ops/fused_early_cuda.py`` fuses ds1 and ds2 into one kernel.
* ``dense4``: the stem packs the image space-to-depth(4) to ``(H/4, W/4,
  48)`` and runs one dense 3x3 conv to ``w(128)`` channels at stride 4, with
  the ImageNet normalize affine folded into that conv (``FoldedS2DConv``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ssd_tpu_torch.constants import BATCH_NORM_MOMENTUM, MEAN_RGB, STD_RGB
from ssd_tpu_torch.models.layers import (BatchNorm, ConvBN,
                                         DepthwiseSeparable, activation)


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

    In train mode with a bf16 compute dtype the conv runs in bf16 and is
    then widened before the correction, as the JAX package's differentiated
    path does (its conv transpose rule refuses the mixed-precision form).
    Gradients reach ``weight`` through the STD fold and the correction map.
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
        wp = (self.weight / self.std48.view(1, 48, 1, 1)).to(dtype)
        if self.training and dtype != torch.float32:
            y = F.conv2d(xs, wp, padding=1).float()
            wp = wp.float()
        else:
            wp = wp.float()
            y = F.conv2d(xs.float(), wp, padding=1)
        ph, pw = xs.shape[-2:]
        if packed_in:
            corr = _border_correction(wp, ph, pw, 128.0 - self.mean48)
            return (y + corr).to(dtype)
        corr = _border_correction(wp, ph, pw, self.mean48)
        return (y - corr).to(dtype)


class Dense4Stem(nn.Module):
    """dense4 early schedule: image -> (N, features, H/4, W/4), BN + ReLU6."""

    def __init__(self, features: int, fold_normalize: bool = False,
                 bn_momentum: float = BATCH_NORM_MOMENTUM):
        super().__init__()
        self.conv = FoldedS2DConv(features, fold_normalize)
        self.bn = BatchNorm(features, momentum=bn_momentum)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return activation(self.bn(self.conv(x, dtype)), "relu6")


class MobileNetV1(nn.Module):
    """``forward(images NHWC, dtype) -> {"c3", "c4", "c5"}`` in NCHW.

    ``reference``: the images are normalized floats, ``(N, H, W, 3)`` with
    ``stem_stride=2`` or space-to-depth(2)-packed ``(N, H/2, W/2, 12)`` with
    ``stem_stride=1``; they are cast to ``dtype`` first. ``dense4``: raw
    uint8 images or the packed s8 feed (``Dense4Stem``).
    """

    def __init__(self, width_multiplier: float = 1.0,
                 stem_schedule: str = "dense4",
                 stem_fold_normalize: bool = False,
                 bn_momentum: float = BATCH_NORM_MOMENTUM,
                 stem_stride: int = 2):
        super().__init__()
        w = lambda ch: _width(ch, width_multiplier)  # noqa: E731
        self.stem_schedule = stem_schedule
        if stem_schedule == "dense4":
            self.stem = Dense4Stem(w(128), stem_fold_normalize,
                                   bn_momentum)  # /4
        elif stem_schedule == "reference":
            self.stem = ConvBN(3 if stem_stride == 2 else 12, w(32), 3,
                               stem_stride, bn_momentum=bn_momentum)  # /2
            self.ds1 = DepthwiseSeparable(w(32), w(64), 1, bn_momentum)
            self.ds2 = DepthwiseSeparable(w(64), w(128), 2, bn_momentum)  # /4
        else:
            raise ValueError(f"unknown stem_schedule {stem_schedule!r}")
        table = [("ds3", 128, 1), ("ds4", 256, 2), ("ds5", 256, 1),
                 ("ds6", 512, 2)] + [(f"ds{7 + i}", 512, 1) for i in range(5)]
        table += [("ds12", 1024, 2), ("ds13", 1024, 1)]
        in_ch = w(128)
        for name, ch, stride in table:
            self.add_module(name, DepthwiseSeparable(in_ch, w(ch), stride,
                                                     bn_momentum))
            in_ch = w(ch)
        self.out_channels = (w(256), w(512), w(1024))

    def stem_output(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The reference schedule's stem: normalized NHWC images -> ``(N,
        w(32), H/2, W/2)``, the input of ds1 (and of the fused kernel)."""
        if self.stem_schedule != "reference":
            raise ValueError("stem_output is the reference schedule's")
        return self.stem(x.permute(0, 3, 1, 2).to(dtype))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> dict:
        if self.stem_schedule == "dense4":
            x = self.stem(x, dtype)
        else:
            x = self.ds2(self.ds1(self.stem_output(x, dtype)))
        for name in ("ds3", "ds4", "ds5"):
            x = getattr(self, name)(x)
        c3 = x
        for i in range(6, 12):
            x = getattr(self, f"ds{i}")(x)
        c4 = x
        c5 = self.ds13(self.ds12(x))
        return {"c3": c3, "c4": c4, "c5": c5}
