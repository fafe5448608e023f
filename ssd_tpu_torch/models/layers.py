"""Shared building blocks: SAME-padded conv, batch norm (flax's semantics in
train and eval mode), ConvBN, and the MobileNet-v1 depthwise-separable
block.

Layout is NCHW inside the model. Parameters live in f32; each conv casts its
weight to the activation's dtype (bf16 or f32) when it runs, as flax does
with ``param_dtype=float32`` and ``dtype=compute_dtype``. Module and
parameter names follow the flax tree (``conv``, ``bn``, ``depthwise``,
``pointwise``), so ``convert.py`` maps one to the other by path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ssd_tpu_torch.constants import BATCH_NORM_EPSILON, BATCH_NORM_MOMENTUM

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise NotImplementedError(
            f"compute_dtype={name!r}: the port builds bfloat16 and float32")
    return DTYPES[name]


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """NHWC space-to-depth: ``(N, H, W, C) -> (N, H/b, W/b, C*b*b)``, channel
    ``(dy*b + dx)*C + c`` holding pixel ``(dy, dx)`` channel ``c`` of each
    ``b x b`` block (the JAX package's order)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // block, w // block, c * block * block)


def same_pad(in_size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's SAME split along one axis: ``(before, after)``.

    ``total = max((out - 1) * stride + kernel - in, 0)`` with
    ``out = ceil(in / stride)`` and ``before = total // 2``: a stride-2 3x3
    conv on an even input pads 0 before and 1 after, where torch's
    ``padding=1`` would shift every output.
    """
    out = -(-in_size // stride)
    total = max((out - 1) * stride + kernel - in_size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """``k x k`` conv with SAME padding, like flax ``nn.Conv(padding="SAME")``.

    ``weight (out, in / groups, k, k)``, optional ``bias (out,)``.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = True):
        super().__init__()
        self.stride = stride
        self.groups = groups
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        ph = same_pad(x.shape[-2], k, self.stride)
        pw = same_pad(x.shape[-1], k, self.stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            padding = (ph[0], pw[0])
        else:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            padding = 0
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        padding, 1, self.groups)

    def reset_parameters(self, generator: torch.Generator,
                         std: float | None = None,
                         bias_value: float = 0.0) -> None:
        """Normal init, std ``1/sqrt(fan_in)`` unless given. Drawn on the
        CPU from ``generator`` (a CPU generator), for any device."""
        fan_in = self.weight[0].numel()
        std = 1.0 / math.sqrt(fan_in) if std is None else std
        with torch.no_grad():
            self.weight.copy_(torch.empty(self.weight.shape).normal_(
                0.0, std, generator=generator))
            if self.bias is not None:
                self.bias.fill_(bias_value)


class BatchNorm(nn.Module):
    """Batch norm in the order flax computes it.

    ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias`` in f32, then cast
    to the input's dtype (flax's ``BatchNorm(dtype=bf16)`` promotes the bf16
    input against its f32 statistics and rounds once at the end).

    Eval mode uses the running statistics. Train mode (``self.training``)
    uses the batch's, as flax's ``_compute_stats`` does: the mean and the
    mean square over (N, H, W) in f32, and the fast, biased variance
    ``max(0, E[x^2] - E[x]^2)``; it then updates the running statistics
    with ``momentum`` as a decay, ``r = momentum * r + (1 - momentum) *
    batch`` (torch's own ``momentum`` is the complement).
    """

    def __init__(self, channels: int, eps: float = BATCH_NORM_EPSILON,
                 momentum: float = BATCH_NORM_MOMENTUM):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        xf = x.float()
        if self.training:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.maximum(xf.square().mean(dim=(0, 2, 3))
                                - mean.square(), mean.new_tensor(0.0))
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(self.running_mean * m
                                        + mean * (1 - m))
                self.running_var.copy_(self.running_var * m + var * (1 - m))
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape)
        return (y + self.bias.view(shape)).to(x.dtype)


class ConvBN(nn.Module):
    """Conv, then batch norm (or the conv's own bias), then an activation.

    ``act``: ``"relu6"`` | ``"relu"`` | ``None``.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, use_norm: bool = True,
                 act: str | None = "relu6",
                 bn_momentum: float = BATCH_NORM_MOMENTUM):
        super().__init__()
        self.conv = Conv(in_ch, out_ch, kernel, stride, groups,
                         bias=not use_norm)
        self.bn = BatchNorm(out_ch, momentum=bn_momentum) if use_norm else None
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return activation(x, self.act)


def activation(x: torch.Tensor, act: str | None) -> torch.Tensor:
    if act == "relu6":
        return F.relu6(x)
    if act == "relu":
        return F.relu(x)
    if act is None:
        return x
    raise ValueError(f"unknown activation {act!r}")


class DepthwiseSeparable(nn.Module):
    """MobileNet-v1 block: depthwise 3x3 + pointwise 1x1, each BN + ReLU6."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 bn_momentum: float = BATCH_NORM_MOMENTUM):
        super().__init__()
        self.depthwise = ConvBN(in_ch, in_ch, 3, stride, groups=in_ch,
                                bn_momentum=bn_momentum)
        self.pointwise = ConvBN(in_ch, out_ch, 1, bn_momentum=bn_momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))
