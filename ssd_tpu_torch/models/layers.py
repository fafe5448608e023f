"""Shared building blocks: SAME-padded conv, batch norm (flax's semantics in
train and eval mode), group norm (flax's), ConvBN, the MobileNet-v1
depthwise-separable block, ShuffleNet's channel shuffle, a SAME max-pool,
and the int8 inference conv ``QuantConv`` with its calibration mode.

Layout is NCHW inside the model. Parameters live in f32; each conv casts its
weight to the activation's dtype (bf16 or f32) when it runs, as flax does
with ``param_dtype=float32`` and ``dtype=compute_dtype``. Module and
parameter names follow the flax tree (``conv``, ``bn``, ``gn``,
``depthwise``, ``pointwise``), so ``convert.py`` maps one to the other by path.

int8 (``compute_dtype="int8"``, inference only): every dense conv runs
s8 x s8 -> s32 through ``torch._int_mm`` (cuBLASLt's integer GEMM on the
card) over an im2col of the quantized NHWC input, then dequantizes in f32;
depthwise convs, norms and activations run in bf16. Integer sums are exact
in any order, so the s32 products equal the JAX package's bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from fractions import Fraction

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ssd_tpu_torch.constants import BATCH_NORM_EPSILON, BATCH_NORM_MOMENTUM
from ssd_tpu_torch.parallel.mesh import all_reduce_mean, step_group

# int8 computes norms, activations and depthwise convs in bf16; its dense
# convs take the quantized path (``QuantConv``).
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int8": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise NotImplementedError(
            f"compute_dtype={name!r}: the port builds bfloat16, float32 "
            "and int8")
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
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv(x, self.weight.to(x.dtype), bias)

    def _conv(self, x: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor | None) -> torch.Tensor:
        k = weight.shape[-1]
        ph = same_pad(x.shape[-2], k, self.stride)
        pw = same_pad(x.shape[-1], k, self.stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            padding = (ph[0], pw[0])
        else:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            padding = 0
        return F.conv2d(x, weight, bias, self.stride, padding, 1, self.groups)

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


_local = threading.local()


@contextlib.contextmanager
def recomputing():
    """Within the block a train-mode ``BatchNorm`` leaves its running
    statistics alone: an activation checkpoint's recompute reruns the
    forward, whose update has already run once. Per thread (the autograd
    engine recomputes in its own)."""
    prev = getattr(_local, "recomputing", False)
    _local.recomputing = True
    try:
        yield
    finally:
        _local.recomputing = prev


def checkpoint(fn, *args):
    """``fn(*args)`` under an activation checkpoint: its inner activations
    are not kept but recomputed in the backward, without a second update
    of any batch norm's running statistics (``recomputing``)."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), recomputing()))


class _Recomputed(torch.autograd.Function):
    """``fn(x, weight, bias) -> (y, *stats)`` that saves only its three
    inputs, as they arrive (a bf16 ``x`` stays bf16). The backward reruns
    ``fn`` under autograd on the saved inputs and backpropagates ``y``'s
    gradient through it: the same ops in the same order as autograd of
    ``fn`` itself, so the gradients are bit-equal to it, while the norm's
    f32 intermediates live for one norm's backward instead of the whole
    step. ``stats`` are returned without a gradient."""

    @staticmethod
    def forward(ctx, fn, x, weight, bias):
        ctx.fn = fn
        ctx.save_for_backward(x, weight, bias)
        y, *stats = fn(x, weight, bias)
        ctx.mark_non_differentiable(*stats)
        return (y, *stats)

    @staticmethod
    def backward(ctx, gy, *_):
        need = ctx.needs_input_grad[1:]
        inputs = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
        wanted = [t for t, n in zip(inputs, need) if n]
        grads = iter(())
        if wanted:
            with torch.enable_grad():
                y = ctx.fn(*inputs)[0]
            grads = iter(torch.autograd.grad(y, wanted, gy))
        return (None, *(next(grads) if n else None for n in need))


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
    batch`` (torch's own ``momentum`` is the complement), once a forward
    (not in a checkpoint's recompute, ``recomputing``). Train mode keeps
    only its input for the backward (``_Recomputed``), not its f32 copies
    of it.

    Inside a data-parallel step (``parallel.mesh.data_parallel``) the two
    means are averaged over the ranks, which hold the same number of rows:
    the global statistics of the global batch, as flax takes them under
    GSPMD, with the global gradient (the all-reduce's backward is another
    all-reduce), and the same running statistics on every rank. The
    backward reruns the norm and so its collective: every rank runs the
    same norms in the same order, so the collectives pair up. Group norm
    is per image and needs nothing of this.
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

    def _train_norm(self, x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, group=None):
        """The batch-statistics norm -> ``(y, mean, var)``; over the ranks
        of ``group`` when given."""
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        mean_sq = xf.square().mean(dim=(0, 2, 3))
        if group is not None:
            mean, mean_sq = all_reduce_mean(torch.stack([mean, mean_sq]),
                                            group).unbind(0)
        var = torch.maximum(mean_sq - mean.square(), mean.new_zeros(()))
        return self._affine(x, xf, mean, var, weight, bias), mean, var

    def _affine(self, x, xf, mean, var, weight, bias) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * weight
        y = (xf - mean.view(shape)) * mul.view(shape)
        return (y + bias.view(shape)).to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return self._affine(x, x.float(), self.running_mean,
                                self.running_var, self.weight, self.bias)
        group = step_group()
        fn = (self._train_norm if group is None
              else functools.partial(self._train_norm, group=group))
        y, mean, var = _Recomputed.apply(fn, x, self.weight, self.bias)
        if not getattr(_local, "recomputing", False):
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(self.running_mean * m
                                        + mean * (1 - m))
                self.running_var.copy_(self.running_var * m + var * (1 - m))
        return y


def num_groups(channels: int, target: int = 32) -> int:
    """Largest divisor of ``channels`` that is <= ``target`` (the JAX
    package's ``_num_groups``): 32 for 128, 24 for 24, 29 for 116."""
    g = min(target, channels)
    while channels % g:
        g -= 1
    return g


class GroupNorm(nn.Module):
    """Group norm in the order flax's ``GroupNorm`` computes it.

    The statistics of each image and group of ``C / G`` channels
    (``G = num_groups(C)``) over (H, W, C/G) in f32, with the fast, biased
    variance ``max(0, E[x^2] - E[x]^2)`` (``torch.group_norm`` takes a
    two-pass variance, which differs); then, per channel, ``y = (x - mean)
    * (rsqrt(var + eps) * scale) + bias`` in f32, rounded once to the
    input's dtype. No running statistics: train and eval mode are the same
    function. It keeps only its input for the backward (``_Recomputed``).
    """

    def __init__(self, channels: int, eps: float = BATCH_NORM_EPSILON):
        super().__init__()
        self.groups = num_groups(channels)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def _norm(self, x: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor) -> tuple[torch.Tensor]:
        n, c = x.shape[:2]
        xf = x.float()
        xg = xf.reshape(n, self.groups, -1)
        mean = xg.mean(dim=-1)
        var = torch.maximum(xg.square().mean(dim=-1) - mean.square(),
                            mean.new_zeros(()))
        size = c // self.groups
        mean = mean.repeat_interleave(size, dim=1)  # (N, C)
        var = var.repeat_interleave(size, dim=1)
        mul = torch.rsqrt(var + self.eps) * weight
        y = (xf - mean[..., None, None]) * mul[..., None, None]
        return ((y + bias.view(1, -1, 1, 1)).to(x.dtype),)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _Recomputed.apply(self._norm, x, self.weight, self.bias)[0]


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """ShuffleNet's channel shuffle on NCHW: output channel ``j * groups +
    i`` is input channel ``i * (C / groups) + j`` (the JAX package's NHWC
    reshape to ``(groups, C / groups)`` and swap)."""
    n, c, h, w = x.shape
    x = x.reshape(n, groups, c // groups, h, w).transpose(1, 2)
    return x.reshape(n, c, h, w)


def max_pool_same(x: torch.Tensor, kernel: int = 3,
                  stride: int = 2) -> torch.Tensor:
    """``nn.max_pool(x, (k, k), (s, s), "SAME")`` on NCHW: XLA's SAME split
    (0 before and 1 after for 3/2 on an even input), padded with -inf, then
    an unpadded pool (``padding=1`` would pad both sides and shift every
    output)."""
    ph = same_pad(x.shape[-2], kernel, stride)
    pw = same_pad(x.shape[-1], kernel, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=-math.inf)
    return F.max_pool2d(x, kernel, stride)


# ---------------------------------------------------------------- int8

INT8_MAX = 127.0
# f32(1 / 127): the JAX package divides by the constant 127, and XLA
# compiles every division by a constant into a multiply by its f32
# reciprocal, which is what its jitted programs (serving, calibration)
# compute; division by a scale that is a variable stays a division.
INT8_RECIP = float(np.float32(1.0) / np.float32(INT8_MAX))
SCALE_FLOOR = 1e-8  # both scales' floor (an all-zero input or channel)
SCALE_PREFIX = "act_scale_"


def scale_key(x: torch.Tensor) -> str:
    """The activation scale's key for an NCHW input: ``act_scale_{H}x{W}``
    (the JAX package's name for its NHWC input of the same size)."""
    return f"{SCALE_PREFIX}{x.shape[-2]}x{x.shape[-1]}"


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of an OIHW f32 kernel -> ``(k_q s8
    of w's shape, k_scale (O,) f32)``: ``k_scale = max(absmax / 127,
    1e-8)`` (as ``absmax * f32(1/127)``), ``k_q = clip(round(w / k_scale),
    -127, 127)``."""
    absmax = w.abs().amax(dim=(1, 2, 3))
    k_scale = torch.clamp_min(absmax * INT8_RECIP, SCALE_FLOOR)
    k_q = torch.round(w / k_scale.view(-1, 1, 1, 1))
    return torch.clamp(k_q, -INT8_MAX, INT8_MAX).to(torch.int8), k_scale


def quantize_activation(x: torch.Tensor, a_scale: torch.Tensor,
                        reciprocal: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """NCHW float -> NHWC s8: ``clip(round(x / a_scale), -127, 127)``,
    rounded half to even (as ``jnp.round``). ``a_scale`` is a tensor on
    ``x``'s device, so the quotient is a division (a CUDA tensor over a CPU
    scalar would be multiplied by its reciprocal). With ``reciprocal``,
    ``round(x * reciprocal)``: the JAX package's static scale is a
    constant, whose division XLA compiles into that multiply."""
    xf = x.permute(0, 2, 3, 1).float()
    xq = torch.round(xf / a_scale if reciprocal is None else xf * reciprocal)
    return torch.clamp(xq, -INT8_MAX, INT8_MAX).to(torch.int8).contiguous()


def im2col(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """NHWC ``(N, H, W, C)`` -> ``(N, Ho, Wo, k*k*C)``: the ``k x k`` taps of
    each SAME-padded output gathered along channels in ``(dy, dx, c)``
    order. A 1x1 stride-1 conv needs none: ``x`` comes back as it is.
    (``F.unfold`` has no int8 kernel.)"""
    if kernel == 1 and stride == 1:
        return x
    _, h, w, _ = x.shape
    ph, pw = same_pad(h, kernel, stride), same_pad(w, kernel, stride)
    ho, wo = -(-h // stride), -(-w // stride)
    xp = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    taps = [xp[:, dy:dy + stride * (ho - 1) + 1:stride,
               dx:dx + stride * (wo - 1) + 1:stride]
            for dy in range(kernel) for dx in range(kernel)]
    return torch.cat(taps, dim=-1)


def int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a (M, K) @ w (N, K).T``, s8 x s8 -> s32, exact, by
    ``torch._int_mm`` (cuBLASLt's integer GEMM on the card). Its CUDA shape
    limits (M > 16, K and N multiples of 8) are met by zero padding, on
    every device, and the padding is sliced off: zero rows, columns and
    depth add no products."""
    m, k = a.shape
    n = w.shape[0]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w = F.pad(w, (0, kp - k, 0, np_ - n))
    return torch._int_mm(a, w.t())[:m, :n]


def conv_int8(x_q: torch.Tensor, k_q: torch.Tensor,
              stride: int) -> torch.Tensor:
    """SAME conv of the s8 NHWC input with the s8 OIHW kernel -> s32 NHWC,
    one product over the im2col."""
    o, c, k, _ = k_q.shape
    cols = im2col(x_q, k, stride)
    n, ho, wo, _ = cols.shape
    w = k_q.permute(0, 2, 3, 1).reshape(o, k * k * c)
    return int_mm(cols.reshape(-1, k * k * c), w).reshape(n, ho, wo, o)


def dequantize(y: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor | None) -> torch.Tensor:
    """s32 -> bf16 in the JAX package's order: ``y_f32 * scale`` (``scale``
    the product ``a_scale * k_scale``, formed first), ``+ bias`` in f32,
    one rounding."""
    y = y.float() * scale
    if bias is not None:
        y = y + bias
    return y.to(torch.bfloat16)


def _fma_f32(a, b, c) -> np.float32:
    """``a * b + c`` rounded once to f32, to nearest even."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(exact))
    near = (r, np.nextafter(r, np.float32(-np.inf)),
            np.nextafter(r, np.float32(np.inf)))
    return min(near, key=lambda v: (abs(Fraction(float(v)) - exact),
                                    int(v.view(np.int32)) & 1))


def percentile(x: torch.Tensor, p: float) -> torch.Tensor:
    """``jnp.percentile(x, p)`` (linear) over all of ``x`` as the JAX
    package's calibration computes it on the CPU (``p`` a constant of the
    jitted program), bit for bit, as a 0-dim f32 tensor on ``x``'s device:

    * JAX's f32 index arithmetic: ``q = p / 100``, ``idx = q * (n - 1)``,
      ``n`` cast to f32, so above 2^24 elements the index rounds as there;
      the weights ``idx - floor(idx)`` and ``1 - that``;
    * the two order statistics by ``kthvalue``, for any size
      (``torch.quantile`` refuses more than 2^24 elements);
    * ``low * w_low + high * w_high`` with the first product and the sum
      rounded once: XLA:CPU contracts that multiply-add into an FMA.
    """
    flat = x.reshape(-1).float()
    f32 = np.float32
    n = f32(flat.numel())
    idx = (f32(p) / f32(100.0)) * (n - f32(1.0))
    low, high = np.floor(idx), np.ceil(idx)
    high_w = idx - low
    low_w = f32(1.0) - high_w
    last = flat.numel() - 1  # n - 1 in f32 can round past it: XLA's gather

    def at(i) -> float:  # clamps its index into range
        k = min(int(min(max(i, f32(0.0)), n - 1)), last)
        return torch.kthvalue(flat, k + 1).values.item()

    low_v, high_v = at(low), at(high)
    out = _fma_f32(low_v, low_w, f32(high_v) * high_w)
    return torch.tensor(out, device=x.device)


@dataclasses.dataclass(frozen=True)
class Calibration:
    """A calibration pass: each ``QuantConv`` records ``max|x| / 127``
    (``percentile=None``) or ``percentile(|x|, p) / 127`` of its input."""

    percentile: float | None = None


@contextlib.contextmanager
def calibrating(model: nn.Module, percentile: float | None = None):
    """Every ``QuantConv`` of ``model`` in calibration mode for the block:
    it runs the plain bf16 conv and max-accumulates its observed input
    scale into its shape-keyed scale (seeded at 0), so scales only widen
    across batches and calls. No scale is created outside this mode."""
    convs = [m for m in model.modules() if isinstance(m, QuantConv)]
    if not convs:
        raise ValueError("the model has no quantized convs: is "
                         "model.compute_dtype 'int8'?")
    mode = Calibration(percentile)
    for m in convs:
        m.calibration = mode
    try:
        yield
    finally:
        for m in convs:
            m.calibration = None


class QuantConv(Conv):
    """int8 x int8 -> int32 SAME conv with per-output-channel weight scales
    (``ssd_tpu/models/layers.py`` ``QuantConv``). Same parameters as
    ``Conv``, so bf16-trained weights load unchanged.

    The activation scale, in this order: a calibrated scale for this input
    shape (a 0-dim f32 buffer ``act_scale_{H}x{W}``, floored at 1e-8), one
    per pyramid level for the shared head subnets; else, with
    ``require_scale`` (an input that is an unbounded sum), a ValueError;
    else the static ``act_range / 127``. Calibrated scales are state: they
    load from and save to the state dict under the conv's path.

    In train mode the float conv runs (int8 is an inference lowering); in
    calibration mode (``calibrating``) the plain bf16 conv runs, the bias
    added in bf16.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 bias: bool = True, act_range: float = 6.0,
                 require_scale: bool = False):
        super().__init__(in_ch, out_ch, kernel, stride, bias=bias)
        self.require_scale = require_scale
        self.calibration: Calibration | None = None
        self.path = ""  # the module's name in the model, for errors
        static = np.float32(act_range / INT8_MAX)
        self.register_buffer("static_scale", torch.tensor(static),
                             persistent=False)
        self.register_buffer("static_reciprocal",
                             torch.tensor(np.float32(1.0) / static),
                             persistent=False)

    def act_scale(self, x: torch.Tensor) -> torch.Tensor | None:
        """The calibrated activation scale for input ``x`` (0-dim f32, on
        its device); ``None``: the static scale serves."""
        scale = self._buffers.get(scale_key(x))
        if scale is not None:
            return torch.clamp_min(scale, SCALE_FLOOR)
        if self.require_scale:
            raise ValueError(
                f"int8 conv {self.path!r} needs a calibrated activation "
                f"scale for input {x.shape[-2]}x{x.shape[-1]} (its input is "
                "an unbounded sum; the static ReLU6 bound does not apply). "
                "Calibrate the artifact at this image size: python -m "
                "ssd_tpu_torch.quant (see ssd_tpu_torch/quant.py).")
        return None

    def product(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """-> ``(y s32 NHWC, a_scale * k_scale (O,) f32)``: the integer
        product and its dequantization scale."""
        a_scale = self.act_scale(x)
        if a_scale is None:
            a_scale = self.static_scale
            x_q = quantize_activation(x, a_scale, self.static_reciprocal)
        else:
            x_q = quantize_activation(x, a_scale)
        k_q, k_scale = quantize_weight(self.weight)
        return conv_int8(x_q, k_q, self.stride), a_scale * k_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return super().forward(x)
        if self.calibration is not None:
            return self._calibrate(x)
        y, scale = self.product(x)
        return dequantize(y, scale, self.bias).permute(0, 3, 1, 2)

    def _calibrate(self, x: torch.Tensor) -> torch.Tensor:
        ax = x.float().abs()
        p = self.calibration.percentile
        observed = (ax.amax() if p is None else percentile(ax, p)) * INT8_RECIP
        key = scale_key(x)
        old = self._buffers.get(key)
        self.register_buffer(
            key, observed if old is None else torch.maximum(old, observed))
        bf16 = torch.bfloat16
        y = self._conv(x.to(bf16), self.weight.to(bf16), None)
        if self.bias is None:
            return y
        return y + self.bias.to(bf16).view(-1, 1, 1)

    def _load_from_state_dict(self, state_dict, prefix, *args) -> None:
        # the scales in the state dict replace this conv's own: they are
        # not fixed parameters, so they are taken, never missing
        for key in [k for k in self._buffers if k.startswith(SCALE_PREFIX)]:
            del self._buffers[key]
        mine = {k: v for k, v in state_dict.items()
                if k.startswith(prefix + SCALE_PREFIX)
                and "." not in k[len(prefix):]}
        rest = {k: v for k, v in state_dict.items() if k not in mine}
        super()._load_from_state_dict(rest, prefix, *args)
        for k, v in mine.items():
            self.register_buffer(k[len(prefix):], v.detach().to(
                self.weight.device, torch.float32).reshape(()).clone())


class ConvBN(nn.Module):
    """Conv, then a norm (or the conv's own bias), then an activation.

    ``norm``: ``"batch"`` (the module ``bn``) or ``"group"`` (``gn``, as
    the flax tree names them). ``act``: ``"relu6"`` | ``"relu"`` |
    ``None``. ``quant``: a dense (``groups == 1``) conv is a ``QuantConv``
    (int8 inference) with this ``act_range`` and ``require_scale``; a
    depthwise one stays ``Conv``.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, use_norm: bool = True,
                 act: str | None = "relu6",
                 bn_momentum: float = BATCH_NORM_MOMENTUM,
                 quant: bool = False, act_range: float = 6.0,
                 require_scale: bool = False, norm: str = "batch"):
        super().__init__()
        if quant and groups == 1:
            self.conv = QuantConv(in_ch, out_ch, kernel, stride,
                                  bias=not use_norm, act_range=act_range,
                                  require_scale=require_scale)
        else:
            self.conv = Conv(in_ch, out_ch, kernel, stride, groups,
                             bias=not use_norm)
        self.bn = self.gn = None
        if use_norm and norm == "group":
            self.gn = GroupNorm(out_ch)
        elif use_norm:
            self.bn = BatchNorm(out_ch, momentum=bn_momentum)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        elif self.gn is not None:
            x = self.gn(x)
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
    """MobileNet-v1 block: depthwise 3x3 + pointwise 1x1, each BN + ReLU6;
    with ``quant`` the pointwise conv is int8 (static ReLU6 scale unless
    calibrated)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 bn_momentum: float = BATCH_NORM_MOMENTUM,
                 quant: bool = False, norm: str = "batch"):
        super().__init__()
        self.depthwise = ConvBN(in_ch, in_ch, 3, stride, groups=in_ch,
                                bn_momentum=bn_momentum, norm=norm)
        self.pointwise = ConvBN(in_ch, out_ch, 1, bn_momentum=bn_momentum,
                                quant=quant, norm=norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))
