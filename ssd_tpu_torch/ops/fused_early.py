"""ds1 + ds2 of the reference MobileNet-v1 schedule in one pass, batch norm
folded: the fold, and the plain PyTorch version of the fused kernel.

Counterpart of ``ssd_tpu/ops/fused_early.py`` (``fold_convbn``,
``fold_early_params`` and the function its Pallas kernel computes). The
kernel itself is ``csrc/fused_early.cu``, launched by
``ops/fused_early_cuda.py``.

The function, on ``x (N, C1, H, W)`` with H and W even, with its rounding
points (the pointwise products take bf16 operands on the tensor cores,
with f32 sums; everything else is f32):

1. x (bf16) is widened to f32;
2. dw1: depthwise 3x3, stride 1, SAME (1 on every side), + bias, relu6,
   in f32; **rounded to bf16** (pw1's A operand);
3. pw1: 1x1 from C1 to C2, the bf16 A times ``pw1_k`` split into two
   bf16 terms, ``hi = bf16(k)`` and ``lo = bf16(k - hi)``: both products
   exact in f32, sums in f32, + bias (f32), relu6. The result stays
   **f32**;
4. dw2: depthwise 3x3, stride 2, SAME on an even input (0 before, 1
   after: the padded row H and column W of pw1's output are zero), +
   bias, relu6, in f32; **rounded to bf16** (pw2's A operand);
5. pw2: 1x1 from C2 to C3, the bf16 A times ``pw2_k`` as hi + lo, f32
   sums, + bias, relu6, **rounded to bf16** once -> ``(N, C3, H/2, W/2)``.

The TPU kernel's products are ``jnp.dot`` at default precision: one bf16
pass on the MXU, which rounds the weights to bf16 as well. That single
term misses the JAX package's own bars (atol 0.08, rtol 0.05) against the
flax blocks where a sum of large products cancels: with the pointwise
batch-norm scales raised 8x, by 0.389 on 62 of 15 360 outputs
(``tests/test_torch_fused_early.py``'s saturated case). Rounding only the
activations stays within them (0.101 at most), and hi + lo carries a
weight to about 2^-17 of itself.

Each depthwise output adds its 9 taps in (dy, dx) order, starting from the
first product, then the bias; every product and sum is rounded to f32 on
its own, and the kernel does the same (built without FMA contraction), so
the depthwise stages agree bit for bit. Each pointwise output here adds,
channel by channel from the first, ``A * hi`` then ``A * lo``, then the
bias; the kernel's tensor cores sum the same exact products in their own
order, so its f32 sums may differ in the last bits, and its output rarely
by one bf16 step.

The folded operands keep the port's layout, none of the TPU's: ``dw*_k (C,
3, 3)``, ``pw*_k (C_in, C_out)``, biases ``(C,)``, all f32. There is no
``w_img`` tiling and no block-diagonal pixel grouping.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ssd_tpu_torch.constants import BATCH_NORM_EPSILON

FOLDED_KEYS = ("dw1_k", "dw1_b", "pw1_k", "pw1_b", "dw2_k", "dw2_b",
               "pw2_k", "pw2_b")


def fold_convbn(kernel: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                mean: torch.Tensor, var: torch.Tensor,
                eps: float = BATCH_NORM_EPSILON):
    """Fold inference batch norm into the conv before it: ``(kernel * s,
    bias - mean * s)`` with ``s = scale / sqrt(var + eps)`` in f32, the JAX
    package's formula. ``kernel`` is OIHW; ``s`` scales its output axis.

    The square root is taken in f64 and rounded to f32, which is the
    correctly rounded f32 root (numpy's): PyTorch's f32 ``sqrt`` on the CPU
    is not always, and then the fold would differ in the last bit."""
    root = torch.sqrt((var.float() + eps).double()).float()
    s = scale.float() / root
    return (kernel.float() * s.view(-1, 1, 1, 1), bias.float() - mean.float() * s)


def fold_early_params(backbone, eps: float = BATCH_NORM_EPSILON) -> dict:
    """ds1 and ds2 of a reference-schedule ``MobileNetV1`` (or its state
    dict) -> the kernel's f32 operands (``FOLDED_KEYS``), on the weights'
    device."""
    sd = backbone.state_dict() if isinstance(backbone, torch.nn.Module) \
        else backbone

    def block(name: str):
        with torch.no_grad():
            return fold_convbn(sd[f"{name}.conv.weight"], sd[f"{name}.bn.weight"],
                               sd[f"{name}.bn.bias"], sd[f"{name}.bn.running_mean"],
                               sd[f"{name}.bn.running_var"], eps)

    dw1_k, dw1_b = block("ds1.depthwise")  # (C1, 1, 3, 3)
    pw1_k, pw1_b = block("ds1.pointwise")  # (C2, C1, 1, 1)
    dw2_k, dw2_b = block("ds2.depthwise")  # (C2, 1, 3, 3)
    pw2_k, pw2_b = block("ds2.pointwise")  # (C3, C2, 1, 1)
    return {
        "dw1_k": dw1_k[:, 0].contiguous(), "dw1_b": dw1_b.contiguous(),
        "pw1_k": pw1_k[:, :, 0, 0].t().contiguous(), "pw1_b": pw1_b.contiguous(),
        "dw2_k": dw2_k[:, 0].contiguous(), "dw2_b": dw2_b.contiguous(),
        "pw2_k": pw2_k[:, :, 0, 0].t().contiguous(), "pw2_b": pw2_b.contiguous(),
    }


def _relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def _depthwise(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor,
               pad: tuple[int, int, int, int], stride: int) -> torch.Tensor:
    """``x (N, C, H, W)`` f32, ``pad`` as ``F.pad``'s (left, right, top,
    bottom); the 9 taps in (dy, dx) order, then the bias, then relu6."""
    xp = F.pad(x, pad)
    ho = (xp.shape[2] - 3) // stride + 1
    wo = (xp.shape[3] - 3) // stride + 1
    acc = None
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, :, dy:dy + stride * (ho - 1) + 1:stride,
                     dx:dx + stride * (wo - 1) + 1:stride]
            tap = tap * k[:, dy, dx].view(1, -1, 1, 1)
            acc = tap if acc is None else acc + tap
    return _relu6(acc + b.view(1, -1, 1, 1))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (to nearest, ties to even), back in f32."""
    return x.to(torch.bfloat16).float()


def split_bf16(k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 ``k`` as two bf16 terms (in f32): ``hi = bf16(k)``, ``lo =
    bf16(k - hi)``; ``k - hi`` is exact in f32."""
    hi = _bf16(k)
    return hi, _bf16(k - hi)


def _pointwise(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x (N, C_in, H, W)`` rounded to bf16, ``k (C_in, C_out)`` split into
    ``hi + lo``: for each input channel in order, ``x * hi`` then ``x *
    lo`` added (each product exact), then the bias, then relu6."""
    x = _bf16(x)
    hi, lo = split_bf16(k)
    acc = None
    for c in range(k.shape[0]):
        for part in (hi, lo):
            term = x[:, c:c + 1] * part[c].view(1, -1, 1, 1)
            acc = term if acc is None else acc + term
    return _relu6(acc + b.view(1, -1, 1, 1))


def fused_ds1_ds2_plain(x: torch.Tensor, folded: dict) -> torch.Tensor:
    """The plain version: ``x (N, C1, H, W)`` (bf16) -> ``(N, C3, H/2,
    W/2)`` bf16 in ``channels_last``, on any device, rounding at the module
    docstring's points."""
    y = _depthwise(x.float(), folded["dw1_k"], folded["dw1_b"], (1, 1, 1, 1), 1)
    y = _pointwise(y, folded["pw1_k"], folded["pw1_b"])
    z = _depthwise(y, folded["dw2_k"], folded["dw2_b"], (0, 1, 0, 1), 2)
    z = _pointwise(z, folded["pw2_k"], folded["pw2_b"])
    return z.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
