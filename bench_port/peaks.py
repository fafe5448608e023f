"""The card's published peaks and the kernels' least times.

NVIDIA H100 SXM data sheet, dense rates: 989 TFLOP/s bf16 and 1 979 TOP/s
int8 on the tensor cores, 67 TFLOP/s f32 outside them, HBM at 3.35 TB/s.

The bounds of the port's hand-written kernels are ``chip_smoke.py``'s
arithmetic, copied: each input byte read once and each output byte
written once, and the IoUs that these inputs need, the larger of the two
times.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
DENSE_PEAK = {"bfloat16": 989e12, "int8": 1979e12, "float32": 67e12}

IOU_FLOPS = 12  # 4 min/max, 3 sub, 2 clamp, 1 mul, 1 add, 1 div
MATCH_FLOPS = 13  # the IoU, the union's floor, the compare into each max


def k1_bound_s(n: int, q: int, c: int, k: int, ious: int) -> float:
    """The NMS kernel (``csrc/nms.cu``) on one batch: candidate boxes
    ``(n, q, 4)`` f32 and each problem's ``(n, c, k)`` indices read, the
    kept scores read and written; ``ious`` as greedy suppression needs
    them."""
    nbytes = n * q * 16 + n * c * k * 4 + 2 * n * c * k * 4
    return max(nbytes / HBM_BYTES_PER_S, ious * IOU_FLOPS / F32_FLOP_PER_S)


def k2_bound_s(n: int, a: int, m: int, gts: int) -> float:
    """The matching kernel (``csrc/match.cu``) on one batch: anchors
    ``(a, 4)``, gts ``(n, m, 4)`` and counts read, ``best_gt`` and
    ``best_iou`` ``(n, a)`` and ``best_anchor`` ``(n, m)`` written; one IoU
    for each valid gt and anchor."""
    nbytes = a * 16 + n * m * 16 + n * 4 + n * a * 8 + n * m * 4
    return max(nbytes / HBM_BYTES_PER_S, gts * a * MATCH_FLOPS
               / F32_FLOP_PER_S)
