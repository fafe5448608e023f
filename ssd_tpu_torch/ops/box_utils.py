"""Box geometry on tensors: areas, IoU, IoS, encode, decode, clipping.

Boxes are ``(..., 4)`` tensors of ``(ymin, xmin, ymax, xmax)``, normalized
to ``[0, 1]``. The arithmetic follows ``ssd_tpu/ops/box_utils.py`` operation
for operation, so f32 results agree with it to the rounding of each op.
"""

from __future__ import annotations

import torch

from ssd_tpu_torch.constants import EPSILON, SCALE_FACTORS


def area(boxes: torch.Tensor) -> torch.Tensor:
    """``(..., 4) -> (...)``. Degenerate boxes get area 0."""
    ymin, xmin, ymax, xmax = boxes.unbind(-1)
    return (ymax - ymin).clamp_min(0.0) * (xmax - xmin).clamp_min(0.0)


def intersection(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """``(..., N, 4) x (..., M, 4) -> (..., N, M)`` intersection areas."""
    ymin1, xmin1, ymax1, xmax1 = (v[..., :, None] for v in boxes1.unbind(-1))
    ymin2, xmin2, ymax2, xmax2 = (v[..., None, :] for v in boxes2.unbind(-1))
    h = (torch.minimum(ymax1, ymax2)
         - torch.maximum(ymin1, ymin2)).clamp_min(0.0)
    w = (torch.minimum(xmax1, xmax2)
         - torch.maximum(xmin1, xmin2)).clamp_min(0.0)
    return h * w


def iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """``(..., N, 4) x (..., M, 4) -> (..., N, M)`` IoU in ``[0, 1]``."""
    inter = intersection(boxes1, boxes2)
    union = area(boxes1)[..., :, None] + area(boxes2)[..., None, :] - inter
    return inter / union.clamp_min(EPSILON)


def ios(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """``(..., N, 4) x (..., M, 4) -> (..., N, M)`` intersection over the
    smaller area (the overlap coefficient) in ``[0, 1]``: a box inside
    another scores 1 whatever their sizes, the merge measure where one
    detection may be a clipped fragment of another (tiled inference)."""
    inter = intersection(boxes1, boxes2)
    smaller = torch.minimum(area(boxes1)[..., :, None],
                            area(boxes2)[..., None, :])
    return inter / smaller.clamp_min(EPSILON)


def to_center_form(boxes: torch.Tensor) -> torch.Tensor:
    """``(ymin, xmin, ymax, xmax) -> (cy, cx, h, w)``."""
    ymin, xmin, ymax, xmax = boxes.unbind(-1)
    h = ymax - ymin
    w = xmax - xmin
    return torch.stack([ymin + 0.5 * h, xmin + 0.5 * w, h, w], dim=-1)


def to_corner_form(boxes: torch.Tensor) -> torch.Tensor:
    """``(cy, cx, h, w) -> (ymin, xmin, ymax, xmax)``."""
    cy, cx, h, w = boxes.unbind(-1)
    return torch.stack(
        [cy - 0.5 * h, cx - 0.5 * w, cy + 0.5 * h, cx + 0.5 * w], dim=-1)


def encode(boxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Corner-form boxes -> regression codes ``(ty, tx, th, tw)``:
    ``ty = (cy - cy_a) / h_a * s_y``, ``th = log(h / h_a) * s_h`` (same for
    x and w), with every size clamped to ``EPSILON`` first."""
    cy, cx, h, w = to_center_form(boxes).unbind(-1)
    cya, cxa, ha, wa = to_center_form(anchors).unbind(-1)
    ha, wa = ha.clamp_min(EPSILON), wa.clamp_min(EPSILON)
    h, w = h.clamp_min(EPSILON), w.clamp_min(EPSILON)
    sy, sx, sh, sw = SCALE_FACTORS
    return torch.stack([(cy - cya) / ha * sy, (cx - cxa) / wa * sx,
                        torch.log(h / ha) * sh, torch.log(w / wa) * sw],
                       dim=-1)


def decode(codes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Regression codes ``(ty, tx, th, tw)`` -> corner-form boxes.

    Differentiable as JAX differentiates it: the size clamp is a
    ``minimum``, whose gradient splits at a tie (``clamp_max`` would not).
    """
    ty, tx, th, tw = codes.unbind(-1)
    cya, cxa, ha, wa = to_center_form(anchors).unbind(-1)
    sy, sx, sh, sw = SCALE_FACTORS
    # Clamp the size terms so exp() cannot overflow for garbage logits.
    ten = codes.new_full((), 10.0)
    th = torch.minimum(th / sh, ten)
    tw = torch.minimum(tw / sw, ten)
    cy = ty / sy * ha + cya
    cx = tx / sx * wa + cxa
    h = torch.exp(th) * ha
    w = torch.exp(tw) * wa
    return torch.stack(
        [cy - 0.5 * h, cx - 0.5 * w, cy + 0.5 * h, cx + 0.5 * w], dim=-1)


def clip_boxes(boxes: torch.Tensor) -> torch.Tensor:
    """Clip corner-form boxes to the unit square."""
    return boxes.clamp(0.0, 1.0)
