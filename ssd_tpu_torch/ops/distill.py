"""Knowledge distillation losses for dense detection heads.

Counterpart of ``ssd_tpu/ops/distill.py``, term for term. A trained
teacher with the student's head geometry (anchors and class count)
supervises the student through its raw head outputs, with two signals,
both weighted per anchor by the teacher's own foreground confidence
(``max_c sigmoid(teacher logit)``, floored at ``weight_floor``):

  * classification: the temperature-scaled binary KL between the teacher's
    and the student's per-class sigmoid probabilities, times ``T^2``;
  * localization: smooth-L1 between the student's and the teacher's box
    deltas.

Both take the head's per-level layout ``[(cls (N, H, W, K*C), box (N, H,
W, K*4)), ...]`` or the flat ``(logits (N, A, C), deltas (N, A, 4))``.
The teacher's outputs carry no gradient. ``maximum`` and ``abs`` take JAX's
derivatives at a tie, as in ``ops/losses.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ssd_tpu_torch.ops.losses import _abs, _max0


class DistillDict(NamedTuple):
    total: torch.Tensor
    classification: torch.Tensor
    localization: torch.Tensor


def _soft_bce(logits: torch.Tensor, soft_targets: torch.Tensor
              ) -> torch.Tensor:
    """Stable elementwise BCE from logits against SOFT targets."""
    return (_max0(logits) - logits * soft_targets
            + torch.log1p(torch.exp(-_abs(logits))))


def _binary_kl(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
               temperature: float) -> torch.Tensor:
    """Elementwise ``KL(sigmoid(zt/T) || sigmoid(zs/T)) * T^2``, written as
    ``BCE(zs/T, p) - BCE(zt/T, p)`` with ``p = sigmoid(zt/T)``: zero where
    the logits agree, never negative."""
    t = 1.0 / temperature
    zt = teacher_logits * t
    zs = student_logits * t
    p = torch.sigmoid(zt)
    return (temperature * temperature) * (_soft_bce(zs, p)
                                          - _soft_bce(zt, p))


def _pair_loss(s_cls, s_box, t_cls, t_box, num_classes: int,
               temperature: float, weight_floor: float):
    """One layout-matched (cls, box) pair -> unnormalized ``(kl_sum,
    box_sum, w_sum)``, so several levels normalize once together."""
    s_cls = s_cls.float()
    t_cls = t_cls.detach().float()
    lead = tuple(s_cls.shape[:-1])
    k = s_cls.shape[-1] // num_classes
    s5 = s_cls.reshape(lead + (k, num_classes))
    t5 = t_cls.reshape(lead + (k, num_classes))

    # the teacher's foreground-ness per anchor (no temperature), floored so
    # that its calibrated negatives still teach a little
    w = torch.clamp_min(torch.sigmoid(t5).amax(dim=-1), weight_floor)

    kl = _binary_kl(s5, t5, temperature).sum(dim=-1)  # (..., K)
    kl_sum = (kl * w).sum()

    s_box = s_box.float().reshape(lead + (k, 4))
    t_box = t_box.detach().float().reshape(lead + (k, 4))
    diff = _abs(s_box - t_box)
    huber = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    box_sum = (huber.sum(dim=-1) * w).sum()
    return kl_sum, box_sum, w.sum()


def _levels(raw) -> list:
    """The per-level list as it is; a flat ``(logits, deltas)`` pair as a
    one-level list."""
    if isinstance(raw, (list, tuple)) and isinstance(raw[0], (list, tuple)):
        return list(raw)
    return [raw]


def distillation_loss(student_raw, teacher_raw, num_classes: int,
                      temperature: float = 2.0, box_weight: float = 1.0,
                      weight_floor: float = 0.01) -> DistillDict:
    """Teacher -> student distillation loss over raw head outputs; both
    sides in the same layout, with the same head geometry (any backbone).
    Raises on a different number of levels or different class-map
    shapes."""
    s_levels, t_levels = _levels(student_raw), _levels(teacher_raw)
    if len(s_levels) != len(t_levels):
        raise ValueError(
            f"student has {len(s_levels)} output levels, teacher "
            f"{len(t_levels)} — head geometries differ")
    kl_sum = box_sum = w_sum = None
    for (s_cls, s_box), (t_cls, t_box) in zip(s_levels, t_levels):
        if s_cls.shape != t_cls.shape:
            raise ValueError(
                f"student/teacher cls shapes differ: {tuple(s_cls.shape)} vs "
                f"{tuple(t_cls.shape)} (check anchor config / num_classes)")
        a, b, c = _pair_loss(s_cls, s_box, t_cls, t_box, num_classes,
                             temperature, weight_floor)
        if kl_sum is None:
            kl_sum, box_sum, w_sum = a, b, c
        else:
            kl_sum, box_sum, w_sum = kl_sum + a, box_sum + b, w_sum + c
    norm = torch.clamp_min(w_sum, 1.0)
    cls_loss = kl_sum / norm
    box_loss = box_sum / norm
    return DistillDict(cls_loss + box_weight * box_loss, cls_loss, box_loss)
