"""Detection losses: sigmoid focal loss, smooth-L1, IoU-family box losses,
OHEM and L2.

Counterpart of ``ssd_tpu/ops/losses.py``, term for term and in its op
order. Both losses are divided by the batch's number of positive anchors
(at least 1), as in RetinaNet.

Gradients follow JAX's where the two frameworks differ at a tie:
``maximum``/``minimum`` are ``torch.maximum``/``torch.minimum``, whose
gradient splits 0.5/0.5 at a tie as ``jnp.maximum`` does (``clamp_min``
would give 1), and ``abs`` has gradient 1 at 0 as ``jnp.abs`` does
(``torch.abs`` has 0; it reaches the focal loss through ``exp(-|x|)`` at a
logit of exactly 0).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ssd_tpu_torch.config import LossConfig
from ssd_tpu_torch.ops import box_utils
from ssd_tpu_torch.ops.targets import Targets

_EPS = 1e-8


class LossDict(NamedTuple):
    total: torch.Tensor
    classification: torch.Tensor
    localization: torch.Tensor
    num_positives: torch.Tensor


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` with JAX's derivative: 1 at 0."""
    return torch.where(x >= 0, x, -x)


def _max0(x: torch.Tensor) -> torch.Tensor:
    return torch.maximum(x, x.new_zeros(()))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float, gamma: float) -> torch.Tensor:
    """Per-element focal loss ``-alpha_t (1 - p_t)^gamma log(p_t)`` from
    logits, in the stable form; the caller masks and reduces."""
    bce = (_max0(logits) - logits * targets
           + torch.log1p(torch.exp(-_abs(logits))))
    prob = torch.sigmoid(logits)
    p_t = prob * targets + (1.0 - prob) * (1.0 - targets)
    alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
    return alpha_t * torch.pow(1.0 - p_t, gamma) * bce


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   delta: float = 1.0) -> torch.Tensor:
    """Per-element Huber / smooth-L1; the caller masks and reduces."""
    diff = _abs(pred - target)
    return torch.where(diff < delta, 0.5 * diff * diff / delta,
                       diff - 0.5 * delta)


def iou_box_loss(pred: torch.Tensor, target: torch.Tensor,
                 kind: str = "giou") -> torch.Tensor:
    """Aligned IoU-family loss on corner-form boxes, ``(..., 4) x (..., 4)
    -> (...)``: ``giou`` (1 - IoU + (C - union) / C, C the enclosing box),
    ``diou`` (1 - IoU + centre distance^2 / enclosing diagonal^2) or
    ``ciou`` (diou plus the aspect term, its weight held constant)."""
    py0, px0, py1, px1 = pred.unbind(-1)
    ty0, tx0, ty1, tx1 = target.unbind(-1)
    mx, mn = torch.maximum, torch.minimum

    ph = _max0(py1 - py0)
    pw = _max0(px1 - px0)
    th = _max0(ty1 - ty0)
    tw = _max0(tx1 - tx0)

    ih = _max0(mn(py1, ty1) - mx(py0, ty0))
    iw = _max0(mn(px1, tx1) - mx(px0, tx0))
    inter = ih * iw
    union = ph * pw + th * tw - inter
    eps = pred.new_full((), _EPS)
    iou = inter / mx(union, eps)

    eh = mx(py1, ty1) - mn(py0, ty0)
    ew = mx(px1, tx1) - mn(px0, tx0)

    if kind == "giou":
        c_area = eh * ew
        return 1.0 - iou + (c_area - union) / mx(c_area, eps)

    d2 = ((py0 + py1 - ty0 - ty1) ** 2 + (px0 + px1 - tx0 - tx1) ** 2) / 4.0
    c2 = mx(eh * eh + ew * ew, eps)
    diou = 1.0 - iou + d2 / c2
    if kind == "diou":
        return diou
    if kind == "ciou":
        v = (4.0 / math.pi ** 2) * (
            torch.atan(tw / mx(th, eps)) - torch.atan(pw / mx(ph, eps))) ** 2
        alpha = (v / mx(1.0 - iou + v, eps)).detach()
        return diou + alpha * v
    raise ValueError(f"unknown iou loss kind: {kind!r}")


def _localization_elem(box_deltas: torch.Tensor, reg_targets: torch.Tensor,
                       cfg: LossConfig,
                       anchors: torch.Tensor | None) -> torch.Tensor:
    """Per-anchor localization loss ``(..., A)`` under ``cfg.box_loss``:
    smooth-L1 on the encoded deltas, or the IoU family on both sides
    decoded against the anchors."""
    if cfg.box_loss == "smooth_l1":
        return smooth_l1_loss(box_deltas, reg_targets,
                              cfg.smooth_l1_delta).sum(-1)
    if anchors is None:
        raise ValueError(f"box_loss={cfg.box_loss!r} needs anchors")
    pred = box_utils.decode(box_deltas, anchors)
    tgt = box_utils.decode(reg_targets, anchors)
    return iou_box_loss(pred, tgt, cfg.box_loss)


def _num_positives(targets: Targets) -> torch.Tensor:
    s = targets.reg_weights.sum()
    return torch.maximum(s, s.new_ones(()))


def _totals(cls_loss, loc_loss, num_pos, cfg: LossConfig) -> LossDict:
    total = (cfg.classification_weight * cls_loss
             + cfg.localization_weight * loc_loss)
    return LossDict(total, cls_loss, loc_loss, num_pos)


def detection_loss(class_logits: torch.Tensor, box_deltas: torch.Tensor,
                   targets: Targets, cfg: LossConfig,
                   anchors: torch.Tensor | None = None) -> LossDict:
    """The flat loss: ``class_logits (N, A, C)``, ``box_deltas (N, A, 4)``,
    targets made with ``class_onehot=True``."""
    num_pos = _num_positives(targets)
    cls_elem = sigmoid_focal_loss(class_logits.float(), targets.cls_targets,
                                  cfg.focal_alpha, cfg.focal_gamma)
    cls_per_anchor = cls_elem.sum(-1) * targets.cls_weights  # (N, A)
    if cfg.use_ohem:
        cls_loss = _ohem_classification(cls_per_anchor, targets, cfg) / num_pos
    else:
        cls_loss = cls_per_anchor.sum() / num_pos
    loc_pa = _localization_elem(box_deltas.float(), targets.reg_targets, cfg,
                                anchors)
    loc_loss = (loc_pa * targets.reg_weights).sum() / num_pos
    return _totals(cls_loss, loc_loss, num_pos, cfg)


def _level_focal_sum(cls_map: torch.Tensor, enc: torch.Tensor,
                     num_classes: int, alpha: float,
                     gamma: float) -> torch.Tensor:
    """Focal loss summed over one level's ``(N, H, W, K*C)`` map. ``enc (N,
    H, W, K)`` holds each anchor's matched class id, ``num_classes`` for a
    negative or ``num_classes + 1`` for an ignored anchor; the one-hot and
    the ignore mask are rebuilt from it."""
    n, h, w, kc = cls_map.shape
    k = kc // num_classes
    cls_ids = torch.arange(num_classes, device=enc.device, dtype=enc.dtype)
    s = enc[..., None].expand(n, h, w, k, num_classes).reshape(n, h, w, kc)
    t = (s == cls_ids.repeat(k)).float()
    valid = (s != float(num_classes + 1)).float()
    elem = sigmoid_focal_loss(cls_map.float(), t, alpha, gamma)
    return (elem * valid).sum()


def detection_loss_levels(raw_levels: list, targets: Targets,
                          num_classes: int, cfg: LossConfig,
                          anchors: torch.Tensor | None = None) -> LossDict:
    """The per-level loss on the head's raw maps ``[(cls (N, H, W, K*C),
    box (N, H, W, K*4)), ...]``, targets made with ``class_onehot=False``.

    The same terms as :func:`detection_loss`, summed level by level. XLA
    fuses each level's focal terms into one pass and stores none of them;
    eagerly they are about a dozen ``(N, H, W, K*C)`` f32 temporaries (each
    64 x 80 x 80 x 720 values for the flagship's level 3 at batch 64), so
    each level's focal sum is recomputed in the backward pass instead of
    stored.
    """
    if targets.matched_labels is None:
        raise ValueError(
            "detection_loss_levels needs create_targets(class_onehot=False)")
    if cfg.use_ohem:
        raise ValueError("the per-level loss does not support OHEM")
    neg_v, ign_v = float(num_classes), float(num_classes + 1)
    cls_sum = targets.reg_weights.new_zeros(())
    loc_pa = []
    off = 0
    for cls_map, box_map in raw_levels:
        n, h, w, kc = cls_map.shape
        k = kc // num_classes
        al = h * w * k
        lab = targets.matched_labels[:, off:off + al].reshape(n, h, w, k)
        pos = targets.reg_weights[:, off:off + al].reshape(n, h, w, k)
        wgt = targets.cls_weights[:, off:off + al].reshape(n, h, w, k)
        enc = torch.where(wgt > 0, torch.where(pos > 0, lab, lab.new_full(
            (), neg_v)), lab.new_full((), ign_v))
        if torch.is_grad_enabled() and cls_map.requires_grad:
            level = checkpoint(_level_focal_sum, cls_map, enc, num_classes,
                               cfg.focal_alpha, cfg.focal_gamma,
                               use_reentrant=False, preserve_rng_state=False)
        else:
            level = _level_focal_sum(cls_map, enc, num_classes,
                                     cfg.focal_alpha, cfg.focal_gamma)
        cls_sum = cls_sum + level
        box_l = box_map.reshape(n, al, 4).float()
        loc_pa.append(_localization_elem(
            box_l, targets.reg_targets[:, off:off + al], cfg,
            None if anchors is None else anchors[off:off + al]))
        off += al
    num_pos = _num_positives(targets)
    cls_loss = cls_sum / num_pos
    loc_loss = (torch.cat(loc_pa, 1) * targets.reg_weights).sum() / num_pos
    return _totals(cls_loss, loc_loss, num_pos, cfg)


def _ohem_classification(cls_per_anchor: torch.Tensor, targets: Targets,
                         cfg: LossConfig) -> torch.Tensor:
    """Online hard example mining per image: all positives plus the
    ``max(neg_ratio * num_pos, min_negatives)`` negatives of highest
    classification loss; the keep count is a rank-below-threshold mask."""
    positive = targets.reg_weights > 0
    neg_loss = torch.where(positive, cls_per_anchor.new_full((), -math.inf),
                           cls_per_anchor)
    num_pos_per_image = positive.sum(1)
    k = torch.clamp_min((cfg.ohem_neg_ratio * num_pos_per_image).int(),
                        cfg.ohem_min_negatives)
    # rank by descending loss, ties in index order (a stable argsort, as
    # jnp.argsort is)
    order = torch.argsort(-neg_loss.detach(), dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    keep_neg = (rank < k[:, None]) & ~positive & (targets.cls_weights > 0)
    keep = positive | keep_neg
    return torch.where(keep, cls_per_anchor,
                       cls_per_anchor.new_zeros(())).sum()


def l2_regularization(params, weight_decay: float) -> torch.Tensor:
    """``0.5 * weight_decay * sum(w^2)`` over the kernels (parameters of two
    or more dimensions), not biases or norms; ``params`` is an iterable of
    tensors."""
    total = None
    for p in params:
        if p.dim() >= 2:
            sq = p.float().square().sum()
            total = sq if total is None else total + sq
    if total is None:
        return torch.zeros(())
    return 0.5 * weight_decay * total
