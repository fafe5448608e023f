"""Weighted box fusion (Solovyev et al. 2021), the ensembling merge: the
port's ``ssd_tpu/ops/wbf.py``.

Where NMS keeps the best box of an overlap cluster and drops the rest, WBF
fuses every member into a score-weighted average: the merge for candidates
from several views of one image (flip TTA, model ensembles), whose
localization errors are independent.

The candidates are a padded set (invalid slots score <= 0), clustered in
K sequential steps, each against the clusters formed so far, on the
candidates' device; a leading batch axis runs one image's function on
each row at once. Classes stay apart by the JAX package's offset: boxes
live in [0, 1], so ``label * 2`` added to each box makes cross-class IoU
zero, and the offset cancels in the average.

The arithmetic is the JAX package's jitted function's (``jax.jit`` on the
CPU): the stable order of ``argsort(-scores)``, the first-occurrence
argmax, the offset added in f32 before the overlap, and the running sum
``wsum + score * box`` rounded once, as XLA contracts it into a fused
multiply-add (formed here in f64 and rounded to f32: the exact product of
two f32 values plus the sum, then one rounding, which equals the fused
result unless the f64 sum lands exactly on an f32 rounding midpoint).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ssd_tpu_torch.ops import box_utils
from ssd_tpu_torch.ops.nms import f32, topk_stable


def sort_candidates(boxes: torch.Tensor, scores: torch.Tensor,
                    labels: torch.Tensor):
    """``(..., K)`` candidates in descending score order, equal scores in
    their given order (JAX's stable ``argsort(-scores)``)."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    return (torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4)),
            torch.gather(scores, -1, order), torch.gather(labels, -1, order))


def offset_boxes(boxes: torch.Tensor, labels: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Each valid box shifted by ``label * 2`` (f32), so that boxes of
    different classes never overlap."""
    lab = torch.where(valid, labels, torch.zeros_like(labels))
    return boxes + lab.to(boxes.dtype)[..., None] * 2.0


def pad_detections(boxes, scores, labels, max_boxes: int):
    """Pads the last axis of ``(..., m)`` outputs up to ``max_boxes``
    (boxes and scores with 0, labels with -1)."""
    pad = max_boxes - scores.shape[-1]
    if pad <= 0:
        return boxes, scores, labels
    return (F.pad(boxes, (0, 0, 0, pad)), F.pad(scores, (0, pad)),
            F.pad(labels, (0, pad), value=-1))


def weighted_box_fusion(boxes: torch.Tensor, scores: torch.Tensor,
                        labels: torch.Tensor, iou_threshold: float,
                        max_boxes: int, num_views: int = 1):
    """Class-wise WBF over each image's flat candidate set.

    ``boxes (..., K, 4)`` corner form in [0, 1]; ``scores (..., K)``,
    invalid slots <= 0; ``labels (..., K)`` int. A candidate joins the
    cluster of its class whose fused box it overlaps most, if that IoU is
    over ``iou_threshold``, else starts one. ``num_views``: the views or
    models the candidates came from; a cluster's score is its members' mean
    times ``min(members, num_views) / num_views``.

    Returns ``(boxes (..., max_boxes, 4), scores (..., max_boxes), labels
    (..., max_boxes) int32, count (...) int32)``, zero past ``count``
    (labels -1).
    """
    batch = scores.shape[:-1]
    k = scores.shape[-1]
    boxes = boxes.reshape(-1, k, 4).float()
    scores = scores.reshape(-1, k).float()
    labels = labels.reshape(-1, k).to(torch.int32)
    boxes, scores, labels = sort_candidates(boxes, scores, labels)
    valid = scores > 0.0
    oboxes = offset_boxes(boxes, labels, valid)
    n = scores.shape[0]
    lane = torch.arange(k, device=scores.device)
    thr = f32(iou_threshold)

    count = torch.zeros(n, dtype=torch.int64, device=scores.device)
    wsum = scores.new_zeros(n, k, 4)
    ssum = scores.new_zeros(n, k)
    members = scores.new_zeros(n, k)
    fused = scores.new_zeros(n, k, 4)
    label = torch.full((n, k), -1, dtype=torch.int32, device=scores.device)
    minus_one = scores.new_full((), -1.0)
    one = torch.ones((), dtype=torch.int64, device=scores.device)
    zero = torch.zeros((), dtype=torch.int64, device=scores.device)
    for i in range(k):
        box = oboxes[:, i:i + 1]  # (n, 1, 4)
        score = scores[:, i:i + 1]  # (n, 1)
        ok = valid[:, i]
        ious = box_utils.iou(fused, box)[..., 0]  # (n, k)
        ious = torch.where(lane < count[:, None], ious, minus_one)
        best = ious.argmax(dim=-1)  # the first of equal maxima
        join = (torch.gather(ious, -1, best[:, None])[:, 0] > thr) & ok
        target = torch.where(join, best, count)
        onehot = (lane == target[:, None]).to(scores.dtype) * ok[:, None]
        weight = onehot * score  # exact: onehot is 0 or 1
        # XLA's fused multiply-add: the f64 product is exact, one rounding
        wsum = (weight.double()[..., None] * box.double()
                + wsum.double()).float()
        ssum = ssum + weight
        members = members + onehot
        hit = onehot > 0
        fused = torch.where(
            hit[..., None],
            wsum / ssum.clamp_min(1e-12)[..., None], fused)
        label = torch.where(hit, labels[:, i:i + 1], label)
        count = count + torch.where(join | ~ok, zero, one)

    mean = ssum / members.clamp_min(1.0)
    # a division by the constant num_views, which XLA turns into a multiply
    # by its f32 reciprocal
    cover = torch.minimum(members, members.new_full((), float(num_views))) \
        * float(np.float32(1.0) / np.float32(num_views))
    fscores = mean * torch.where(members > 0, cover, members.new_zeros(()))
    fboxes = fused - label.to(fused.dtype)[..., None] * 2.0

    top_scores, top_idx = topk_stable(fscores, min(max_boxes, k))
    fv = top_scores > 0.0
    out_boxes = torch.gather(fboxes, 1, top_idx[..., None].expand(
        *top_idx.shape, 4)).clamp(0.0, 1.0) * fv[..., None]
    out_scores = torch.where(fv, top_scores, top_scores.new_zeros(()))
    out_labels = torch.where(fv, torch.gather(label, 1, top_idx),
                             label.new_full((), -1))
    out_boxes, out_scores, out_labels = pad_detections(
        out_boxes, out_scores, out_labels, max_boxes)
    return (out_boxes.reshape(*batch, max_boxes, 4),
            out_scores.reshape(*batch, max_boxes),
            out_labels.reshape(*batch, max_boxes),
            fv.sum(dim=-1, dtype=torch.int32).reshape(batch))
