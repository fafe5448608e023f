"""Batched class-wise NMS in plain PyTorch: greedy (hard) and Soft-NMS.

Hard NMS here is the plain version of the suppression kernel in
``nms_cuda.py``: the CPU path, and the version the kernel is held against
on the card. Soft-NMS has no kernel, in the JAX package either
(``ssd_tpu/ops/postprocess.py`` ``_nms`` sends every method but "hard" to
jnp), so this plain version is its port on every device. Both follow
``ssd_tpu/ops/nms.py`` ``batched_nms``:

  1. score threshold, then per-class top-k (``pre_nms_top_k``) over the
     shared candidates, lower index first among equal scores;
  2. hard: greedy suppression over the K score-sorted candidates of every
     (image, class) problem at once; soft (``soft_linear``,
     ``soft_gaussian``): K sequential pivots decay the scores of the
     unprocessed candidates (``soft_suppression_scores``);
  3. merge classes: global top-``max_boxes`` over the C*K survivors; hard
     gathers only the winners' boxes, soft gathers them from the per-class
     boxes, as the JAX package does.

Output: ``Detections(boxes (N, max_boxes, 4), scores (N, max_boxes),
labels (N, max_boxes), num_boxes (N,))``, zero past ``num_boxes`` (labels
-1).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ssd_tpu_torch.config import NMSConfig
from ssd_tpu_torch.ops import box_utils


class Detections(NamedTuple):
    boxes: torch.Tensor      # (N, max_boxes, 4)
    scores: torch.Tensor     # (N, max_boxes)
    labels: torch.Tensor     # (N, max_boxes) int32, -1 past num_boxes
    num_boxes: torch.Tensor  # (N,) int32


def f32(x: float) -> float:
    """A Python float rounded to float32: comparing an f32 tensor against it
    gives the same answer in f32 or f64 arithmetic, as JAX's weakly typed
    scalars do."""
    return float(np.float32(x))


def topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis, the lower index first among equal
    values (XLA's ``TopK`` order; ``torch.topk`` promises no tie order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def class_topk(scores: torch.Tensor, cfg: NMSConfig):
    """(N, Q, C) scores -> per-class ``(top_scores (N, C, K), top_idx (N, C,
    K) int32)``, sorted descending; candidates under the score threshold
    score -1."""
    k = min(cfg.pre_nms_top_k, scores.shape[1])
    scores_t = scores.transpose(1, 2)
    scores_t = torch.where(scores_t >= f32(cfg.score_threshold), scores_t,
                           scores_t.new_full((), -1.0))
    top_scores, top_idx = topk_stable(scores_t, k)
    return top_scores.contiguous(), top_idx.to(torch.int32).contiguous()


def greedy_suppression_mask(boxes: torch.Tensor, valid: torch.Tensor,
                            iou_threshold: float,
                            metric: str = "iou") -> torch.Tensor:
    """Greedy NMS keep-mask over score-sorted candidates.

    ``boxes (..., K, 4)``, ``valid (..., K)``. Step ``i`` drops every
    ``j > i`` whose overlap with ``i`` exceeds the threshold, if ``i`` is
    still kept. ``metric``: ``"iou"`` or ``"ios"`` (intersection over the
    smaller box, the tiled merge's: it drops contained fragments). The
    ``(..., K, K)`` overlap is formed once; row ``i`` is pivot ``i``
    against all candidates, as the JAX scan computes it.
    """
    k = boxes.shape[-2]
    overlap = {"iou": box_utils.iou, "ios": box_utils.ios}[metric]
    over = overlap(boxes, boxes) > f32(iou_threshold)
    later = torch.ones(k, k, dtype=torch.bool,
                       device=boxes.device).triu(diagonal=1)
    over &= later
    keep = valid.clone()
    for i in range(k):
        keep &= ~(over[..., i, :] & keep[..., i:i + 1])
    return keep


def suppress(boxes: torch.Tensor, top_idx: torch.Tensor,
             top_scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Plain version of the kernel: kept scores ``(N, C, K)``, -1 elsewhere.

    ``boxes (N, Q, 4)`` shared candidate boxes; ``top_idx (N, C, K)`` each
    problem's candidates as indices into its image's boxes; ``top_scores
    (N, C, K)`` sorted descending, invalid = -1.
    """
    n, c, k = top_idx.shape
    flat = top_idx.reshape(n, c * k).long()
    top_boxes = torch.gather(boxes, 1, flat[..., None].expand(n, c * k, 4))
    keep = greedy_suppression_mask(top_boxes.reshape(n, c, k, 4),
                                   top_scores > 0.0, iou_threshold)
    return torch.where(keep, top_scores, top_scores.new_full((), -1.0))


def soft_suppression_scores(boxes: torch.Tensor, scores: torch.Tensor,
                            cfg: NMSConfig) -> torch.Tensor:
    """Soft-NMS (Bodla et al. 2017) score decay over ``(..., K)`` problems.

    ``boxes (..., K, 4)``; ``scores (..., K)``, invalid candidates at -1.
    Each of K steps takes the first-occurrence argmax of the unprocessed
    scores as the pivot; if its score is positive, every other unprocessed
    candidate's score is multiplied by ``1 - iou`` where its IoU with the
    pivot is over ``iou_threshold`` (``soft_linear``), or by ``exp(-iou^2
    / soft_sigma)`` (``soft_gaussian``). Returns the decayed scores, those
    under ``score_threshold`` set to -1.
    """
    k = boxes.shape[-2]
    gaussian = cfg.method == "soft_gaussian"
    lane = torch.arange(k, device=boxes.device)
    neg_inf = scores.new_full((), -float("inf"))
    one = scores.new_full((), 1.0)
    s = scores
    processed = torch.zeros_like(scores, dtype=torch.bool)
    for _ in range(k):
        pivot_idx = torch.where(processed, neg_inf, s).argmax(dim=-1)
        pivot_score = torch.gather(s, -1, pivot_idx[..., None])[..., 0]
        pivot_box = torch.gather(
            boxes, -2, pivot_idx[..., None, None].expand(
                *pivot_idx.shape, 1, 4))
        ious = box_utils.iou(pivot_box, boxes)[..., 0, :]
        if gaussian:
            decay = torch.exp(-(ious * ious) / f32(cfg.soft_sigma))
        else:
            decay = torch.where(ious > f32(cfg.iou_threshold), 1.0 - ious,
                                one)
        is_pivot = lane == pivot_idx[..., None]
        untouched = processed | is_pivot | ~(pivot_score > 0.0)[..., None]
        s = torch.where(untouched, s, s * decay)
        processed = processed | is_pivot
    return torch.where(s >= f32(cfg.score_threshold), s,
                       s.new_full((), -1.0))


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                cfg: NMSConfig) -> Detections:
    """Class-wise NMS, hard or soft (``cfg.method``). ``boxes (N, Q, 4)``
    decoded and clipped, ``scores (N, Q, C)`` post-sigmoid, both f32."""
    top_scores, top_idx = class_topk(scores, cfg)
    if cfg.method != "hard":
        n, c, k = top_idx.shape
        flat = top_idx.reshape(n, c * k).long()
        top_boxes = torch.gather(
            boxes, 1, flat[..., None].expand(n, c * k, 4)).reshape(n, c, k, 4)
        valid = top_scores > 0.0
        kept = soft_suppression_scores(
            top_boxes, torch.where(valid, top_scores,
                                   top_scores.new_full((), -1.0)), cfg)
        return merge_classes(top_boxes, kept, cfg)
    kept = suppress(boxes, top_idx, top_scores, cfg.iou_threshold)
    return merge_classes_lazy(boxes, top_idx, kept, cfg)


def merge_classes(top_boxes: torch.Tensor, kept_scores: torch.Tensor,
                  cfg: NMSConfig) -> Detections:
    """Global top-``max_boxes`` over the per-class survivors, the winners'
    boxes gathered from the per-class boxes ``top_boxes (N, C, K, 4)``."""
    n, c, k, _ = top_boxes.shape
    flat_boxes = top_boxes.reshape(n, c * k, 4)
    return _merge_flat(
        lambda final_idx: torch.gather(
            flat_boxes, 1, final_idx[..., None].expand(*final_idx.shape, 4)),
        kept_scores, cfg)


def merge_classes_lazy(cand_boxes: torch.Tensor, top_idx: torch.Tensor,
                       kept_scores: torch.Tensor,
                       cfg: NMSConfig) -> Detections:
    """Global top-``max_boxes`` over the per-class survivors; only the
    winners' boxes are gathered (``final_idx -> top_idx -> cand_boxes``)."""
    n, c, k = kept_scores.shape

    def gather_boxes(final_idx):  # (N, m) into the flattened (C*K) plane
        flat_cand = torch.gather(top_idx.reshape(n, c * k).long(), 1,
                                 final_idx)
        return torch.gather(cand_boxes, 1,
                            flat_cand[..., None].expand(*flat_cand.shape, 4))

    return _merge_flat(gather_boxes, kept_scores, cfg)


def _merge_flat(gather_boxes, kept_scores: torch.Tensor,
                cfg: NMSConfig) -> Detections:
    n, c, k = kept_scores.shape
    flat_scores = kept_scores.reshape(n, c * k)
    m = min(cfg.max_boxes, c * k)
    final_scores, final_idx = topk_stable(flat_scores, m)
    final_boxes = gather_boxes(final_idx)
    final_labels = torch.div(final_idx, k, rounding_mode="floor").to(
        torch.int32)

    is_det = final_scores > 0.0
    num = is_det.sum(dim=1, dtype=torch.int32)
    zero = final_scores.new_full((), 0.0)
    final_boxes = torch.where(is_det[..., None], final_boxes, zero)
    final_scores = torch.where(is_det, final_scores, zero)
    final_labels = torch.where(is_det, final_labels,
                               final_labels.new_full((), -1))

    if m < cfg.max_boxes:  # pad up to the contract size
        pad = cfg.max_boxes - m
        final_boxes = torch.nn.functional.pad(final_boxes, (0, 0, 0, pad))
        final_scores = torch.nn.functional.pad(final_scores, (0, pad))
        final_labels = torch.nn.functional.pad(final_labels, (0, pad),
                                               value=-1)
    return Detections(final_boxes, final_scores, final_labels, num)
