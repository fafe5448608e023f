"""Batched class-wise greedy NMS in plain PyTorch.

This is the plain version of the suppression kernel in ``nms_cuda.py``: the
CPU path, and the version the kernel is held against on the card. It follows
``ssd_tpu/ops/nms.py`` (``batched_nms`` with ``method="hard"``):

  1. score threshold, then per-class top-k (``pre_nms_top_k``) over the
     shared candidates, lower index first among equal scores;
  2. greedy suppression over the K score-sorted candidates of every
     (image, class) problem at once;
  3. merge classes: global top-``max_boxes`` over the C*K survivors, with
     only the winners' boxes gathered.

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
                           scores_t.new_tensor(-1.0))
    top_scores, top_idx = topk_stable(scores_t, k)
    return top_scores.contiguous(), top_idx.to(torch.int32).contiguous()


def greedy_suppression_mask(boxes: torch.Tensor, valid: torch.Tensor,
                            iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep-mask over score-sorted candidates.

    ``boxes (..., K, 4)``, ``valid (..., K)``. Step ``i`` drops every
    ``j > i`` whose IoU with ``i`` exceeds the threshold, if ``i`` is still
    kept. The ``(..., K, K)`` IoU is formed once; row ``i`` is pivot ``i``
    against all candidates, as the JAX scan computes it.
    """
    k = boxes.shape[-2]
    over = box_utils.iou(boxes, boxes) > f32(iou_threshold)
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
    return torch.where(keep, top_scores, top_scores.new_tensor(-1.0))


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                cfg: NMSConfig) -> Detections:
    """Class-wise hard NMS. ``boxes (N, Q, 4)`` decoded and clipped,
    ``scores (N, Q, C)`` post-sigmoid, both f32."""
    if cfg.method != "hard":
        raise NotImplementedError(
            f"nms.method={cfg.method!r}: only 'hard' is ported")
    top_scores, top_idx = class_topk(scores, cfg)
    kept = suppress(boxes, top_idx, top_scores, cfg.iou_threshold)
    return merge_classes_lazy(boxes, top_idx, kept, cfg)


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
    zero = final_scores.new_tensor(0.0)
    final_boxes = torch.where(is_det[..., None], final_boxes, zero)
    final_scores = torch.where(is_det, final_scores, zero)
    final_labels = torch.where(is_det, final_labels,
                               final_labels.new_tensor(-1))

    if m < cfg.max_boxes:  # pad up to the contract size
        pad = cfg.max_boxes - m
        final_boxes = torch.nn.functional.pad(final_boxes, (0, 0, 0, pad))
        final_scores = torch.nn.functional.pad(final_scores, (0, pad))
        final_labels = torch.nn.functional.pad(final_labels, (0, pad),
                                               value=-1)
    return Detections(final_boxes, final_scores, final_labels, num)
