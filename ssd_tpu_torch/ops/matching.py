"""Batched IoU-argmax anchor matching: the plain PyTorch version.

Counterpart of ``ssd_tpu/ops/matching.py::match_anchors``, and the plain
version of the matching kernel (``ops/matching_cuda.py``,
``csrc/match.cu``). It is split the way the kernel splits it:

* ``match_core``: the ``(N, A, M)`` IoU of anchors against each image's
  padded gts, padded gts scored -1, reduced both ways, taking the first
  occurrence of each max as ``jnp.argmax`` does:
  ``best_gt (N, A)``, ``best_iou (N, A)`` and ``best_anchor (N, M)``;
* ``finish_matches``: thresholds and the forced match, shared with the
  kernel path.

Match semantics (SSD/RetinaNet): an anchor is positive (its best gt's
index) at IoU >= ``matching_threshold``, negative (-1) below
``negative_threshold``, ignored (-2) in between; with
``force_match_for_each_gt`` each valid gt then claims its best anchor.
"""

from __future__ import annotations

import torch

from ssd_tpu_torch.config import MatcherConfig
from ssd_tpu_torch.constants import IGNORE_MATCH, NEGATIVE_MATCH
from ssd_tpu_torch.ops import box_utils


def match_core(anchors: torch.Tensor, gt_boxes: torch.Tensor,
               num_boxes: torch.Tensor):
    """``anchors (A, 4)``, ``gt_boxes (N, M, 4)``, ``num_boxes (N,)`` ->
    ``(best_gt (N, A) int32, best_iou (N, A) f32, best_anchor (N, M)
    int32)``. An image without gts gets best_gt 0 and best_iou -1; a padded
    gt gets best_anchor 0.

    Materialises the ``(N, A, M)`` IoU: at N = 64, A = 76 725, M = 100 that
    is 2 GB of f32 per temporary, so large batches go in slices of images.
    """
    m = gt_boxes.shape[1]
    ious = box_utils.iou(anchors.float()[None], gt_boxes.float())  # (N, A, M)
    valid = (torch.arange(m, device=ious.device)[None, None, :]
             < num_boxes.to(ious.device)[:, None, None])
    ious = torch.where(valid, ious, ious.new_tensor(-1.0))
    # argmax takes the first of equal maxima, as jnp.argmax does
    best_gt = ious.argmax(dim=-1)
    best_iou = ious.gather(-1, best_gt[..., None])[..., 0]
    best_anchor = ious.argmax(dim=1)
    return best_gt.int(), best_iou, best_anchor.int()


def finish_matches(best_gt: torch.Tensor, best_iou: torch.Tensor,
                   best_anchor: torch.Tensor, num_boxes: torch.Tensor,
                   cfg: MatcherConfig) -> torch.Tensor:
    """Thresholds and the forced match -> ``(N, A)`` int32 matches."""
    n, a = best_gt.shape
    m = best_anchor.shape[1]
    dev = best_gt.device
    matches = torch.where(best_iou >= cfg.matching_threshold, best_gt,
                          best_gt.new_tensor(NEGATIVE_MATCH))
    band = ((best_iou >= cfg.negative_threshold)
            & (best_iou < cfg.matching_threshold))
    matches = torch.where(band, matches.new_tensor(IGNORE_MATCH), matches)
    if cfg.force_match_for_each_gt:
        # Each valid gt claims its best anchor. Where two gts share one, the
        # later gt index wins, as the JAX package's in-order scatter does.
        # index_put_ leaves the winner of duplicate indices undefined on
        # CUDA, so the scatter takes the max gt index instead; invalid gts
        # go to a spare column A that is cut off.
        gt_valid = (torch.arange(m, device=dev)[None, :]
                    < num_boxes.to(dev)[:, None])
        idx = torch.where(gt_valid, best_anchor.long(),
                          torch.full_like(best_anchor, a, dtype=torch.long))
        gt_idx = torch.arange(m, device=dev).expand(n, m)
        forced = torch.full((n, a + 1), NEGATIVE_MATCH, dtype=torch.long,
                            device=dev)
        forced.scatter_reduce_(1, idx, gt_idx, reduce="amax")
        forced = forced[:, :a].int()
        matches = torch.where(forced >= 0, forced, matches)
    return matches


def match_anchors(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                  num_boxes: torch.Tensor,
                  cfg: MatcherConfig) -> torch.Tensor:
    """``(N, A)`` int32 matches: gt index for positives, -1 for negatives,
    -2 for the ignore band."""
    best_gt, best_iou, best_anchor = match_core(anchors, gt_boxes, num_boxes)
    return finish_matches(best_gt, best_iou, best_anchor, num_boxes, cfg)
