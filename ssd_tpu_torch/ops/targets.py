"""Training targets: matches -> regression and classification targets.

Counterpart of ``ssd_tpu/ops/targets.py::create_targets``. Matching runs
the kernel for CUDA tensors and the plain version for CPU tensors
(``ops/matching_cuda.match_anchors``). The JAX package gathers each
positive anchor's gt box and label with one-hot contractions, a TPU layout
workaround; here the same selection is an index gather.

Labels are foreground class ids in ``[0, num_classes)`` (sigmoid heads, no
background class). Negatives train as an all-zero one-hot; ignored anchors
get classification weight 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ssd_tpu_torch.config import MatcherConfig
from ssd_tpu_torch.constants import IGNORE_MATCH
from ssd_tpu_torch.ops import box_utils
from ssd_tpu_torch.ops.matching_cuda import match_anchors


class Targets(NamedTuple):
    reg_targets: torch.Tensor   # (N, A, 4) encoded box targets, 0 where not positive
    cls_targets: torch.Tensor | None  # (N, A, C) one-hot, all-zero for
    #                             negatives; None with class_onehot=False
    cls_weights: torch.Tensor   # (N, A) 1 for positives and negatives, 0 ignored
    reg_weights: torch.Tensor   # (N, A) 1 for positives only
    matches: torch.Tensor       # (N, A) raw match indices
    matched_labels: torch.Tensor | None = None  # (N, A) f32 class id of the
    #                             matched gt (0 where not positive)


def create_targets(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_labels: torch.Tensor, num_boxes: torch.Tensor,
                   num_classes: int, matcher_cfg: MatcherConfig,
                   class_onehot: bool = True) -> Targets:
    """``anchors (A, 4)``, ``gt_boxes (N, M, 4)`` padded, ``gt_labels (N,
    M)`` int, ``num_boxes (N,)`` -> :class:`Targets` on the anchors'
    device."""
    dev = anchors.device
    gt_boxes = gt_boxes.to(dev, torch.float32)
    gt_labels = gt_labels.to(dev)
    num_boxes = num_boxes.to(dev, torch.int32)
    matches = match_anchors(anchors, gt_boxes, num_boxes, matcher_cfg)

    positive = matches >= 0
    idx = matches.clamp_min(0).long()  # (N, A); rows not positive are masked
    matched_boxes = torch.gather(
        gt_boxes, 1, idx[..., None].expand(*idx.shape, 4))
    reg_targets = box_utils.encode(matched_boxes, anchors[None])
    reg_targets = torch.where(positive[..., None], reg_targets,
                              reg_targets.new_tensor(0.0))

    labels = torch.gather(gt_labels.long(), 1, idx)  # (N, A)
    labels = torch.where(positive, labels, labels.new_tensor(-1))
    cls_targets = matched_labels = None
    if class_onehot:
        cls_targets = (labels[..., None] == torch.arange(
            num_classes, device=dev)).float()
    else:
        matched_labels = labels.clamp_min(0).float()

    cls_weights = (matches != IGNORE_MATCH).float()
    reg_weights = positive.float()
    return Targets(reg_targets, cls_targets, cls_weights, reg_weights,
                   matches, matched_labels)
