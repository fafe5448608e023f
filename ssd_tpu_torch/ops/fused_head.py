"""Fused prediction head: candidate selection without the big logits.

Counterpart of ``ssd_tpu/ops/fused_head.py``, for ``head_final_kernel=1``,
where each level's class prediction is a per-cell product with the 1x1
``predict`` conv's kernel. The JAX package computes it with plain XLA, not
Pallas, so the port computes it with plain PyTorch:

1. ``fused_logit_max``: the bf16 trunk times the bf16-rounded kernel with
   an f32 result, plus the f32 bias, reduced to each anchor's best-class
   logit ``(N, A)``;
2. the exact top-Q anchors by that logit, -inf under the threshold;
3. the Q candidates' logits and deltas recomputed in f32 from their
   gathered trunk rows, then decode, sigmoid and NMS (``postprocess.run_nms``:
   the kernel for hard NMS on CUDA tensors).

The JAX package pads each anchor's class block to 128 lanes with -inf bias,
a TPU layout device that leaves every maximum unchanged; the port does not
pad.
"""

from __future__ import annotations

import math

import torch

from ssd_tpu_torch.config import NMSConfig
from ssd_tpu_torch.ops import box_utils
from ssd_tpu_torch.ops.nms import Detections, topk_stable
from ssd_tpu_torch.ops.postprocess import logit_threshold, run_nms


def fused_logit_max(trunk: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, k: int) -> torch.Tensor:
    """Per-anchor max over classes, ``(N, cells * k)`` f32.

    ``trunk (N, cells, ch)``; ``weight (ch, K*C)`` and ``bias (K*C,)`` f32
    (the 1x1 conv's kernel and bias). The operands are rounded to bf16 and
    multiplied with f32 products and sums (exact products; TF32 is off), as
    the JAX package's ``jnp.dot(bf16, bf16, preferred_element_type=f32)``.
    """
    n, cells, ch = trunk.shape
    x = trunk.to(torch.bfloat16).float().reshape(n * cells, ch)
    y = x @ weight.to(torch.bfloat16).float() + bias
    return y.reshape(n * cells * k, -1).amax(dim=1).reshape(n, cells * k)


def predict_params(head) -> tuple:
    """``(w_cls (ch, K*C), b_cls, w_box (ch, K*4), b_box)`` f32 from a
    ``RetinaHead`` whose prediction convs are 1x1 (inference: detached)."""
    def mat(conv):
        w = conv.weight
        if w.shape[-2:] != (1, 1):
            raise ValueError("the fused head needs 1x1 prediction convs "
                             "(model.head_final_kernel=1)")
        return (w.detach().reshape(w.shape[0], w.shape[1]).t().float(),
                conv.bias.detach().float())

    return (*mat(head.class_net.predict), *mat(head.box_net.predict))


def fused_head_candidates(cls_trunk: torch.Tensor, box_trunk: torch.Tensor,
                          head, anchors: torch.Tensor, num_classes: int,
                          k: int, cfg: NMSConfig):
    """Subnet trunks ``(N, cells, ch)`` of a ``RetinaHead`` with 1x1
    prediction convs -> the top-Q candidates' ``boxes (N, Q, 4)`` and
    ``scores (N, Q, C)`` (0 for sub-threshold picks); ``anchors (cells * k,
    4)``."""
    n = cls_trunk.shape[0]
    c = num_classes
    w_cls, b_cls, w_box, b_box = predict_params(head)

    max_logit = fused_logit_max(cls_trunk, w_cls, b_cls, k)  # (N, A)
    q = min(cfg.num_candidates, max_logit.shape[1])
    masked = torch.where(max_logit >= logit_threshold(cfg), max_logit,
                         max_logit.new_full((), -math.inf))
    picked, idx = topk_stable(masked, q)

    cell_idx = torch.div(idx, k, rounding_mode="floor")
    anchor_k = idx - cell_idx * k

    def trunk_rows(t: torch.Tensor) -> torch.Tensor:  # (N, Q, ch) f32
        return torch.gather(t, 1, cell_idx[..., None].expand(
            n, q, t.shape[-1])).float()

    full_logits = trunk_rows(cls_trunk) @ w_cls + b_cls  # (N, Q, K*C)
    cand_logits = torch.gather(
        full_logits, 2, anchor_k[..., None] * c
        + torch.arange(c, device=idx.device))
    full_deltas = trunk_rows(box_trunk) @ w_box + b_box  # (N, Q, K*4)
    cand_deltas = torch.gather(
        full_deltas, 2, anchor_k[..., None] * 4
        + torch.arange(4, device=idx.device))

    boxes = box_utils.clip_boxes(box_utils.decode(cand_deltas, anchors[idx]))
    scores = torch.where(torch.isfinite(picked)[..., None],
                         torch.sigmoid(cand_logits), 0.0)
    return boxes, scores


def fused_head_detections(cls_trunk: torch.Tensor, box_trunk: torch.Tensor,
                          head, anchors: torch.Tensor, num_classes: int,
                          k: int, cfg: NMSConfig) -> Detections:
    """``fused_head_candidates``, then NMS (``postprocess.run_nms``)."""
    return run_nms(*fused_head_candidates(cls_trunk, box_trunk, head,
                                          anchors, num_classes, k, cfg), cfg)
