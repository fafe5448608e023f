"""Detection postprocess: cell-major candidate selection + class-wise NMS.

Counterpart of ``ssd_tpu/ops/postprocess.py`` on its ``select="cells"``
path. Selection is by index gather; the JAX package's one-hot einsums were
a TPU layout device and select the same rows.
"""

from __future__ import annotations

import math

import torch

from ssd_tpu_torch.config import NMSConfig
from ssd_tpu_torch.ops import box_utils
from ssd_tpu_torch.ops.nms import Detections, f32, topk_stable
from ssd_tpu_torch.ops.nms_cuda import batched_nms_cuda


def _gather_rows(level_map: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """``level_map (N, S, D)``, ``local (N, R)`` in ``[0, S)`` -> (N, R, D)."""
    n, s, d = level_map.shape
    rows = local + torch.arange(n, device=local.device)[:, None] * s
    return level_map.reshape(n * s, d).index_select(0, rows.reshape(-1)).view(
        n, -1, d)


def select_candidates_cells(raw_levels: list, anchors: torch.Tensor,
                            num_classes: int, cfg: NMSConfig):
    """Cell-major top-Q candidate selection.

    1. per-cell max over all K*C class channels of each level;
    2. exact top-``q_cells`` cells over the concatenated levels, where
       ``q_cells = ceil(num_candidates * cell_overprovision / K)``;
    3. gather the winning cells' K*C logits and K*4 deltas;
    4. if the cells hold more than ``num_candidates`` anchors, keep the exact
       top ``num_candidates`` anchors by best-class logit.

    Cells whose best logit is under the score threshold never contribute.
    Returns ``boxes (N, Q, 4)`` decoded and clipped, and ``scores (N, Q, C)``
    post-sigmoid (0 for dead candidates), both f32.
    """
    n = raw_levels[0][0].shape[0]
    c = num_classes
    kc = raw_levels[0][0].shape[-1]
    k = kc // c

    cell_max, cells_per_level = [], []
    for cls_raw, _ in raw_levels:
        _, h, w, _ = cls_raw.shape
        cell_max.append(cls_raw.amax(dim=-1).reshape(n, h * w).float())
        cells_per_level.append(h * w)
    cell_logit = torch.cat(cell_max, dim=1)  # (N, cells)
    total_cells = cell_logit.shape[1]

    neg_inf = cell_logit.new_tensor(-math.inf)
    logit_thr = f32(math.log(cfg.score_threshold
                             / (1.0 - cfg.score_threshold)))
    cell_logit = torch.where(cell_logit >= logit_thr, cell_logit, neg_inf)

    over = max(float(cfg.cell_overprovision), 1.0)
    q_cells = min(-(-int(cfg.num_candidates * over) // k), total_cells)
    refine = q_cells * k > cfg.num_candidates
    top_logit, cell_idx = topk_stable(cell_logit, q_cells)  # (N, Qc)

    cand_cls = None
    cand_box = None
    offset = 0
    for (cls_raw, box_raw), n_cells in zip(raw_levels, cells_per_level):
        local = cell_idx - offset
        valid = ((local >= 0) & (local < n_cells))[..., None]
        safe = local.clamp(0, n_cells - 1)
        lvl_cls = _gather_rows(cls_raw.reshape(n, n_cells, kc), safe).float()
        lvl_box = _gather_rows(box_raw.reshape(n, n_cells, 4 * k), safe).float()
        if cand_cls is None:
            cand_cls = torch.where(valid, lvl_cls, 0.0)
            cand_box = torch.where(valid, lvl_box, 0.0)
        else:
            cand_cls = torch.where(valid, lvl_cls, cand_cls)
            cand_box = torch.where(valid, lvl_box, cand_box)
        offset += n_cells

    q = q_cells * k
    cand_logits = cand_cls.reshape(n, q, c)
    cand_deltas = cand_box.reshape(n, q, 4)
    cand_anchors = anchors.reshape(total_cells, k, 4)[cell_idx].reshape(n, q, 4)
    anchor_live = torch.isfinite(top_logit).repeat_interleave(k, dim=1)

    if refine:
        rank = torch.where(anchor_live, cand_logits.amax(dim=-1), neg_inf)
        top_rank, aidx = topk_stable(rank, cfg.num_candidates)  # (N, Q)
        anchor_live = torch.isfinite(top_rank)
        pick = lambda t: torch.gather(  # noqa: E731
            t, 1, aidx[..., None].expand(n, aidx.shape[1], t.shape[-1]))
        cand_logits, cand_deltas, cand_anchors = (
            pick(cand_logits), pick(cand_deltas), pick(cand_anchors))

    boxes = box_utils.clip_boxes(box_utils.decode(cand_deltas, cand_anchors))
    scores = torch.where(anchor_live[..., None], torch.sigmoid(cand_logits),
                         0.0)
    return boxes, scores


def postprocess_cells(raw_levels: list, anchors: torch.Tensor,
                      num_classes: int, cfg: NMSConfig) -> Detections:
    """Raw head maps -> detections; the suppression runs in the CUDA kernel
    on CUDA tensors and in its plain version on CPU tensors."""
    boxes, scores = select_candidates_cells(raw_levels, anchors, num_classes,
                                            cfg)
    return batched_nms_cuda(boxes, scores, cfg)
