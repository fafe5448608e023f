"""Detection postprocess: candidate selection + class-wise NMS.

Counterpart of ``ssd_tpu/ops/postprocess.py``. Three selections, each
returning the Q candidates' decoded boxes and post-sigmoid scores:

* ``select_candidates_cells`` (``select="cells"``, the shipped configs):
  cell-major, on the per-level maps;
* ``select_candidates`` (``select="anchors"``): the exact top-Q anchors by
  best-class logit of the flat ``(N, A, C)`` logits (the JAX package's
  ``approx_max_k`` lowers to an exact top-k off the TPU);
* ``select_candidates_pyramid``: the same anchors from the per-level maps,
  without the flat logits (a library path of the JAX package; its
  ``Detector.predict`` does not take it).

Selection is by index gather; the JAX package's one-hot einsums were a TPU
layout device and select the same rows. ``run_nms`` then dispatches: hard
NMS to ``nms_cuda.batched_nms_cuda`` (the kernel on CUDA tensors, its plain
version on CPU tensors), Soft-NMS to the plain ``nms.batched_nms`` on any
device (it has no kernel, in the JAX package either).
"""

from __future__ import annotations

import math

import torch

from ssd_tpu_torch.config import NMSConfig
from ssd_tpu_torch.ops import box_utils
from ssd_tpu_torch.ops.nms import Detections, batched_nms, f32, topk_stable
from ssd_tpu_torch.ops.nms_cuda import batched_nms_cuda


def logit_threshold(cfg: NMSConfig) -> float:
    """``score_threshold`` in logit space, rounded to f32 (sigmoid is
    monotonic, so selection compares logits)."""
    return f32(math.log(cfg.score_threshold / (1.0 - cfg.score_threshold)))


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t (N, A, D)``, ``idx (N, Q)`` -> ``(N, Q, D)``."""
    return torch.gather(t, 1, idx[..., None].expand(*idx.shape, t.shape[-1]))


def _decode(cand_deltas: torch.Tensor,
            cand_anchors: torch.Tensor) -> torch.Tensor:
    return box_utils.clip_boxes(box_utils.decode(cand_deltas, cand_anchors))


def select_candidates(logits: torch.Tensor, deltas: torch.Tensor,
                      anchors: torch.Tensor, cfg: NMSConfig):
    """Anchor-wise top-Q selection (``select="anchors"``).

    ``logits (N, A, C)`` and ``deltas (N, A, 4)`` raw. The best-class logit
    of each anchor, -inf under the threshold; the exact top
    ``min(num_candidates, A)`` of them, lower index first among equal
    values (-inf included); their logits, deltas and anchors gathered. As
    in the JAX package, the scores of sub-threshold picks are kept, not
    zeroed. Returns ``boxes (N, Q, 4)`` and ``scores (N, Q, C)``, f32.
    """
    q = min(cfg.num_candidates, logits.shape[1])
    max_logit = logits.amax(dim=-1).float()
    max_logit = torch.where(max_logit >= logit_threshold(cfg), max_logit,
                            max_logit.new_full((), -math.inf))
    _, idx = topk_stable(max_logit, q)
    cand_logits = _rows(logits, idx).float()
    cand_deltas = _rows(deltas.float(), idx)
    return _decode(cand_deltas, anchors[idx]), torch.sigmoid(cand_logits)


def select_candidates_pyramid(raw_levels: list, anchors: torch.Tensor,
                              num_classes: int, cfg: NMSConfig):
    """``select_candidates`` on the per-level maps ``[(cls (N, H, W, K*C),
    box (N, H, W, K*4)), ...]``: each level's anchor maxima in its own (h,
    w, k) order, concatenated over levels, so a candidate index maps to the
    (level, y, x, k) of the flat order. Picks under the threshold score 0,
    unlike ``select_candidates``."""
    n = raw_levels[0][0].shape[0]
    c = num_classes
    level_max, level_sizes = [], []
    for cls_raw, _ in raw_levels:
        a_l = cls_raw[0].numel() // c
        level_max.append(cls_raw.reshape(n, a_l, c).amax(dim=-1).float())
        level_sizes.append(a_l)
    max_logit = torch.cat(level_max, dim=1)  # (N, A)
    q = min(cfg.num_candidates, max_logit.shape[1])
    max_logit = torch.where(max_logit >= logit_threshold(cfg), max_logit,
                            max_logit.new_full((), -math.inf))
    picked, idx = topk_stable(max_logit, q)

    cand_logits = cand_deltas = None
    offset = 0
    for (cls_raw, box_raw), a_l in zip(raw_levels, level_sizes):
        local = idx - offset
        valid = ((local >= 0) & (local < a_l))[..., None]
        safe = local.clamp(0, a_l - 1)
        lvl_logits = _rows(cls_raw.reshape(n, a_l, c), safe).float()
        lvl_deltas = _rows(box_raw.reshape(n, a_l, 4), safe).float()
        if cand_logits is None:
            cand_logits = torch.where(valid, lvl_logits, 0.0)
            cand_deltas = torch.where(valid, lvl_deltas, 0.0)
        else:
            cand_logits = torch.where(valid, lvl_logits, cand_logits)
            cand_deltas = torch.where(valid, lvl_deltas, cand_deltas)
        offset += a_l

    scores = torch.where(torch.isfinite(picked)[..., None],
                         torch.sigmoid(cand_logits), 0.0)
    return _decode(cand_deltas, anchors[idx]), scores


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

    neg_inf = cell_logit.new_full((), -math.inf)
    cell_logit = torch.where(cell_logit >= logit_threshold(cfg), cell_logit,
                             neg_inf)

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
    # each live cell's K anchors (expand, not repeat_interleave, whose
    # output size may be read back from the card)
    anchor_live = torch.isfinite(top_logit)[..., None].expand(
        n, q_cells, k).reshape(n, q)

    if refine:
        rank = torch.where(anchor_live, cand_logits.amax(dim=-1), neg_inf)
        top_rank, aidx = topk_stable(rank, cfg.num_candidates)  # (N, Q)
        anchor_live = torch.isfinite(top_rank)
        cand_logits, cand_deltas, cand_anchors = (
            _rows(cand_logits, aidx), _rows(cand_deltas, aidx),
            _rows(cand_anchors, aidx))

    scores = torch.where(anchor_live[..., None], torch.sigmoid(cand_logits),
                         0.0)
    return _decode(cand_deltas, cand_anchors), scores


def run_nms(boxes: torch.Tensor, scores: torch.Tensor,
            cfg: NMSConfig) -> Detections:
    """Hard NMS: the suppression in the CUDA kernel on CUDA tensors, in its
    plain version on CPU tensors. Soft-NMS: the plain version anywhere."""
    if cfg.method == "hard":
        return batched_nms_cuda(boxes, scores, cfg)
    return batched_nms(boxes.float(), scores.float(), cfg)


def postprocess_pyramid(raw_levels: list, anchors: torch.Tensor,
                        num_classes: int, cfg: NMSConfig) -> Detections:
    """Raw head maps -> detections by anchor-wise selection per level."""
    return run_nms(*select_candidates_pyramid(raw_levels, anchors,
                                              num_classes, cfg), cfg)


def postprocess_detections(logits: torch.Tensor, deltas: torch.Tensor,
                           anchors: torch.Tensor,
                           cfg: NMSConfig) -> Detections:
    """Flat raw outputs -> detections by anchor-wise selection."""
    return run_nms(*select_candidates(logits, deltas, anchors, cfg), cfg)
