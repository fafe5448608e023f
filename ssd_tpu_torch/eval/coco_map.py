"""Detection mAP evaluation, numpy only: the full COCO protocol.

The port's own copy of ``ssd_tpu/eval/coco_map.py`` (the card's machine
has no JAX), the same arithmetic line for line, so both give the same mAP
on the same detections. pycocotools' matching and interpolation rules are
implemented directly:

  * greedy matching of detections (score-descending) to ground truth with
    IoU >= threshold, one match per gt;
  * **crowd ground truth is an ignore region** (pycocotools ``iscrowd``):
    crowd gts use the intersection-over-detection-area IoU variant, can
    absorb any number of detections, and detections matched to them are
    neither TP nor FP;
  * **area-range buckets**: per range, out-of-range gts are ignored (and
    re-matched: ignoring a gt changes the greedy assignment), and
    unmatched out-of-range detections are dropped from scoring;
  * PASCAL VOC-2010+ AP: area under the monotonically-decreasing
    precision-recall envelope (all-point interpolation);
  * the standard 12-metric table: AP@[.5:.95] / AP50 / AP75,
    AP_small/medium/large, AR@{1,10,100}, AR_small/medium/large.

``merge`` folds one evaluator into another in one process; ``gather``
folds every rank's into each rank's (the JAX package's multi-host gather,
over ``torch.distributed``): each rank evaluates its own rows, and the
small per-detection statistics, not images, go over the host group as CPU
tensors, so every rank computes the same global metrics.
"""

from __future__ import annotations

import numpy as np


def boxes_iou_numpy(b1: np.ndarray, b2: np.ndarray) -> np.ndarray:
    """(D, 4) x (G, 4) normalized ``(ymin, xmin, ymax, xmax)`` -> (D, G) IoU
    (``ssd_tpu/data/augment.py``'s)."""
    y0 = np.maximum(b1[:, None, 0], b2[None, :, 0])
    x0 = np.maximum(b1[:, None, 1], b2[None, :, 1])
    y1 = np.minimum(b1[:, None, 2], b2[None, :, 2])
    x1 = np.minimum(b1[:, None, 3], b2[None, :, 3])
    inter = np.clip(y1 - y0, 0, None) * np.clip(x1 - x0, 0, None)
    a1 = (b1[:, 2] - b1[:, 0]) * (b1[:, 3] - b1[:, 1])
    a2 = (b2[:, 2] - b2[:, 0]) * (b2[:, 3] - b2[:, 1])
    return inter / np.maximum(a1[:, None] + a2[None, :] - inter, 1e-8)


COCO_IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)

# pycocotools area ranges (pixel^2 of the ORIGINAL image) and maxDets
AREA_NAMES = ("all", "small", "medium", "large")
AREA_RANGES = np.asarray([
    [0.0, 1e10],
    [0.0, 32.0 ** 2],
    [32.0 ** 2, 96.0 ** 2],
    [96.0 ** 2, 1e10],
])
MAX_DETS = (1, 10, 100)


def match_image_multi(
    ious: np.ndarray,        # (D, G) rows score-sorted descending
    thresholds: np.ndarray,  # (T,)
) -> np.ndarray:
    """Greedy COCO matching at ALL IoU thresholds at once (no ignore
    handling — the simple protocol; :func:`match_image_coco` is the full
    one).

    Returns bool (D, T): detection d is a true positive at threshold t.
    The detection loop is inherently sequential (each match consumes a gt),
    but the inner scan is vectorized over (T, G), so the host cost is
    O(D) numpy ops per image-class instead of O(D*G*T) Python ops — the
    difference between hours and seconds at COCO scale (5k imgs x 80
    classes x 10 thresholds).
    """
    d, g = ious.shape
    t = len(thresholds)
    tp = np.zeros((d, t), bool)
    if d == 0 or g == 0:
        return tp
    taken = np.zeros((t, g), bool)
    rows = np.arange(t)
    for i in range(d):
        avail = np.where(taken, -1.0, ious[i][None, :])  # (T, G)
        # Highest-IoU untaken gt; ties go to the LAST index, matching the
        # scalar scan this replaced (argmax alone takes the first).
        j = g - 1 - np.argmax(avail[:, ::-1], axis=1)
        ok = avail[rows, j] >= thresholds
        tp[i] = ok
        taken[rows[ok], j[ok]] = True
    return tp


def match_image(
    det_boxes: np.ndarray,   # (D, 4) score-sorted descending
    gt_boxes: np.ndarray,    # (G, 4)
    iou_thr: float,
) -> np.ndarray:
    """Greedy COCO matching. Returns bool (D,): detection is a true positive."""
    if len(det_boxes) == 0 or len(gt_boxes) == 0:
        return np.zeros(len(det_boxes), bool)
    ious = boxes_iou_numpy(det_boxes, gt_boxes)
    return match_image_multi(ious, np.asarray([iou_thr]))[:, 0]


def coco_iou_matrix(det_boxes: np.ndarray, gt_boxes: np.ndarray,
                    gt_is_crowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU with the pycocotools crowd variant: for crowd gt columns
    the measure is intersection / detection area (a detection fully inside
    a crowd region scores 1 regardless of the region's size)."""
    ious = boxes_iou_numpy(det_boxes, gt_boxes)
    crowd = np.asarray(gt_is_crowd, bool)
    if crowd.any():
        d, g = det_boxes, gt_boxes
        ymin = np.maximum(d[:, None, 0], g[None, :, 0])
        xmin = np.maximum(d[:, None, 1], g[None, :, 1])
        ymax = np.minimum(d[:, None, 2], g[None, :, 2])
        xmax = np.minimum(d[:, None, 3], g[None, :, 3])
        inter = np.clip(ymax - ymin, 0, None) * np.clip(xmax - xmin, 0, None)
        det_area = np.clip(
            (d[:, 2] - d[:, 0]) * (d[:, 3] - d[:, 1]), 1e-12, None)
        ious[:, crowd] = (inter / det_area[:, None])[:, crowd]
    return ious


def match_image_coco(
    ious: np.ndarray,        # (D, G) rows score-sorted; crowd-variant cols
    thresholds: np.ndarray,  # (T,)
    gt_is_crowd: np.ndarray,  # (G,) bool
    gt_ignore: np.ndarray,   # (A, G) bool — crowd OR outside area range
    det_ignore: np.ndarray,  # (A, D) bool — det area outside range
) -> tuple[np.ndarray, np.ndarray]:
    """Full-protocol greedy matching, vectorized over (area-range,
    threshold, gt) — the detection loop is the only Python loop.

    Per pycocotools: a detection takes the highest-IoU available
    NON-ignored gt at/above the threshold; failing that, the highest-IoU
    ignored gt (crowd gts stay available forever, others are consumed).
    Returns ``(tp, ig)`` bool (D, A, T): true positive / ignored (matched
    an ignore region, or unmatched and outside the range).
    """
    d, g = ious.shape
    a = gt_ignore.shape[0]
    t = len(thresholds)
    tp = np.zeros((d, a, t), bool)
    ig = np.zeros((d, a, t), bool)
    if d == 0:
        return tp, ig
    if g == 0:
        ig[:] = det_ignore.T[:, :, None]
        return tp, ig
    crowd = np.asarray(gt_is_crowd, bool)
    taken = np.zeros((a, t, g), bool)
    thr = np.asarray(thresholds)[None, :, None]          # (1, T, 1)
    for i in range(d):
        iou_row = ious[i][None, None, :]                 # (1, 1, G)
        cand = (~taken | crowd[None, None, :]) & (iou_row >= thr)  # (A,T,G)
        reg = cand & ~gt_ignore[:, None, :]
        has_reg = reg.any(-1)                            # (A, T)
        pool = np.where(has_reg[..., None], reg, cand)
        masked = np.where(pool, iou_row, -1.0)           # (A, T, G)
        j = masked.argmax(-1)                            # (A, T)
        matched = pool.any(-1)
        tp[i] = has_reg
        ig[i] = matched & ~has_reg
        take = matched & ~crowd[j]
        ai, ti = np.nonzero(take)
        taken[ai, ti, j[ai, ti]] = True
    unmatched = ~(tp | ig)
    ig |= unmatched & det_ignore.T[:, :, None]
    return tp, ig


def average_precision_multi(scores: np.ndarray, tp: np.ndarray,
                            num_gt: int) -> np.ndarray:
    """All-point-interpolated AP at every threshold column of ``tp``.

    ``scores`` (D,), ``tp`` (D, T) -> AP (T,). One sort + one cumsum pass
    shared across all T thresholds.
    """
    t = tp.shape[1]
    if num_gt == 0:
        return np.full(t, np.nan)
    if len(scores) == 0:
        return np.zeros(t)
    order = np.argsort(-scores, kind="stable")
    tp = tp[order]
    cum_tp = np.cumsum(tp, axis=0)
    cum_fp = np.cumsum(~tp, axis=0)
    recall = cum_tp / num_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)
    # precision envelope
    precision = np.maximum.accumulate(precision[::-1], axis=0)[::-1]
    # integrate over recall deltas
    r = np.concatenate([np.zeros((1, t)), recall], axis=0)
    return np.sum((r[1:] - r[:-1]) * precision, axis=0)


def average_precision(scores: np.ndarray, tp: np.ndarray,
                      num_gt: int) -> float:
    """All-point-interpolated AP from per-detection (score, tp) pairs."""
    return float(
        average_precision_multi(np.asarray(scores),
                                np.asarray(tp, bool).reshape(-1, 1),
                                num_gt)[0]
    )


def _ap_from_sorted(tp_col: np.ndarray, num_gt: int) -> float:
    """AP from a score-sorted tp column (ignored rows already removed)."""
    if len(tp_col) == 0:
        return 0.0
    cum_tp = np.cumsum(tp_col)
    cum_fp = np.cumsum(~tp_col)
    recall = cum_tp / num_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    r = np.concatenate([[0.0], recall])
    return float(np.sum((r[1:] - r[:-1]) * precision))


class DetectionEvaluator:
    """Accumulates per-image predictions + ground truth, computes the
    12-metric COCO table (plus PASCAL-style per-class AP50)."""

    def __init__(self, num_classes: int,
                 iou_thresholds=COCO_IOU_THRESHOLDS):
        self.num_classes = num_classes
        self.iou_thresholds = np.asarray(iou_thresholds)
        # per class: lists of per-image-class arrays
        self._scores: list[list[np.ndarray]] = [[] for _ in range(num_classes)]
        self._rank: list[list[np.ndarray]] = [[] for _ in range(num_classes)]
        self._tp: list[list[np.ndarray]] = [[] for _ in range(num_classes)]
        self._ig: list[list[np.ndarray]] = [[] for _ in range(num_classes)]
        # non-ignored gt count per (class, area range)
        self._num_gt = np.zeros((num_classes, len(AREA_RANGES)), np.int64)

    def add_image(
        self,
        det_boxes: np.ndarray,   # (D, 4)
        det_scores: np.ndarray,  # (D,)
        det_labels: np.ndarray,  # (D,)
        gt_boxes: np.ndarray,    # (G, 4)
        gt_labels: np.ndarray,   # (G,)
        gt_is_crowd: np.ndarray | None = None,  # (G,) bool/int
        image_hw: tuple | None = None,  # original pixel dims for area buckets
    ) -> None:
        gt_is_crowd = (np.zeros(len(gt_boxes), bool) if gt_is_crowd is None
                       else np.asarray(gt_is_crowd, bool))
        # areas in original-image pixels (pycocotools buckets); without
        # dims the area metrics collapse (everything "small") but the
        # "all" range — and therefore mAP/AP50/AP75/AR@k — is unaffected
        h, w = (1.0, 1.0) if image_hw is None else (float(image_hw[0]),
                                                    float(image_hw[1]))
        scale = h * w
        lo, hi = AREA_RANGES[:, 0:1], AREA_RANGES[:, 1:2]

        gt_areas = ((gt_boxes[:, 2] - gt_boxes[:, 0])
                    * (gt_boxes[:, 3] - gt_boxes[:, 1]) * scale
                    if len(gt_boxes) else np.zeros(0))
        det_areas = ((det_boxes[:, 2] - det_boxes[:, 0])
                     * (det_boxes[:, 3] - det_boxes[:, 1]) * scale
                     if len(det_boxes) else np.zeros(0))

        det_labels = np.asarray(det_labels)
        gt_labels = np.asarray(gt_labels)
        for c in np.unique(np.concatenate([det_labels, gt_labels])).astype(int):
            if c < 0 or c >= self.num_classes:
                continue
            dmask = det_labels == c
            gmask = gt_labels == c
            crowd_c = gt_is_crowd[gmask]
            areas_c = gt_areas[gmask]
            # gt ignored per area range: crowd OR out of range
            gt_ignore = (crowd_c[None, :]
                         | (areas_c[None, :] < lo) | (areas_c[None, :] > hi))
            self._num_gt[c] += np.sum(~gt_ignore, axis=1)
            if not dmask.any():
                continue
            scores_c = det_scores[dmask]
            order = np.argsort(-scores_c, kind="stable")[:MAX_DETS[-1]]
            boxes_c = det_boxes[dmask][order]
            scores_c = scores_c[order]
            da_c = det_areas[dmask][order]
            det_ignore = (da_c[None, :] < lo) | (da_c[None, :] > hi)
            gt_c = gt_boxes[gmask]
            ious = (coco_iou_matrix(boxes_c, gt_c, crowd_c)
                    if len(gt_c) else np.zeros((len(boxes_c), 0)))
            tp, ig = match_image_coco(
                ious, self.iou_thresholds, crowd_c, gt_ignore, det_ignore)
            self._scores[c].append(scores_c)
            self._rank[c].append(np.arange(len(scores_c), dtype=np.int32))
            self._tp[c].append(tp)
            self._ig[c].append(ig)

    def add_batch(self, detections: dict, gt_boxes, gt_labels, num_boxes,
                  valid=None, gt_is_crowd=None, orig_hw=None) -> None:
        """detections: the Detections dict/namedtuple from predict (numpy).

        ``valid`` (B,) bool: rows that are real examples; padded tail rows
        of an eval batch (pipeline ``valid`` mask) are skipped.
        ``gt_is_crowd`` (B, M): pipeline crowd flags (ignore regions);
        ``orig_hw`` (B, 2): original pixel dims for the area buckets.
        """
        boxes = np.asarray(detections["boxes"] if isinstance(detections, dict)
                           else detections.boxes)
        scores = np.asarray(detections["scores"] if isinstance(detections, dict)
                            else detections.scores)
        labels = np.asarray(detections["labels"] if isinstance(detections, dict)
                            else detections.labels)
        nb = np.asarray(detections["num_boxes"] if isinstance(detections, dict)
                        else detections.num_boxes)
        for i in range(len(boxes)):
            if valid is not None and not valid[i]:
                continue
            d = int(nb[i])
            g = int(num_boxes[i])
            self.add_image(
                boxes[i, :d], scores[i, :d], labels[i, :d],
                np.asarray(gt_boxes[i][:g]), np.asarray(gt_labels[i][:g]),
                gt_is_crowd=(None if gt_is_crowd is None
                             else np.asarray(gt_is_crowd[i][:g])),
                image_hw=(None if orig_hw is None else tuple(orig_hw[i])),
            )

    def merge(self, other: "DetectionEvaluator") -> None:
        """Fold another evaluator's accumulated stats into this one.

        Statistically exact: every metric depends only on the global
        multiset of per-detection (score, rank, tp, ig) rows per class
        plus the global gt counts, so evaluating disjoint shards on
        separate evaluators and merging equals a single-stream evaluation.
        """
        assert other.num_classes == self.num_classes
        assert np.allclose(other.iou_thresholds, self.iou_thresholds)
        for c in range(self.num_classes):
            self._scores[c].extend(other._scores[c])
            self._rank[c].extend(other._rank[c])
            self._tp[c].extend(other._tp[c])
            self._ig[c].extend(other._ig[c])
        self._num_gt += other._num_gt

    def _pack(self) -> dict:
        """Fixed-dtype flat arrays of the accumulated state (for the
        all-gather)."""
        t = len(self.iou_thresholds)
        a = len(AREA_RANGES)
        scores, ranks, tps, igs, cls = [], [], [], [], []
        for c in range(self.num_classes):
            for s, r, tp, ig in zip(self._scores[c], self._rank[c],
                                    self._tp[c], self._ig[c]):
                scores.append(np.asarray(s, np.float32))
                ranks.append(np.asarray(r, np.int32))
                tps.append(np.asarray(tp, bool))
                igs.append(np.asarray(ig, bool))
                cls.append(np.full(len(s), c, np.int32))
        return {
            "scores": (np.concatenate(scores) if scores
                       else np.zeros(0, np.float32)),
            "rank": (np.concatenate(ranks) if ranks
                     else np.zeros(0, np.int32)),
            "tp": (np.concatenate(tps, axis=0) if tps
                   else np.zeros((0, a, t), bool)),
            "ig": (np.concatenate(igs, axis=0) if igs
                   else np.zeros((0, a, t), bool)),
            "cls": (np.concatenate(cls) if cls else np.zeros(0, np.int32)),
            "num_gt": self._num_gt.copy(),
        }

    def _load_packed(self, packed: dict) -> None:
        """Merges one rank's packed state (the inverse of :meth:`_pack`);
        rows of class -1 are padding. The per-image boundaries live on in
        ``rank`` (it restarts at 0 at each image), all the metrics need."""
        cls = np.asarray(packed["cls"])
        scores = np.asarray(packed["scores"])
        rank = np.asarray(packed["rank"])
        tp = np.asarray(packed["tp"], bool)
        ig = np.asarray(packed["ig"], bool)
        for c in np.unique(cls):
            if c < 0:  # padding sentinel
                continue
            m = cls == c
            self._scores[int(c)].append(scores[m])
            self._rank[int(c)].append(rank[m])
            self._tp[int(c)].append(tp[m])
            self._ig[int(c)].append(ig[m])
        self._num_gt += np.asarray(packed["num_gt"], np.int64)

    def gather(self) -> "DetectionEvaluator":
        """Every rank's statistics folded into one evaluator, the same on
        every rank (at world size 1 too); ``self`` without a process
        group.

        Each rank's packed statistics are padded to the largest count
        (class sentinel -1), all-gathered as CPU tensors over the host
        group (gloo beside the card's NCCL), and folded in rank order 0 ..
        P-1, so that score ties resolve as in JAX's gather."""
        import torch
        import torch.distributed as dist

        from ssd_tpu_torch.parallel.mesh import host_group

        if not dist.is_initialized():
            return self
        group = host_group()
        world = dist.get_world_size()
        packed = self._pack()
        n = len(packed["scores"])
        counts = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
        dist.all_gather(counts, torch.tensor([n], dtype=torch.int64),
                        group=group)
        pad = int(max(int(c) for c in counts)) - n
        padded = {
            "scores": np.pad(packed["scores"], (0, pad)),
            "rank": np.pad(packed["rank"], (0, pad)),
            "tp": np.pad(packed["tp"], ((0, pad), (0, 0), (0, 0)))
            .astype(np.uint8),
            "ig": np.pad(packed["ig"], ((0, pad), (0, 0), (0, 0)))
            .astype(np.uint8),
            "cls": np.pad(packed["cls"], (0, pad), constant_values=-1),
            "num_gt": packed["num_gt"],
        }
        gathered = {}
        for k, v in padded.items():
            local = torch.from_numpy(np.ascontiguousarray(v))
            parts = [torch.empty_like(local) for _ in range(world)]
            dist.all_gather(parts, local, group=group)
            gathered[k] = [p.numpy() for p in parts]
        out = DetectionEvaluator(self.num_classes, self.iou_thresholds)
        for p in range(world):
            out._load_packed({k: v[p] for k, v in gathered.items()})
        assert int(out._num_gt.sum()) >= int(self._num_gt.sum())
        return out

    def result(self) -> dict:
        t = len(self.iou_thresholds)
        n_area = len(AREA_RANGES)
        n_md = len(MAX_DETS)
        ap = np.full((self.num_classes, n_area, t), np.nan)
        ar = np.full((self.num_classes, n_area, n_md, t), np.nan)
        for c in range(self.num_classes):
            if self._scores[c]:
                scores = np.concatenate(self._scores[c])
                rank = np.concatenate(self._rank[c])
                tp = np.concatenate(self._tp[c], axis=0)  # (D, A, T)
                ig = np.concatenate(self._ig[c], axis=0)
            else:
                scores = np.zeros(0)
                rank = np.zeros(0, np.int32)
                tp = np.zeros((0, n_area, t), bool)
                ig = np.zeros((0, n_area, t), bool)
            order = np.argsort(-scores, kind="stable")
            tp_o, ig_o, rank_o = tp[order], ig[order], rank[order]
            for a in range(n_area):
                npig = int(self._num_gt[c, a])
                if npig == 0:
                    continue
                for ti in range(t):
                    keep = ~ig_o[:, a, ti]
                    ap[c, a, ti] = _ap_from_sorted(tp_o[keep, a, ti], npig)
                    for mi, md in enumerate(MAX_DETS):
                        ar[c, a, mi, ti] = (
                            np.sum(tp_o[rank_o < md, a, ti]) / npig)
        idx50 = int(np.argmin(np.abs(self.iou_thresholds - 0.5)))
        idx75 = int(np.argmin(np.abs(self.iou_thresholds - 0.75)))
        with np.errstate(invalid="ignore"):
            import warnings
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                return {
                    "mAP": float(np.nanmean(ap[:, 0, :])),
                    "AP50": float(np.nanmean(ap[:, 0, idx50])),
                    "AP75": float(np.nanmean(ap[:, 0, idx75])),
                    "AP_small": float(np.nanmean(ap[:, 1, :])),
                    "AP_medium": float(np.nanmean(ap[:, 2, :])),
                    "AP_large": float(np.nanmean(ap[:, 3, :])),
                    "AR@1": float(np.nanmean(ar[:, 0, 0, :])),
                    "AR@10": float(np.nanmean(ar[:, 0, 1, :])),
                    "AR@100": float(np.nanmean(ar[:, 0, 2, :])),
                    "AR_small": float(np.nanmean(ar[:, 1, 2, :])),
                    "AR_medium": float(np.nanmean(ar[:, 2, 2, :])),
                    "AR_large": float(np.nanmean(ar[:, 3, 2, :])),
                    "per_class_AP50": np.asarray(ap[:, 0, idx50]),
                }


def detections_to_coco(det: dict, source_ids, orig_hw, valid=None,
                       category_ids: dict | None = None) -> list[dict]:
    """One batch of detections -> pycocotools results-format entries.

    ``det``: {boxes (B, D, 4) normalized ymin/xmin/ymax/xmax, scores,
    labels, num_boxes}; ``source_ids (B,)`` original dataset image ids;
    ``orig_hw (B, 2)`` pre-resize image dims (the square-stretch resize
    keeps normalized coords aligned with the original frame);
    ``category_ids`` maps contiguous labels back to dataset category ids
    (identity when None). Output bbox format is COCO [x, y, w, h] in
    absolute original-image pixels.
    """
    out = []
    b = len(source_ids)
    for i in range(b):
        if valid is not None and not bool(valid[i]):
            continue
        h, w = int(orig_hw[i][0]), int(orig_hw[i][1])
        n = int(det["num_boxes"][i])
        for d in range(n):
            y0, x0, y1, x1 = [float(v) for v in det["boxes"][i][d]]
            lab = int(det["labels"][i][d])
            out.append({
                "image_id": int(source_ids[i]),
                "category_id": int(category_ids.get(lab, lab))
                if category_ids else lab,
                "bbox": [round(x0 * w, 2), round(y0 * h, 2),
                         round((x1 - x0) * w, 2), round((y1 - y0) * h, 2)],
                "score": round(float(det["scores"][i][d]), 5),
            })
    return out
