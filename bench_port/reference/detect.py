"""Plain reference of the detection postprocess: anchors, box coding,
cell-major candidate selection, per-class top-k, greedy hard NMS and the
class merge, in float32. A frozen copy of the port's plain versions
(``ops/anchors.py``, ``ops/box_utils.py``, ``ops/postprocess.py``,
``ops/nms.py``) that imports nothing of the port. The greedy suppression
is the textbook loop: candidate ``i``, if still kept, drops every later one
whose IoU with it exceeds the threshold.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EPSILON = 1e-8
SCALE_FACTORS = (10.0, 10.0, 5.0, 5.0)


def f32(x: float) -> float:
    return float(np.float32(x))


def anchors(image_size: int, a: dict) -> np.ndarray:
    """RetinaNet anchors ``(A, 4)`` normalized ``(ymin, xmin, ymax,
    xmax)``, in (level, row, col, scale-major aspect-minor) order."""
    spo = a["scales_per_octave"]
    out = []
    for level in range(a["min_level"], a["max_level"] + 1):
        stride = 2 ** level
        fh = fw = -(-image_size // stride)
        sizes = []
        for k in range(spo):
            for ar in a["aspect_ratios"]:
                s = a["anchor_scale"] * stride * 2 ** (k / spo)
                sizes.append((s / np.sqrt(ar), s * np.sqrt(ar)))
        sizes = np.asarray(sizes, np.float32)
        cy = (np.arange(fh, dtype=np.float32) + 0.5) * stride
        cx = (np.arange(fw, dtype=np.float32) + 0.5) * stride
        cy, cx = np.meshgrid(cy, cx, indexing="ij")
        centers = np.stack([cy, cx], -1)[:, :, None, :]
        half = 0.5 * sizes[None, None]
        boxes = np.concatenate([centers - half, centers + half],
                               -1).reshape(-1, 4)
        out.append(boxes / np.float32(image_size))
    return np.concatenate(out).astype(np.float32)


def area(b: torch.Tensor) -> torch.Tensor:
    return ((b[..., 2] - b[..., 0]).clamp_min(0.0)
            * (b[..., 3] - b[..., 1]).clamp_min(0.0))


def iou(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """``(..., N, 4) x (..., M, 4) -> (..., N, M)``."""
    h = (torch.minimum(b1[..., :, None, 2], b2[..., None, :, 2])
         - torch.maximum(b1[..., :, None, 0], b2[..., None, :, 0])
         ).clamp_min(0.0)
    w = (torch.minimum(b1[..., :, None, 3], b2[..., None, :, 3])
         - torch.maximum(b1[..., :, None, 1], b2[..., None, :, 1])
         ).clamp_min(0.0)
    inter = h * w
    union = area(b1)[..., :, None] + area(b2)[..., None, :] - inter
    return inter / union.clamp_min(EPSILON)


def center_form(b: torch.Tensor):
    h, w = b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]
    return b[..., 0] + 0.5 * h, b[..., 1] + 0.5 * w, h, w


def encode(boxes: torch.Tensor, anc: torch.Tensor) -> torch.Tensor:
    cy, cx, h, w = center_form(boxes)
    cya, cxa, ha, wa = center_form(anc)
    ha, wa = ha.clamp_min(EPSILON), wa.clamp_min(EPSILON)
    h, w = h.clamp_min(EPSILON), w.clamp_min(EPSILON)
    sy, sx, sh, sw = SCALE_FACTORS
    return torch.stack([(cy - cya) / ha * sy, (cx - cxa) / wa * sx,
                        torch.log(h / ha) * sh, torch.log(w / wa) * sw], -1)


def decode(codes: torch.Tensor, anc: torch.Tensor,
           clip: bool = True) -> torch.Tensor:
    """Codes -> corner boxes, clipped to the unit square unless ``clip``
    is False."""
    cya, cxa, ha, wa = center_form(anc)
    sy, sx, sh, sw = SCALE_FACTORS
    th = torch.clamp_max(codes[..., 2] / sh, 10.0)
    tw = torch.clamp_max(codes[..., 3] / sw, 10.0)
    cy = codes[..., 0] / sy * ha + cya
    cx = codes[..., 1] / sx * wa + cxa
    h, w = torch.exp(th) * ha, torch.exp(tw) * wa
    boxes = torch.stack([cy - 0.5 * h, cx - 0.5 * w, cy + 0.5 * h,
                         cx + 0.5 * w], -1)
    return boxes.clamp(0.0, 1.0) if clip else boxes


def topk_stable(x: torch.Tensor, k: int):
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(t, 1, idx[..., None].expand(*idx.shape, t.shape[-1]))


def select_cells(raw: list, anc: torch.Tensor, num_classes: int,
                 nms: dict):
    """Cell-major selection: the top ``ceil(Q * over / K)`` cells by their
    best logit over the score threshold, then the top ``Q`` of their
    anchors by best logit. -> ``boxes (N, Q, 4)``, ``scores (N, Q, C)``
    (0 for dead candidates)."""
    n = raw[0][0].shape[0]
    kc = raw[0][0].shape[-1]
    k = kc // num_classes
    thr = f32(math.log(nms["score_threshold"]
                       / (1.0 - nms["score_threshold"])))
    cls = torch.cat([c.reshape(n, -1, kc) for c, _ in raw], 1).float()
    box = torch.cat([b.reshape(n, -1, 4 * k) for _, b in raw], 1).float()
    cells = cls.shape[1]
    neg = cls.new_full((), -math.inf)
    cell_logit = cls.amax(-1)
    cell_logit = torch.where(cell_logit >= thr, cell_logit, neg)
    q = nms["num_candidates"]
    q_cells = min(-(-int(q * max(float(nms["cell_overprovision"]), 1.0))
                    // k), cells)
    top, cidx = topk_stable(cell_logit, q_cells)
    logits = _rows(cls, cidx).reshape(n, q_cells * k, num_classes)
    deltas = _rows(box, cidx).reshape(n, q_cells * k, 4)
    canc = anc.reshape(cells, k, 4)[cidx].reshape(n, q_cells * k, 4)
    live = torch.isfinite(top)[..., None].expand(n, q_cells, k).reshape(
        n, -1)
    if q_cells * k > q:
        rank = torch.where(live, logits.amax(-1), neg)
        top_rank, aidx = topk_stable(rank, q)
        live = torch.isfinite(top_rank)
        logits, deltas, canc = (_rows(logits, aidx), _rows(deltas, aidx),
                                _rows(canc, aidx))
    scores = torch.where(live[..., None], torch.sigmoid(logits), 0.0)
    return decode(deltas, canc), scores


def hard_nms(boxes: torch.Tensor, scores: torch.Tensor, nms: dict) -> dict:
    """Per-class top-``pre_nms_top_k`` over the score threshold, greedy
    suppression of each (image, class), then the top ``max_boxes`` of the
    survivors -> padded ``boxes, scores, labels, num_boxes``."""
    n, q, c = scores.shape
    k = min(nms["pre_nms_top_k"], q)
    st = scores.transpose(1, 2)
    st = torch.where(st >= f32(nms["score_threshold"]), st,
                     st.new_full((), -1.0))
    top_s, top_i = topk_stable(st, k)  # (N, C, K)
    flat = top_i.reshape(n, c * k)
    tb = torch.gather(boxes, 1, flat[..., None].expand(n, c * k, 4)
                      ).reshape(n, c, k, 4)
    over = iou(tb, tb) > f32(nms["iou_threshold"])
    over &= torch.ones(k, k, dtype=torch.bool,
                       device=boxes.device).triu(1)
    keep = top_s > 0.0
    for i in range(k):
        keep &= ~(over[..., i, :] & keep[..., i:i + 1])
    kept = torch.where(keep, top_s, top_s.new_full((), -1.0)).reshape(
        n, c * k)
    m = min(nms["max_boxes"], c * k)
    fs, fi = topk_stable(kept, m)
    fb = torch.gather(boxes, 1, torch.gather(flat, 1, fi)[..., None]
                      .expand(n, m, 4))
    labels = torch.div(fi, k, rounding_mode="floor").int()
    det = fs > 0.0
    return {"boxes": torch.where(det[..., None], fb, 0.0),
            "scores": torch.where(det, fs, 0.0),
            "labels": torch.where(det, labels, -1),
            "num_boxes": det.sum(1).int()}


def greedy_ious(boxes: torch.Tensor, scores: torch.Tensor,
                nms: dict) -> int:
    """The IoUs greedy suppression needs on these candidates: for each
    pivot still kept at its step, one per later candidate still alive
    (the count behind the NMS kernel's bound)."""
    n, q, c = scores.shape
    k = min(nms["pre_nms_top_k"], q)
    st = scores.transpose(1, 2)
    st = torch.where(st >= f32(nms["score_threshold"]), st,
                     st.new_full((), -1.0))
    top_s, top_i = topk_stable(st, k)
    flat = top_i.reshape(n, c * k)
    tb = torch.gather(boxes, 1, flat[..., None].expand(n, c * k, 4)
                      ).reshape(n, c, k, 4)
    over = iou(tb, tb) > f32(nms["iou_threshold"])
    over &= torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    keep = top_s > 0.0
    count = torch.zeros((), dtype=torch.int64, device=boxes.device)
    for i in range(k):
        pivot = keep[..., i]
        count += (pivot[..., None] & keep[..., i + 1:]).sum()
        keep &= ~(over[..., i, :] & pivot[..., None])
    return int(count)
