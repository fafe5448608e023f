"""Test-time augmentation and model ensembles, fused by weighted box fusion
(the port's ``ssd_tpu/tta.py``).

``TTAPredictor`` runs each image and its horizontal flip as ONE batched
predict (a batch of N is a predict of 2N, in the bucket of 2N, K1 doing
its NMS), maps the flipped view's boxes back, and fuses each image's two
views with ``ops/wbf.weighted_box_fusion`` (or a class-wise NMS,
``tiling.merge_nms``), for all images at once on the predictor's device.
Its ``predict_dispatch``/``predict_collect`` split is the predictor's, so
the serving daemon pipelines through it (``python -m ssd_tpu_torch.serve
--tta``). ``EnsemblePredictor`` fuses several predictors' detections of
the same batch the same way.

    python -m ssd_tpu_torch.predictor --export DIR --images a.jpg --tta
"""

from __future__ import annotations

import numpy as np
import torch

from ssd_tpu_torch.ops.wbf import weighted_box_fusion
from ssd_tpu_torch.tiling import merge_nms

DET_KEYS = ("boxes", "scores", "labels", "num_boxes")


def unflip_boxes(boxes: np.ndarray) -> np.ndarray:
    """Boxes detected on a horizontally flipped frame, mapped back:
    ``x' = 1 - x``, xmin and xmax swapped. ``(..., 4)`` yxyx."""
    out = np.asarray(boxes).copy()
    out[..., [1, 3]] = 1.0 - out[..., [3, 1]]
    return out


def fuse_views(boxes, scores, labels, iou_threshold: float, max_boxes: int,
               merge: str = "wbf", num_views: int = 2, device=None):
    """Fuse each image's flat candidate set from ``num_views`` views, on
    ``device`` (numpy in and out).

    ``boxes (..., K, 4)`` already in the original frame, ``scores (...,
    K)`` (invalid slots <= 0), ``labels (..., K)``; a leading axis holds
    several images. Returns ``(boxes, scores, labels, count)``.
    """
    args = [torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)
            for a, dt in ((boxes, np.float32), (scores, np.float32),
                          (labels, np.int32))]
    if merge == "wbf":
        out = weighted_box_fusion(*args, iou_threshold, max_boxes,
                                  num_views=num_views)
    else:
        out = merge_nms(*args, iou_threshold, max_boxes, metric="iou")
    return tuple(t.cpu().numpy() for t in out)


def fuse_flip_batch(out: dict, out_flipped: dict, iou_threshold: float,
                    max_boxes: int, merge: str = "wbf", device=None) -> dict:
    """Flip-TTA fusion of a batch: ``out`` and ``out_flipped`` are numpy
    detections ``(N, M, ...)`` of the base and the flipped views; the
    flipped boxes are mapped back and each image's views fused."""
    b, s, l, c = fuse_views(
        np.concatenate([out["boxes"], unflip_boxes(out_flipped["boxes"])],
                       axis=1),
        np.concatenate([out["scores"], out_flipped["scores"]], axis=1),
        np.concatenate([out["labels"], out_flipped["labels"]], axis=1),
        iou_threshold, max_boxes, merge=merge, device=device)
    return {"boxes": b, "scores": s, "labels": l, "num_boxes": c}


def _image_list(images) -> tuple[list, bool]:
    """A predict's input -> (list of (H, W, 3) images, single)."""
    if isinstance(images, (list, tuple)):
        return [np.asarray(im) for im in images], False
    images = np.asarray(images)
    single = images.ndim == 3
    return ([images] if single else list(images)), single


def _names(result: dict, label_map) -> dict:
    if label_map is not None:
        result["names"] = np.array([
            [label_map.get(int(x), str(int(x))) for x in row]
            for row in result["labels"]])
    return result


class EnsemblePredictor:
    """Fuse the detections of SEVERAL predictors (other backbones or
    training seeds) of the same batch with weighted box fusion: each
    member predicts the batch (at its own resolution), and per image the
    union is fused with the cross-model coverage adjustment (a box only one
    model found is down-weighted). ``weights`` scale each member's scores
    first. The fusion runs on the first member's device."""

    def __init__(self, predictors, weights=None, merge: str = "wbf",
                 iou_threshold: float | None = None,
                 max_boxes: int | None = None):
        if not predictors:
            raise ValueError("need at least one predictor")
        if weights is not None and len(weights) != len(predictors):
            raise ValueError("one weight per predictor")
        if merge not in ("wbf", "nms"):
            raise ValueError(f"merge must be wbf|nms, got {merge}")
        self.predictors = list(predictors)
        self.weights = ([1.0] * len(predictors) if weights is None
                        else [float(w) for w in weights])
        self.cfg = self.predictors[0].cfg
        self.device = self.predictors[0].device
        self.merge = merge
        self.iou_threshold = float(iou_threshold if iou_threshold is not None
                                   else self.cfg.nms.iou_threshold)
        self.max_boxes = int(max_boxes or self.cfg.nms.max_boxes)
        self.label_map = getattr(self.predictors[0], "label_map", None)

    def predict(self, images) -> dict:
        image_list, single = _image_list(images)
        outs = [p.predict(image_list) for p in self.predictors]
        # each member's scores times its weight, in f32 as numpy multiplies
        scores = np.concatenate(
            [np.asarray(o["scores"]) * w for o, w in zip(outs, self.weights)],
            axis=1)
        b, s, l, c = fuse_views(
            np.concatenate([np.asarray(o["boxes"]) for o in outs], axis=1),
            scores,
            np.concatenate([np.asarray(o["labels"]) for o in outs], axis=1),
            self.iou_threshold, self.max_boxes, merge=self.merge,
            num_views=len(self.predictors), device=self.device)
        result = _names({"boxes": b, "scores": s, "labels": l,
                         "num_boxes": c}, self.label_map)
        if single:
            result = {k: v[0] for k, v in result.items()}
        return result


class TTAPredictor:
    """``predict(image | images | [images])`` with flip TTA.

    ``predictor``: a ``Predictor``, or any object with ``predict`` (an
    ``EnsemblePredictor``), whose doubled batch then runs at dispatch.
    ``merge``: ``"wbf"`` (fuse clusters into weighted averages) or
    ``"nms"`` (keep the best view's box).
    ``iou_threshold``, ``max_boxes``: the merge's (default the config's
    NMS ones). The daemon takes it where it takes a ``Predictor``: it
    dispatches the doubled batch without waiting and fuses in
    ``predict_collect``; the handler threads do not pre-pack images
    (``_packed`` is False: the flip needs the pixels), the predictor packs
    both views.
    """

    _packed = False  # the daemon's handler threads pass raw images

    def __init__(self, predictor, merge: str = "wbf",
                 iou_threshold: float | None = None,
                 max_boxes: int | None = None):
        if merge not in ("wbf", "nms"):
            raise ValueError(f"merge must be wbf|nms, got {merge}")
        self.predictor = predictor
        self.cfg = predictor.cfg
        self.device = predictor.device
        self.merge = merge
        self.iou_threshold = float(iou_threshold if iou_threshold is not None
                                   else self.cfg.nms.iou_threshold)
        self.max_boxes = int(max_boxes or self.cfg.nms.max_boxes)
        self.label_map = getattr(predictor, "label_map", None)

    # the daemon's surface, mirroring Predictor's
    @property
    def preserve_aspect(self) -> bool:
        return getattr(self.predictor, "preserve_aspect", False)

    @property
    def staging(self):
        return self.predictor.staging

    def _bucket_for(self, n: int) -> int:
        return self.predictor._bucket_for(2 * n)  # the card sees 2n images

    def warmup(self, batch_size: int = 1) -> None:
        self.predictor.warmup(2 * batch_size)

    def predict(self, images) -> dict:
        return self.predict_collect(self.predict_dispatch(images))

    def predict_dispatch(self, images) -> dict:
        """ONE device call of ``[img_0..img_{n-1}, flip_0..flip_{n-1}]``,
        enqueued without waiting."""
        image_list, single = _image_list(images)
        views = image_list + [im[:, ::-1] for im in image_list]
        if hasattr(self.predictor, "predict_dispatch"):
            inner = self.predictor.predict_dispatch(views)
        else:  # a member without the split (an ensemble): block here
            inner = {"done": self.predictor.predict(views)}
        return {"inner": inner, "n": len(image_list), "single": single}

    def predict_collect(self, handle: dict) -> dict:
        """Readback of both views, then their fusion on the device."""
        inner = handle["inner"]
        out = (inner["done"] if "done" in inner
               else self.predictor.predict_collect(inner))
        n = handle["n"]
        base = {k: np.asarray(out[k])[:n] for k in DET_KEYS}
        flip = {k: np.asarray(out[k])[n:] for k in DET_KEYS}
        result = _names(fuse_flip_batch(
            base, flip, self.iou_threshold, self.max_boxes, merge=self.merge,
            device=self.device), self.label_map)
        if handle["single"]:
            result = {k: v[0] for k, v in result.items()}
        return result
