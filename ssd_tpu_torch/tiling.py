"""Tiled inference: native-resolution detection on images far above the
model resolution (the port's ``ssd_tpu/tiling.py``).

The image is cut into model-resolution tiles with overlap; all tiles, and
optionally the whole image resized to the model resolution (for objects
larger than a tile), run as ONE batched ``Predictor.predict`` (a 4K image
is a predict of 41 images, bucket 64, with K1 doing its NMS); each tile's
detections map back to image coordinates, and one global class-wise merge
(``merge_nms``) on the predictor's device fuses the duplicates that the
overlap makes.

The merge measures overlap as intersection over the smaller box (IoS) by
default: a detection clipped at a tile's interior edge is a fragment of
the object another tile or the full pass sees whole, with an IoU with it
well under any threshold but an IoS near 1. Detections touching an
interior tile edge are down-weighted by ``edge_penalty`` first.

    python -m ssd_tpu_torch.predictor --export DIR --images big.jpg \\
        --tiled [--tile-overlap 0.25] [--edge-penalty 0.5]
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ssd_tpu_torch.ops.nms import greedy_suppression_mask, topk_stable
from ssd_tpu_torch.ops.wbf import offset_boxes, pad_detections, \
    sort_candidates


def tile_origins(dim: int, tile: int, overlap: float) -> list[int]:
    """Top/left origins covering ``dim`` with ``tile``-sized windows and at
    least ``overlap`` fractional overlap between neighbours; the last
    window is clamped flush to the edge."""
    if dim <= tile:
        return [0]
    stride = max(1, int(round(tile * (1.0 - overlap))))
    origins = list(range(0, dim - tile + 1, stride))
    if origins[-1] + tile < dim:
        origins.append(dim - tile)
    return origins


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """The tile layout of one (image, tile, overlap) combination."""

    image_hw: tuple[int, int]
    tile_hw: tuple[int, int]
    origins: tuple[tuple[int, int], ...]  # (y0, x0) per tile, pixels

    @classmethod
    def build(cls, image_hw, tile_hw, overlap: float) -> "TileGrid":
        ys = tile_origins(image_hw[0], tile_hw[0], overlap)
        xs = tile_origins(image_hw[1], tile_hw[1], overlap)
        return cls(tuple(image_hw), tuple(tile_hw),
                   tuple((y, x) for y in ys for x in xs))

    def crops(self, image: np.ndarray) -> np.ndarray:
        """``(T, th, tw, 3)`` uint8 tiles; a tile running past the image (an
        image smaller than a tile) is zero-padded."""
        th, tw = self.tile_hw
        out = np.zeros((len(self.origins), th, tw, 3), np.uint8)
        for i, (y0, x0) in enumerate(self.origins):
            crop = image[y0:y0 + th, x0:x0 + tw]
            out[i, :crop.shape[0], :crop.shape[1]] = crop
        return out

    def interior_edge_mask(self, i: int, boxes: np.ndarray,
                           eps_px: float = 2.0) -> np.ndarray:
        """``(k,)`` bool: which tile-normalized boxes of tile ``i`` touch a
        tile border inside the image (where the object may go on into the
        next tile, so the box may be a clip of it)."""
        h, w = self.image_hw
        th, tw = self.tile_hw
        y0, x0 = self.origins[i]
        ey, ex = eps_px / th, eps_px / tw
        touches = np.zeros(boxes.shape[0], bool)
        if y0 > 0:
            touches |= boxes[:, 0] < ey
        if x0 > 0:
            touches |= boxes[:, 1] < ex
        if y0 + th < h:
            touches |= boxes[:, 2] > 1.0 - ey
        if x0 + tw < w:
            touches |= boxes[:, 3] > 1.0 - ex
        return touches

    def to_global(self, i: int, boxes: np.ndarray) -> np.ndarray:
        """Tile-normalized ``(k, 4)`` yxyx boxes of tile ``i`` ->
        image-normalized, clipped to the frame."""
        h, w = self.image_hw
        th, tw = self.tile_hw
        y0, x0 = self.origins[i]
        out = np.empty_like(boxes)
        out[:, 0::2] = (y0 + boxes[:, 0::2] * th) / h
        out[:, 1::2] = (x0 + boxes[:, 1::2] * tw) / w
        return np.clip(out, 0.0, 1.0)


def merge_nms(boxes: torch.Tensor, scores: torch.Tensor,
              labels: torch.Tensor, iou_threshold: float, max_boxes: int,
              metric: str = "ios"):
    """Global class-wise greedy NMS over each image's flat candidate set
    (the JAX package's jitted ``_merge_nms``), on the candidates' device.

    ``boxes (..., K, 4)`` in [0, 1], ``scores (..., K)`` (invalid slots
    <= 0), ``labels (..., K)`` int; ``metric``: ``"ios"`` (the tiled
    merge's) or ``"iou"``. Returns ``(boxes (..., max_boxes, 4), scores,
    labels int32, count int32)``, zero past ``count`` (labels -1).
    """
    boxes, scores, labels = sort_candidates(
        boxes.float(), scores.float(), labels.to(torch.int32))
    valid = scores > 0.0
    keep = greedy_suppression_mask(offset_boxes(boxes, labels, valid), valid,
                                   iou_threshold, metric=metric)
    kept = torch.where(keep, scores, scores.new_full((), -1.0))
    top_scores, top_idx = topk_stable(kept, min(max_boxes, kept.shape[-1]))
    fv = top_scores > 0.0
    out_boxes = torch.gather(boxes, -2, top_idx[..., None].expand(
        *top_idx.shape, 4)) * fv[..., None]
    out_scores = torch.where(fv, top_scores, top_scores.new_zeros(()))
    out_labels = torch.where(fv, torch.gather(labels, -1, top_idx),
                             labels.new_full((), -1))
    out_boxes, out_scores, out_labels = pad_detections(
        out_boxes, out_scores, out_labels, max_boxes)
    return out_boxes, out_scores, out_labels, fv.sum(dim=-1,
                                                     dtype=torch.int32)


class TiledPredictor:
    """``predict(image) -> {boxes, scores, labels, num_boxes}`` (image-
    normalized global coordinates) for one image far above the model
    resolution.

    ``predictor``: a ``Predictor`` (its config fixes the tile size, the
    model resolution, and the NMS threshold; the merge runs on its
    device). ``overlap``: fractional overlap of neighbouring tiles.
    ``full_image_pass``: also run the whole image resized to the model
    resolution, so that objects larger than a tile survive.
    ``max_boxes``: the output size (default the config's).
    ``merge_metric``: ``"ios"`` or ``"iou"``. ``edge_penalty``: the score
    factor of detections touching an interior tile border (0 drops them).
    """

    def __init__(self, predictor, overlap: float = 0.25,
                 full_image_pass: bool = True, max_boxes: int | None = None,
                 merge_metric: str = "ios", edge_penalty: float = 0.5):
        if not 0.0 <= overlap < 1.0:
            raise ValueError(f"overlap must be in [0, 1), got {overlap}")
        if merge_metric not in ("ios", "iou"):
            raise ValueError(
                f"merge_metric must be ios|iou, got {merge_metric}")
        if not 0.0 <= edge_penalty <= 1.0:
            raise ValueError(
                f"edge_penalty must be in [0, 1], got {edge_penalty}")
        self.predictor = predictor
        self.cfg = predictor.cfg
        self.device = predictor.device
        self.overlap = overlap
        self.full_image_pass = full_image_pass
        self.max_boxes = int(max_boxes or self.cfg.nms.max_boxes)
        self.merge_metric = merge_metric
        self.edge_penalty = edge_penalty
        self.label_map = getattr(predictor, "label_map", None)

    def grid_for(self, image_hw) -> TileGrid:
        return TileGrid.build(image_hw, self.cfg.image_hw(), self.overlap)

    def candidates(self, image: np.ndarray):
        """One batched predict of the tiles (and the full pass) -> the flat
        candidates in image coordinates, ``(boxes (K, 4), scores (K,),
        labels (K,))`` numpy, edge-touching scores down-weighted."""
        image = np.asarray(image)
        if image.ndim != 3:
            raise ValueError("TiledPredictor takes one (H, W, 3) image; "
                             "tiles are the batch axis")
        grid = self.grid_for(image.shape[:2])
        passes = list(grid.crops(image))
        t = len(passes)
        if self.full_image_pass and t > 1:
            passes.append(image)  # the predictor resizes the full frame
        out = self.predictor.predict(passes)
        boxes, scores = [], []
        for i in range(t):
            tile_boxes = np.asarray(out["boxes"][i])
            tile_scores = np.asarray(out["scores"][i], np.float32).copy()
            if self.edge_penalty < 1.0:
                clipped = grid.interior_edge_mask(i, tile_boxes)
                tile_scores[clipped] *= self.edge_penalty
            boxes.append(grid.to_global(i, tile_boxes))
            scores.append(tile_scores)
        if len(passes) > t:  # the full pass: already image coordinates
            boxes.append(np.asarray(out["boxes"][t]))
            scores.append(np.asarray(out["scores"][t], np.float32))
        labels = np.concatenate([out["labels"][i] for i in range(len(passes))])
        return (np.concatenate(boxes, axis=0), np.concatenate(scores),
                labels.astype(np.int32))

    def merge(self, boxes: np.ndarray, scores: np.ndarray,
              labels: np.ndarray, device=None) -> dict:
        """``merge_nms`` of the candidates on ``device`` (default the
        predictor's) -> numpy results. Per-tile outputs are zero-padded past
        their ``num_boxes``; those slots stay invalid (score <= 0)."""
        dev = self.device if device is None else device
        b, s, l, n = merge_nms(
            torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev),
            torch.from_numpy(labels).to(dev), self.cfg.nms.iou_threshold,
            self.max_boxes, metric=self.merge_metric)
        result = {"boxes": b.cpu().numpy(), "scores": s.cpu().numpy(),
                  "labels": l.cpu().numpy(), "num_boxes": int(n)}
        if self.label_map is not None:
            result["names"] = np.array([
                self.label_map.get(int(x), str(int(x)))
                for x in result["labels"]])
        return result

    def predict(self, image) -> dict:
        return self.merge(*self.candidates(image))
