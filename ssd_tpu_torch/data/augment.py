"""SSD-style train-time augmentations, on the host in numpy.

The port's own copy of the JAX package's ``ssd_tpu/data/augment.py``,
expression for expression: the same ``np.random.Generator`` draws in the
same order, the colour jitter's float32 arithmetic, the ``@`` hue rotation
and the truncating ``astype(np.uint8)``, so that one seed gives the same
bytes in both packages. They run in the input pipeline's worker threads.

Crop semantics (standard SSD, Liu et al. 2016):
  * choose one of {keep whole image} U {min-IoU in 0.1..0.9} U {free crop};
  * sample a crop with area in [0.3, 1] and aspect in [0.5, 2] until the
    min-IoU constraint vs ground-truth holds (bounded retries);
  * keep boxes whose CENTERS fall inside the crop; clip them to it and
    renormalize to the new window.
"""

from __future__ import annotations

import numpy as np

from ssd_tpu_torch.data import native


def boxes_iou_numpy(b1: np.ndarray, b2: np.ndarray) -> np.ndarray:
    y0 = np.maximum(b1[:, None, 0], b2[None, :, 0])
    x0 = np.maximum(b1[:, None, 1], b2[None, :, 1])
    y1 = np.minimum(b1[:, None, 2], b2[None, :, 2])
    x1 = np.minimum(b1[:, None, 3], b2[None, :, 3])
    inter = np.clip(y1 - y0, 0, None) * np.clip(x1 - x0, 0, None)
    a1 = (b1[:, 2] - b1[:, 0]) * (b1[:, 3] - b1[:, 1])
    a2 = (b2[:, 2] - b2[:, 0]) * (b2[:, 3] - b2[:, 1])
    return inter / np.maximum(a1[:, None] + a2[None, :] - inter, 1e-8)


def random_crop_with_boxes(
    image: np.ndarray,           # (H, W, 3) uint8
    boxes: np.ndarray,           # (M, 4) normalized
    labels: np.ndarray,          # (M,)
    rng: np.random.Generator,
    min_ious=(0.1, 0.3, 0.5, 0.7, 0.9),
    max_attempts: int = 20,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (cropped image, remapped boxes, kept labels)."""
    h, w = image.shape[:2]
    # mode: None = keep whole image; -1 = unconstrained crop; else min-IoU
    modes = [None, -1.0] + list(min_ious)
    mode = modes[rng.integers(len(modes))]
    if mode is None or len(boxes) == 0:
        return image, boxes, labels

    for _ in range(max_attempts):
        scale = rng.uniform(0.3, 1.0)
        ratio = rng.uniform(max(0.5, scale * scale),
                            min(2.0, 1.0 / (scale * scale)))
        ch = int(h * scale / np.sqrt(ratio))
        cw = int(w * scale * np.sqrt(ratio))
        ch, cw = min(ch, h), min(cw, w)
        if ch < 1 or cw < 1:
            continue
        cy = rng.integers(0, h - ch + 1)
        cx = rng.integers(0, w - cw + 1)
        window = np.array(
            [cy / h, cx / w, (cy + ch) / h, (cx + cw) / w], np.float32
        )
        if mode >= 0:
            ious = boxes_iou_numpy(boxes, window[None])[:, 0]
            if ious.max(initial=0.0) < mode:
                continue
        centers_y = (boxes[:, 0] + boxes[:, 2]) / 2
        centers_x = (boxes[:, 1] + boxes[:, 3]) / 2
        keep = (
            (centers_y >= window[0]) & (centers_y <= window[2])
            & (centers_x >= window[1]) & (centers_x <= window[3])
        )
        if not keep.any():
            continue
        new_boxes = boxes[keep].copy()
        # clip to window, renormalize to crop coords
        new_boxes[:, [0, 2]] = np.clip(new_boxes[:, [0, 2]], window[0],
                                       window[2])
        new_boxes[:, [1, 3]] = np.clip(new_boxes[:, [1, 3]], window[1],
                                       window[3])
        wh = window[2] - window[0]
        ww = window[3] - window[1]
        new_boxes[:, [0, 2]] = (new_boxes[:, [0, 2]] - window[0]) / wh
        new_boxes[:, [1, 3]] = (new_boxes[:, [1, 3]] - window[1]) / ww
        return image[cy:cy + ch, cx:cx + cw], new_boxes, labels[keep]

    return image, boxes, labels


def random_flip(image, boxes, rng, probability=0.5):
    if rng.uniform() < probability:
        image = image[:, ::-1]
        if len(boxes):
            boxes = boxes.copy()
            boxes[:, [1, 3]] = 1.0 - boxes[:, [3, 1]]
    return image, boxes


def _hue_rotation_matrix(radians: float) -> np.ndarray:
    """3x3 RGB hue-rotation matrix (rotation about the gray axis)."""
    cos, sin = np.cos(radians), np.sin(radians)
    one_third = 1.0 / 3.0
    sqrt3 = np.sqrt(3.0)
    m = np.full((3, 3), one_third * (1.0 - cos), np.float32)
    m += np.eye(3, dtype=np.float32) * cos
    off = np.array([[0, -1, 1], [1, 0, -1], [-1, 1, 0]], np.float32)
    m += off * (sin / sqrt3)
    return m


def random_color(image: np.ndarray, rng: np.random.Generator,
                 probability: float = 0.5) -> np.ndarray:
    """Brightness/contrast/saturation/hue jitter (uint8 in/out)."""
    if rng.uniform() >= probability:
        return image
    img = image.astype(np.float32)
    # brightness
    img += rng.uniform(-32, 32)
    # contrast
    img = (img - 128.0) * rng.uniform(0.7, 1.3) + 128.0
    # saturation: lerp towards grayscale
    gray = img.mean(axis=-1, keepdims=True)
    img = gray + (img - gray) * rng.uniform(0.7, 1.3)
    # hue: small rotation about the gray axis (cheap HSV-free approximation)
    if rng.uniform() < 0.5:
        img = img @ _hue_rotation_matrix(rng.uniform(-0.2, 0.2)).T
    return np.clip(img, 0, 255).astype(np.uint8)


def augment_example(image, boxes, labels, rng, cfg) -> tuple:
    """Full SSD train-time augmentation chain (cfg: DataConfig)."""
    if rng.uniform() < cfg.crop_probability:
        image, boxes, labels = random_crop_with_boxes(
            image, boxes, labels, rng, cfg.crop_min_ious
        )
    image, boxes = random_flip(image, boxes, rng, cfg.flip_probability)
    image = random_color(image, rng, cfg.color_jitter_probability)
    return image, boxes, labels


def mosaic_example(images, boxes_list, labels_list, rng,
                   out_hw: tuple[int, int]) -> tuple:
    """4-image mosaic composite (YOLOv4-style, simplified).

    Four images are stretched into the quadrants of a ``(2*H, 2*W)``
    canvas split at a jittered center (by the host library's bilinear
    resize), their boxes remapped into canvas coordinates. The composite
    then flows through the crop/flip/color chain and the final resize.

    Args:
      images: list of 4 uint8 ``(h_i, w_i, 3)`` images (any sizes).
      boxes_list / labels_list: per-image normalized boxes + labels.
      out_hw: the model resolution ``(H, W)`` — canvas is ``(2H, 2W)``.

    Returns:
      (canvas uint8 (2H, 2W, 3), boxes (K, 4) normalized, labels (K,)).
    """
    assert len(images) == 4
    ch, cw = 2 * out_hw[0], 2 * out_hw[1]
    # split point jittered around the middle: every quadrant keeps a
    # meaningful share of the canvas
    cy = int(ch * rng.uniform(0.35, 0.65))
    cx = int(cw * rng.uniform(0.35, 0.65))
    rects = [(0, 0, cy, cx), (0, cx, cy, cw),
             (cy, 0, ch, cx), (cy, cx, ch, cw)]
    canvas = np.zeros((ch, cw, 3), np.uint8)
    out_boxes, out_labels = [], []
    for (y0, x0, y1, x1), img, bxs, lbs in zip(
            rects, images, boxes_list, labels_list):
        h, w = y1 - y0, x1 - x0
        canvas[y0:y1, x0:x1] = native.resize(np.ascontiguousarray(img), h, w)
        if len(bxs):
            b = np.asarray(bxs, np.float32).copy()
            b[:, 0::2] = (y0 + b[:, 0::2] * h) / ch
            b[:, 1::2] = (x0 + b[:, 1::2] * w) / cw
            out_boxes.append(b)
            out_labels.append(np.asarray(lbs))
    if out_boxes:
        boxes = np.concatenate(out_boxes, axis=0)
        labels = np.concatenate(out_labels, axis=0)
    else:
        boxes = np.zeros((0, 4), np.float32)
        labels = np.zeros((0,), np.int64)
    return canvas, boxes, labels
