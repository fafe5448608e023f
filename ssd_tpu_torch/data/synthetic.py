"""Seed-derived synthetic detection scenes, and resumable batch streams.

The port's own copy of the JAX package's scene generators, which need no
dataset: ``_palette`` and ``crowded_example`` from
``ssd_tpu/tools/crowded_validation.py`` (here returning the raw uint8
image, without the JPEG round trip) and ``sanity_scene``/``sanity_batches``
from ``ssd_tpu/eval/sanity.py``. For the same ``numpy`` generator they draw
the same numbers in the same order, so the scenes, boxes and labels are
bit-identical to the JAX package's.

``write_coco_scenes`` writes a small COCO-style dataset (JPEG files and
an instances JSON) of seeded scenes of mixed sizes, for
``data/create_tfrecords.py`` to turn into shards.

``SceneBatches`` yields batches in the input pipeline's contract
(``ssd_tpu/data/pipeline.py``): ``images (B, H, W, 3) uint8``, ``boxes (B,
M, 4) float32`` zero-padded, ``labels (B, M) int32`` and ``num_boxes (B,)
int32``. Batch ``i`` is a pure function of ``i``, and ``state()`` /
``restore()`` carry the position, so a resumed run sees the batches the
interrupted one would have.
"""

from __future__ import annotations

import colorsys
import json
import os
from typing import Callable

import numpy as np

SANITY_SEED_TRAIN = 7
SANITY_CLASSES = 8
SANITY_SIZE = 128

CROWDED_SIZE = 256
CROWDED_CLASSES = 40


def _palette(num_classes: int) -> np.ndarray:
    """Distinct class colours: a hue wheel at two brightness tiers."""
    cols = []
    for i in range(num_classes):
        h = (i % (num_classes // 2 or 1)) / (num_classes // 2 or 1)
        v = 1.0 if i < num_classes // 2 else 0.55
        r, g, b = colorsys.hsv_to_rgb(h, 1.0, v)
        cols.append([int(r * 255), int(g * 255), int(b * 255)])
    return np.asarray(cols, np.uint8)


def _draw_boxes(rng: np.random.Generator, img: np.ndarray, n: int,
                num_classes: int, lo: int, hi: int):
    """Draws ``n`` filled rectangles of side ``[lo, hi)`` px with a darker
    1 px border (so neighbours of one class stay apart) onto ``img``."""
    size = img.shape[0]
    palette = _palette(num_classes)
    boxes, labels = [], []
    for _ in range(n):
        h = int(rng.integers(lo, hi))
        w = int(rng.integers(lo, hi))
        y = int(rng.integers(0, size - h))
        x = int(rng.integers(0, size - w))
        c = int(rng.integers(0, num_classes))
        img[y:y + h, x:x + w] = palette[c]
        img[y, x:x + w] = palette[c] // 2
        img[y + h - 1, x:x + w] = palette[c] // 2
        img[y:y + h, x] = palette[c] // 2
        img[y:y + h, x + w - 1] = palette[c] // 2
        boxes.append([y / size, x / size, (y + h) / size, (x + w) / size])
        labels.append(c)
    return np.asarray(boxes, np.float32), labels


def crowded_example(rng: np.random.Generator,
                    num_classes: int = CROWDED_CLASSES,
                    size: int = CROWDED_SIZE, min_boxes: int = 30,
                    max_boxes: int = 80):
    """One dense scene of 8-48 px objects: ``(image (size, size, 3) uint8,
    boxes (n, 4) f32, labels (n,) int64)``."""
    img = rng.integers(0, 40, (size, size, 3)).astype(np.uint8)
    n = int(rng.integers(min_boxes, max_boxes + 1))
    boxes, labels = _draw_boxes(rng, img, n, num_classes, 8, 49)
    return img, boxes, np.asarray(labels, np.int64)


def sanity_scene(rng: np.random.Generator):
    """One scene at the sanity shape (128 px, 8 classes, 8-24 objects of
    10-48 px): ``(image, boxes (n, 4) f32, labels (n,) int32)``."""
    img = rng.integers(0, 40, (SANITY_SIZE, SANITY_SIZE, 3)).astype(np.uint8)
    n = int(rng.integers(8, 25))
    boxes, labels = _draw_boxes(rng, img, n, SANITY_CLASSES, 10, 49)
    return img, boxes, np.asarray(labels, np.int32)


def pad_batch(scenes: list, max_gt: int) -> dict:
    """Scenes ``[(image, boxes, labels), ...]`` -> one padded batch."""
    if max(len(s[2]) for s in scenes) > max_gt:
        raise ValueError(f"a scene has more than max_gt={max_gt} boxes")
    b = len(scenes)
    boxes = np.zeros((b, max_gt, 4), np.float32)
    labels = np.zeros((b, max_gt), np.int32)
    num = np.zeros((b,), np.int32)
    for j, (_, bx, lb) in enumerate(scenes):
        boxes[j, :len(lb)] = bx
        labels[j, :len(lb)] = lb
        num[j] = len(lb)
    return {"images": np.stack([s[0] for s in scenes]), "boxes": boxes,
            "labels": labels, "num_boxes": num}


def sanity_batches(n_images: int, seed: int, batch: int = 8,
                   max_gt: int = 32):
    """Deterministic padded batches ``(images, boxes, labels, num_boxes,
    valid)``; the last batch repeats its final scene to fill ``batch`` and
    ``valid`` marks the real rows."""
    rng = np.random.default_rng(seed)
    scenes = [sanity_scene(rng) for _ in range(n_images)]
    for i in range(0, n_images, batch):
        chunk = scenes[i:i + batch]
        while len(chunk) < batch:
            chunk.append(chunk[-1])
        b = pad_batch(chunk, max_gt)
        valid = np.arange(i, i + batch) < n_images
        yield b["images"], b["boxes"], b["labels"], b["num_boxes"], valid


def sanity_train_batch(index: int, batch: int = 16, max_gt: int = 32) -> dict:
    """Training batch ``index`` of the sanity task: the first batch of
    ``sanity_batches(batch, SANITY_SEED_TRAIN + index, batch, max_gt)``."""
    images, boxes, labels, num, _ = next(sanity_batches(
        batch, SANITY_SEED_TRAIN + index, batch, max_gt))
    return {"images": images, "boxes": boxes, "labels": labels,
            "num_boxes": num}


def crowded_batch(index: int, seed: int, batch: int, size: int,
                  num_classes: int, max_gt: int) -> dict:
    """Batch ``index`` of crowded scenes, drawn from the generator seeded
    with ``(seed, index)``."""
    rng = np.random.default_rng([seed, index])
    return pad_batch([crowded_example(rng, num_classes, size)
                      for _ in range(batch)], max_gt)


class SceneBatches:
    """An endless, resumable stream: batch ``i`` is ``make_batch(i)``."""

    def __init__(self, make_batch: Callable[[int], dict]):
        self.make_batch = make_batch
        self.position = 0

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = self.make_batch(self.position)
        self.position += 1
        return batch

    def state(self) -> dict:
        return {"position": self.position}

    def restore(self, state: dict) -> None:
        self.position = int(state["position"])


CROWD_SHARE = 0.05  # of a written scene's annotations, marked iscrowd
JPEG_QUALITY = 90


def coco_scene(rng: np.random.Generator, hw: tuple[int, int],
               num_classes: int, objects: tuple[int, int],
               sides: tuple[int, int]):
    """One ``hw`` scene of ``objects`` (a range) filled rectangles whose
    sides lie in ``sides`` px (clipped to the image), a darker border
    each: ``(image uint8, annotations)`` with COCO's ``bbox [x, y, w, h]``
    in pixels, a 0-based ``category_id`` and ``iscrowd`` set on about
    ``CROWD_SHARE`` of them."""
    h_img, w_img = hw
    img = rng.integers(0, 60, (h_img, w_img, 3)).astype(np.uint8)
    palette = _palette(num_classes)
    anns = []
    for _ in range(int(rng.integers(objects[0], objects[1] + 1))):
        h = min(int(rng.integers(sides[0], sides[1])), h_img - 1)
        w = min(int(rng.integers(sides[0], sides[1])), w_img - 1)
        y = int(rng.integers(0, h_img - h))
        x = int(rng.integers(0, w_img - w))
        c = int(rng.integers(0, num_classes))
        img[y:y + h, x:x + w] = palette[c]
        img[y, x:x + w] = img[y + h - 1, x:x + w] = palette[c] // 2
        img[y:y + h, x] = img[y:y + h, x + w - 1] = palette[c] // 2
        anns.append({"bbox": [x, y, w, h], "category_id": c,
                     "iscrowd": int(rng.random() < CROWD_SHARE)})
    return img, anns


def write_coco_scenes(image_dir: str, json_path: str, n: int, sizes: list,
                      num_classes: int, seed: int,
                      objects: tuple[int, int] = (4, 24),
                      sides: tuple[int, int] = (8, 64)) -> list[str]:
    """Writes ``n`` scenes (sizes ``(h, w)`` in turn from ``sizes``) as
    PIL JPEGs at ``JPEG_QUALITY`` into ``image_dir`` and their COCO instances
    JSON (categories ``1..num_classes``, named ``class_<i>``) to
    ``json_path``; returns the file names. Scene ``i`` is drawn from the
    generator seeded with ``(seed, i)``; the JPEG bytes are the local
    encoder's."""
    from PIL import Image

    os.makedirs(image_dir, exist_ok=True)
    images, annotations, names = [], [], []
    for i in range(n):
        hw = tuple(sizes[i % len(sizes)])
        img, anns = coco_scene(np.random.default_rng([seed, i]), hw,
                               num_classes, objects, sides)
        name = f"{i:06d}.jpg"
        Image.fromarray(img).save(os.path.join(image_dir, name),
                                  quality=JPEG_QUALITY)
        images.append({"id": 1000 + i, "file_name": name, "height": hw[0],
                       "width": hw[1]})
        for a in anns:
            annotations.append({**a, "id": len(annotations) + 1,
                                "image_id": 1000 + i,
                                "category_id": a["category_id"] + 1})
        names.append(name)
    with open(json_path, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": c + 1, "name": f"class_{c}"}
                                  for c in range(num_classes)]}, f)
    return names
