"""The one general generator of the benchmark's inputs, driven by the
parameters of a traffic file (``bench_port/traffic/<mix>.json``).

Scenes follow ``ssd_tpu_torch/data/synthetic.coco_scene`` (copied here, so
that the yardstick does not move with the program): a noise background
(values below ``background_max``) with filled rectangles of the class's
colour and a darker border. The background is drawn on the device from a
generator seeded with ``(seed, batch index)`` in one call a batch, then
copied to the host, where the rectangles are painted; their count, sides,
places and classes come from numpy's generator seeded the same way.

Object counts are COCO-like: ``ceil`` of a log-normal clipped to
``[min_objects, max_objects]`` (by default mean about 7, COCO train2017's
7.3 a image); sides are log-uniform in ``sides`` pixels.
"""

from __future__ import annotations

import colorsys

import numpy as np
import torch


def palette(num_classes: int) -> np.ndarray:
    cols = []
    half = num_classes // 2 or 1
    for i in range(num_classes):
        v = 1.0 if i < num_classes // 2 else 0.55
        r, g, b = colorsys.hsv_to_rgb((i % half) / half, 1.0, v)
        cols.append([int(r * 255), int(g * 255), int(b * 255)])
    return np.asarray(cols, np.uint8)


def _seed_words(seed: int, index: int) -> list[int]:
    return [int(seed) & 0xFFFFFFFF, int(seed) >> 32, int(index) & 0xFFFFFFFF]


def object_counts(rng: np.random.Generator, n: int, p: dict) -> np.ndarray:
    lo, hi = p.get("min_objects", 1), p.get("max_objects", 100)
    draw = rng.lognormal(p.get("objects_mu", 1.55),
                         p.get("objects_sigma", 0.85), n)
    return np.clip(np.ceil(draw), lo, hi).astype(np.int32)


def scene_batch(seed: int, index: int, n: int, hw: tuple, num_classes: int,
                p: dict, device: torch.device) -> dict:
    """Batch ``index`` of ``n`` scenes of size ``hw``: ``images (n, H, W,
    3) uint8``, ``boxes (n, max_gt, 4) f32`` normalized ``(ymin, xmin, ymax,
    xmax)``, zero-padded, ``labels (n, max_gt) int32``, ``num_boxes (n,)
    int32``."""
    h, w = hw
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(index)) % (2 ** 63))
    images = torch.randint(0, p.get("background_max", 60), (n, h, w, 3),
                           generator=gen, device=device,
                           dtype=torch.uint8).cpu().numpy()
    rng = np.random.default_rng(_seed_words(seed, index))
    counts = object_counts(rng, n, p)
    max_gt = p.get("max_objects", 100)
    boxes = np.zeros((n, max_gt, 4), np.float32)
    labels = np.zeros((n, max_gt), np.int32)
    pal = palette(num_classes)
    s_lo, s_hi = p.get("sides", (8, 320))
    for j, k in enumerate(counts):
        side = np.exp(rng.uniform(np.log(s_lo), np.log(s_hi), (k, 2)))
        bh = np.minimum(side[:, 0].astype(int), h - 1)
        bw = np.minimum(side[:, 1].astype(int), w - 1)
        ys = (rng.random(k) * (h - bh)).astype(int)
        xs = (rng.random(k) * (w - bw)).astype(int)
        cs = rng.integers(0, num_classes, k)
        img = images[j]
        for y, x, bh_, bw_, c in zip(ys, xs, bh, bw, cs):
            img[y:y + bh_, x:x + bw_] = pal[c]
            img[y, x:x + bw_] = img[y + bh_ - 1, x:x + bw_] = pal[c] // 2
            img[y:y + bh_, x] = img[y:y + bh_, x + bw_ - 1] = pal[c] // 2
        boxes[j, :k] = np.stack([ys / h, xs / w, (ys + bh) / h,
                                 (xs + bw) / w], 1)
        labels[j, :k] = cs
    return {"images": images, "boxes": boxes, "labels": labels,
            "num_boxes": counts}
