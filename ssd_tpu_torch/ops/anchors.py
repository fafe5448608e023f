"""RetinaNet-style dense anchor generation (numpy).

Anchors are a pure function of ``(image_size, AnchorConfig)``. Per FPN level
``l`` with stride ``2**l``: at every cell, anchors of base size
``anchor_scale * stride`` at ``scales_per_octave`` octave scales times each
aspect ratio. Order is (level, row, col, scale*aspect), the order in which
the head's per-cell channels are read. Feature sizes use ceil division.
"""

from __future__ import annotations

import numpy as np

from ssd_tpu_torch.config import AnchorConfig


def _hw(image_size) -> tuple[int, int]:
    if isinstance(image_size, (int, np.integer)):
        return (int(image_size), int(image_size))
    h, w = image_size
    return (int(h), int(w))


def _level_anchors(feat_h: int, feat_w: int, stride: int,
                   image_hw: tuple[int, int],
                   cfg: AnchorConfig) -> np.ndarray:
    """Anchors for one level: ``(feat_h * feat_w * K, 4)`` normalized."""
    scales = [2 ** (k / cfg.scales_per_octave)
              for k in range(cfg.scales_per_octave)]
    base = cfg.anchor_scale * stride

    # (K, 2) anchor (h, w) in pixels; order: scale-major, aspect-minor.
    sizes = []
    for s in scales:
        for ar in cfg.aspect_ratios:
            a = base * s
            sizes.append((a / np.sqrt(ar), a * np.sqrt(ar)))
    sizes = np.asarray(sizes, dtype=np.float32)

    cy = (np.arange(feat_h, dtype=np.float32) + 0.5) * stride
    cx = (np.arange(feat_w, dtype=np.float32) + 0.5) * stride
    cy, cx = np.meshgrid(cy, cx, indexing="ij")

    centers = np.stack([cy, cx], axis=-1)[:, :, None, :]  # (H, W, 1, 2)
    half = 0.5 * sizes[None, None, :, :]                  # (1, 1, K, 2)
    boxes = np.concatenate([centers - half, centers + half],
                           axis=-1).reshape(-1, 4)
    ih, iw = image_hw
    return boxes / np.asarray([ih, iw, ih, iw], np.float32)


def generate_anchors(image_size, cfg: AnchorConfig) -> np.ndarray:
    """All anchors for all FPN levels, concatenated: ``(A, 4)`` float32.

    Anchors at image borders extend outside ``[0, 1]``; predictions are
    clipped after decode instead.
    """
    ih, iw = _hw(image_size)
    out = []
    for level in range(cfg.min_level, cfg.max_level + 1):
        stride = 2 ** level
        fh, fw = -(-ih // stride), -(-iw // stride)
        out.append(_level_anchors(fh, fw, stride, (ih, iw), cfg))
    return np.concatenate(out, axis=0)


def anchor_counts_per_level(image_size, cfg: AnchorConfig) -> tuple[int, ...]:
    """Number of anchors each level contributes, in the order of
    ``generate_anchors``."""
    ih, iw = _hw(image_size)
    counts = []
    for level in range(cfg.min_level, cfg.max_level + 1):
        stride = 2 ** level
        fh, fw = -(-ih // stride), -(-iw // stride)
        counts.append(fh * fw * cfg.num_anchors_per_cell)
    return tuple(counts)
