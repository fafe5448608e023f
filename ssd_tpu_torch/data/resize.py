"""Bilinear uint8 RGB resize (numpy), the port's copy of the native loader's
``resize_bilinear`` (``native/loader.cc``).

Half-pixel source coordinates, edge-clamped neighbours, float32 arithmetic in
the same order, and the ``+0.5`` truncating round. The C++ build may
contract ``a * b + c`` into an FMA, so the two can differ by one unit in the
last place of a pixel.
"""

from __future__ import annotations

import numpy as np


def _axis(src: int, dst: int):
    """Source rows (or columns) and weights for one axis, float32."""
    scale = np.float32(src) / np.float32(dst)
    f = (np.arange(dst, dtype=np.float32) + np.float32(0.5)) * scale \
        - np.float32(0.5)
    i0 = np.maximum(f.astype(np.int32), 0)  # truncation toward zero
    i1 = np.minimum(i0 + 1, src - 1)
    wt = np.maximum(f - i0.astype(np.float32), np.float32(0.0))
    return i0, i1, wt


def resize(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(H, W, 3) uint8 -> (out_h, out_w, 3) uint8, bilinear."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"resize expects (H, W, 3) uint8, got "
                         f"{image.shape} {image.dtype}")
    sh, sw = image.shape[:2]
    if (sh, sw) == (out_h, out_w):
        return image
    y0, y1, wy = _axis(sh, out_h)
    x0, x1, wx = _axis(sw, out_w)
    src = image.astype(np.float32)
    wx = wx[None, :, None]
    one = np.float32(1.0)
    top = src[y0][:, x0] * (one - wx) + src[y0][:, x1] * wx
    bot = src[y1][:, x0] * (one - wx) + src[y1][:, x1] * wx
    wy = wy[:, None, None]
    out = top * (one - wy) + bot * wy + np.float32(0.5)
    return out.astype(np.uint8)
