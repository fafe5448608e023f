"""Space-to-depth packing of the input feed (numpy, host side).

The dense4 stem consumes the image as a space-to-depth(4)-packed,
-128-shifted s8 tensor ``(N, H/4, W/4, 48)``. Packing on the host is a pure
relabeling plus the exact ``u8 ^ 0x80 == u8 - 128`` shift, so the model sees
the same values as when it packs the raw uint8 image itself.
"""

from __future__ import annotations

import numpy as np

PACK_BLOCK = 4
PACK_CHANNELS = 48  # 4 * 4 * RGB


def packed_shape(image_hw, batch: int | None = None):
    """Packed shape for a raw ``(H, W)`` image size."""
    h, w = image_hw
    s = (h // PACK_BLOCK, w // PACK_BLOCK, PACK_CHANNELS)
    return s if batch is None else (batch, *s)


def pack_s2d(images_uint8: np.ndarray) -> np.ndarray:
    """(N, H, W, 3) uint8 -> (N, H/4, W/4, 48) int8, shifted by -128.

    Channel ``(4*dy + dx)*3 + c`` holds pixel ``(dy, dx)`` channel ``c`` of
    each 4x4 block, the layout the stem's own packing produces
    (``models/mobilenet.s2d_pack``).
    """
    x = np.ascontiguousarray(images_uint8)
    n, h, w, c = x.shape
    if x.dtype != np.uint8 or c != 3 or h % PACK_BLOCK or w % PACK_BLOCK:
        raise ValueError(
            f"pack_s2d expects (N, 4k, 4k, 3) uint8, got {x.shape} {x.dtype}")
    x = x.reshape(n, h // 4, 4, w // 4, 4, 3).transpose(0, 1, 3, 2, 4, 5)
    x = x.reshape(n, h // 4, w // 4, PACK_CHANNELS)
    return (x ^ np.uint8(0x80)).view(np.int8)


def unpack_s2d(packed_int8: np.ndarray) -> np.ndarray:
    """(N, H/4, W/4, 48) int8 -> (N, H, W, 3) uint8 (exact inverse)."""
    x = np.ascontiguousarray(packed_int8).view(np.uint8) ^ np.uint8(0x80)
    n, ph, pw, _ = x.shape
    x = x.reshape(n, ph, pw, 4, 4, 3).transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(n, ph * 4, pw * 4, 3)
