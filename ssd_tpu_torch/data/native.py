"""ctypes bindings for the port's host ingest library (``csrc/loader.cc``),
the counterpart of the JAX package's ``ssd_tpu/data/native.py``: JPEG
decode, resize, the dense4 pack, crc32c and the tfrecord shard index.

The library is built with the host compiler at first use (``_build.
load_host``), not at import. Resize and pack have no fallback: if the
library does not build, they raise (the numpy versions, ``data/resize.py``
and ``ops/ingest.py``, are the plain versions the tests hold these to).
Decoding goes as in the JAX package: the native libjpeg path, then PIL
where it is installed, then a ``RuntimeError`` naming the missing decoder.
Unlike the JAX package's PIL fallback (a full decode and PIL's own
bilinear filter), the port's takes the native path's steps, libjpeg's
DCT-domain scale and this library's resize, so both give the same pixels.

ctypes releases the GIL for the length of each foreign call, so decodes and
packs in several threads run in parallel, as do the threads of the batch
decoder and the pack.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ssd_tpu_torch import _build

LIBRARY = "loader"

_lib = None
_lock = threading.Lock()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.ssd_jpeg_available.argtypes = []
    lib.ssd_jpeg_available.restype = ctypes.c_int
    lib.ssd_jpeg_lib_version.argtypes = [ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_int)]
    lib.ssd_jpeg_lib_version.restype = ctypes.c_int
    lib.ssd_resize.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.ssd_resize.restype = ctypes.c_int
    lib.ssd_pack_s2d.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int]
    lib.ssd_pack_s2d.restype = ctypes.c_int
    lib.ssd_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.ssd_crc32c.restype = ctypes.c_uint32
    lib.ssd_tfrecord_index.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64)]
    lib.ssd_tfrecord_index.restype = ctypes.c_int64
    if lib.ssd_jpeg_available():
        lib.ssd_decode_jpeg.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int]
        lib.ssd_decode_jpeg.restype = ctypes.c_int
        lib.ssd_jpeg_dims.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.ssd_jpeg_dims.restype = ctypes.c_int
        lib.ssd_decode_batch.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.ssd_decode_batch.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The host library, built and bound at the first call; raises if it
    does not build."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(_build.load_host(LIBRARY))
        return _lib


def jpeg_available() -> bool:
    """Whether the library was built with its libjpeg half."""
    return bool(library().ssd_jpeg_available())


def jpeg_version() -> dict:
    """libjpeg's API version and libjpeg-turbo's version number as the
    library was compiled against them (0 where absent)."""
    api, turbo = ctypes.c_int(), ctypes.c_int()
    library().ssd_jpeg_lib_version(ctypes.byref(api), ctypes.byref(turbo))
    return {"jpeg_lib_version": api.value,
            "libjpeg_turbo_version_number": turbo.value}


def pil_available() -> bool:
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def _no_decoder() -> RuntimeError:
    return RuntimeError(
        "no JPEG decoder: the host library was built without libjpeg "
        "(jpeglib.h or -ljpeg not found) and PIL is not installed")


def _check_bytes(data) -> bytes:
    if not isinstance(data, (bytes, bytearray)):
        raise TypeError(f"expected JPEG bytes, got {type(data).__name__}")
    if not data:
        raise ValueError("empty image data")
    return bytes(data)


def jpeg_dims(data: bytes) -> tuple[int, int]:
    """A JPEG's ``(height, width)`` from its header."""
    data = _check_bytes(data)
    if jpeg_available():
        h, w = ctypes.c_int(), ctypes.c_int()
        if library().ssd_jpeg_dims(data, len(data), ctypes.byref(h),
                                   ctypes.byref(w)) == 0:
            return h.value, w.value
    if not pil_available():
        if jpeg_available():
            raise ValueError("not a JPEG libjpeg can read (PIL, which reads "
                             "other formats, is not installed)")
        raise _no_decoder()
    from io import BytesIO
    from PIL import Image
    im = Image.open(BytesIO(data))
    return im.height, im.width


def _decode_pil(data: bytes, out_h: int, out_w: int) -> np.ndarray:
    """PIL's decode in the native path's steps: for a JPEG, libjpeg's
    DCT-domain scale chosen by the same rule (``draft``: the largest of
    1/8, 1/4, 1/2, 1 that stays at or above the target), then this
    library's bilinear resize, so it gives the fused path's pixels wherever
    PIL's libjpeg decodes as the linked one does."""
    from io import BytesIO
    from PIL import Image
    im = Image.open(BytesIO(data))
    if out_h > 0:
        im.draft("RGB", (out_w, out_h))
    image = np.asarray(im.convert("RGB"), np.uint8)
    if out_h > 0 and image.shape[:2] != (out_h, out_w):
        image = resize(image, out_h, out_w)
    return image


def _decode_fallback(data: bytes, out_h: int, out_w: int) -> np.ndarray:
    """PIL where libjpeg is absent or refused the bytes (another format)."""
    if pil_available():
        return _decode_pil(data, out_h, out_w)
    if jpeg_available():
        raise ValueError("not a JPEG libjpeg can decode (PIL, which decodes "
                         "other formats, is not installed)")
    raise _no_decoder()


def decode_jpeg(data: bytes, out_h: int = 0, out_w: int = 0) -> np.ndarray:
    """JPEG bytes -> uint8 RGB ``(out_h, out_w, 3)``, decoded at libjpeg's
    DCT-domain scale nearest above the target and resized bilinearly the
    rest of the way; the native size if ``out_h`` is 0."""
    data = _check_bytes(data)
    if jpeg_available():
        if out_h <= 0:
            out_h, out_w = jpeg_dims(data)
        out = np.empty((out_h, out_w, 3), np.uint8)
        rc = library().ssd_decode_jpeg(
            data, len(data), out.ctypes.data_as(ctypes.c_void_p), out_h,
            out_w)
        if rc == 0:
            return out
    return _decode_fallback(data, out_h, out_w)


def decode_jpeg_batch(datas: list[bytes], out_h: int, out_w: int,
                      n_threads: int = 8) -> np.ndarray:
    """Decodes a list of JPEGs in ``n_threads`` native threads ->
    ``(N, out_h, out_w, 3)`` uint8; an image libjpeg refuses goes to PIL."""
    datas = [_check_bytes(d) for d in datas]
    n = len(datas)
    if not jpeg_available():
        return np.stack([_decode_fallback(d, out_h, out_w) for d in datas])
    blob = b"".join(datas)
    offsets = np.zeros(n, np.uint64)
    lens = np.asarray([len(d) for d in datas], np.uint64)
    np.cumsum(lens[:-1], out=offsets[1:])
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    failures = library().ssd_decode_batch(
        blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), n,
        out.ctypes.data_as(ctypes.c_void_p), out_h, out_w, n_threads)
    if failures:
        # the library zeroed the slots it could not decode
        for i, d in enumerate(datas):
            if not out[i].any():
                out[i] = _decode_fallback(d, out_h, out_w)
    return out


def resize(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize of one ``(H, W, 3)`` uint8 image in the library."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"resize expects (H, W, 3) uint8, got "
                         f"{image.shape} {image.dtype}")
    if image.shape[:2] == (out_h, out_w):
        return image
    src = np.ascontiguousarray(image)
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = library().ssd_resize(
        src.ctypes.data_as(ctypes.c_void_p), src.shape[0], src.shape[1],
        out.ctypes.data_as(ctypes.c_void_p), out_h, out_w)
    if rc != 0:
        raise ValueError(f"resize of {image.shape} to ({out_h}, {out_w}) "
                         f"refused (rc {rc})")
    return out


def pack_s2d(images: np.ndarray, n_threads: int = 4,
             out: np.ndarray | None = None) -> np.ndarray:
    """``(N, H, W, 3)`` uint8 -> ``(N, H/4, W/4, 48)`` int8, the dense4
    feed (``ops/ingest.pack_s2d``), packed in ``n_threads`` native threads.
    ``out``: a C-contiguous int8 array of that shape to pack into (a pinned
    staging buffer)."""
    src = np.asarray(images)
    if src.dtype != np.uint8 or src.ndim != 4 or src.shape[3] != 3 \
            or src.shape[1] % 4 or src.shape[2] % 4:
        raise ValueError(f"pack_s2d expects (N, 4k, 4k, 3) uint8, got "
                         f"{src.shape} {src.dtype}")
    src = np.ascontiguousarray(src)
    n, h, w, _ = src.shape
    shape = (n, h // 4, w // 4, 48)
    if out is None:
        out = np.empty(shape, np.int8)
    elif (out.shape != shape or out.dtype != np.int8
          or not out.flags.c_contiguous):
        raise ValueError(f"out must be C-contiguous int8 {shape}, got "
                         f"{out.shape} {out.dtype}")
    rc = library().ssd_pack_s2d(
        src.ctypes.data_as(ctypes.c_void_p), n, h, w,
        out.ctypes.data_as(ctypes.c_void_p), n_threads)
    if rc != 0:
        raise ValueError(f"pack_s2d refused {src.shape} (rc {rc})")
    return out


def decoders() -> dict:
    """Which JPEG decoders this machine has: the library's libjpeg half
    (and the versions it was compiled against) and PIL's (its bundled
    libjpeg's versions)."""
    info = {"native_libjpeg": jpeg_available(), **jpeg_version(),
            "pil": None}
    if pil_available():
        import PIL
        from PIL import features
        info.update(pil=PIL.__version__, pil_jpeg=features.version("jpg"),
                    pil_libjpeg_turbo=features.version("libjpeg_turbo"))
    return info


def crc32c(data: bytes) -> int:
    """crc32c (Castagnoli) of ``data`` in the library (slice-by-8 tables);
    equal to ``data.tfrecord.crc32c``, the Python version."""
    data = bytes(data)
    return int(library().ssd_crc32c(data, len(data)))


def tfrecord_index(path: str) -> list[tuple[int, int]]:
    """``(payload offset, length)`` of every record of a tfrecord shard,
    walked in the library with the GIL released: every header CRC is
    checked, a truncated tail stops cleanly (``data.tfrecord.
    record_offsets``). Raises ``IOError`` for a file that is not a
    tfrecord, with the Python walker's message, and ``OSError`` for one
    that cannot be opened or read."""
    with open(path, "rb") as f:  # the OS error, in Python's words
        size = os.fstat(f.fileno()).st_size
    # Start from a typical record size and grow on -3 (cap too small)
    # rather than allocating the worst case up front: size // 16 entries
    # would cost about the file's size in index for a big shard.
    hard_cap = size // 16 + 1  # a record is at least 16 bytes: enough
    cap = min(max(size // 4096 + 16, 1024), hard_cap)
    lib = library()
    while True:
        offsets = np.empty(cap, np.uint64)
        lengths = np.empty(cap, np.uint64)
        bad = ctypes.c_uint64(0)
        n = lib.ssd_tfrecord_index(
            os.fsencode(path),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            cap, ctypes.byref(bad))
        if n != -3:
            break
        cap = min(cap * 4, hard_cap)
    if n == -1:
        raise IOError(
            f"{path}: not a TFRecord file (header CRC mismatch at "
            f"offset {bad.value}). Is the file pattern matching "
            "non-tfrecord files (e.g. the *-label_map.json / "
            "*-category_ids.json sidecars)? Use a pattern like "
            "'<prefix>-*-of-*'.")
    if n == -2:
        raise OSError(f"{path}: cannot open or seek the file")
    if n < 0:
        raise RuntimeError(f"{path}: ssd_tfrecord_index returned {n}")
    return [(int(offsets[i]), int(lengths[i])) for i in range(n)]
