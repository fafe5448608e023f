"""The port's host ingest library (``ssd_tpu_torch/csrc/loader.cc`` through
``ssd_tpu_torch/data/native.py``) against the JAX package's
(``native/loader.cc`` through ``ssd_tpu.data.native``), on the CPU.

Both build here with the same compiler and flags, so every output is held
bit-equal: the space-to-depth pack (and to the numpy plain version
``ops/ingest.py``), the bilinear resize (and within one unit of the numpy
plain version ``data/resize.py``), the fused JPEG decode+resize on its
direct and DCT-scaled paths, the threaded batch decode, and the header
dimensions. Also: the PIL fallback gives the native path's pixels; the
library builds and serves resize and pack without its JPEG half; a machine
with no decoder raises; the predictor's resize and letterbox equal the JAX
package's.
"""

import ctypes
import io
import os
import subprocess

import numpy as np
import pytest
from PIL import Image

from ssd_tpu import predictor as jax_predictor
from ssd_tpu.data import native as jax_native
from ssd_tpu_torch import _build
from ssd_tpu_torch import predictor as port_predictor
from ssd_tpu_torch.data import native, synthetic
from ssd_tpu_torch.data.resize import resize as plain_resize
from ssd_tpu_torch.ops.ingest import pack_s2d as plain_pack


def _jpeg(image: np.ndarray, quality: int = 90) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _scene_jpeg(seed: int, hw: tuple[int, int]) -> bytes:
    """A seeded sanity scene, resized to ``hw`` (so objects, not noise,
    fill it) and encoded."""
    image, _, _ = synthetic.sanity_scene(np.random.default_rng(seed))
    if image.shape[:2] != hw:
        image = np.asarray(Image.fromarray(image).resize(hw[::-1],
                                                         Image.BILINEAR))
    return _jpeg(image)


@pytest.fixture(scope="module", autouse=True)
def both_libraries():
    assert jax_native.available(), "the JAX package's native library"
    assert native.jpeg_available(), "the tests build with jpeglib.h and libjpeg"


@pytest.mark.parametrize("shape,threads", [
    ((1, 4, 4), 1), ((3, 64, 96), 4), ((2, 128, 128), 1), ((5, 32, 640), 3)])
def test_pack_s2d_bit_equal(shape, threads):
    n, h, w = shape
    x = np.random.default_rng(h * w).integers(0, 256, (n, h, w, 3),
                                              dtype=np.uint8)
    got = native.pack_s2d(x, n_threads=threads)
    np.testing.assert_array_equal(got, jax_native.pack_s2d(x, threads))
    np.testing.assert_array_equal(got, plain_pack(x))
    out = np.full(got.shape, 7, np.int8)
    assert native.pack_s2d(x, out=out) is out
    np.testing.assert_array_equal(out, got)


def test_pack_s2d_refuses_bad_input():
    with pytest.raises(ValueError, match="uint8"):
        native.pack_s2d(np.zeros((1, 6, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        native.pack_s2d(np.zeros((1, 8, 8, 3), np.int8))
    with pytest.raises(ValueError, match="C-contiguous"):
        native.pack_s2d(np.zeros((1, 8, 8, 3), np.uint8),
                        out=np.zeros((1, 2, 2, 47), np.int8))


@pytest.mark.parametrize("src,dst", [
    ((50, 70), (64, 64)), ((300, 200), (128, 128)), ((128, 128), (37, 91)),
    ((640, 480), (640, 640)), ((7, 5), (1, 1)), ((1, 1), (9, 4))])
def test_resize_bit_equal(src, dst):
    image = np.random.default_rng(src[0]).integers(0, 256, (*src, 3),
                                                   dtype=np.uint8)
    got = native.resize(image, *dst)
    np.testing.assert_array_equal(got, jax_native.resize(image, *dst))
    # the numpy version rounds every product; the C++ one may contract
    # a * b + c into an FMA under -march=native
    diff = np.abs(got.astype(np.int16) - plain_resize(image, *dst))
    assert diff.max() <= 1


def test_resize_refuses_bad_input():
    with pytest.raises(ValueError, match="uint8"):
        native.resize(np.zeros((4, 4), np.uint8), 2, 2)
    with pytest.raises(ValueError, match="refused"):
        native.resize(np.zeros((4, 4, 3), np.uint8), 0, 2)


# (source size, target): the direct path (no resize), a resize without DCT
# scaling (source < 2x target), DCT scales 1/2, 1/4 and 1/8, non-square,
# and the native size (target 0)
DECODE_CASES = [((128, 128), (128, 128)), ((96, 160), (128, 128)),
                ((256, 256), (128, 128)), ((300, 420), (128, 128)),
                ((520, 600), (128, 128)), ((1100, 1030), (128, 128)),
                ((129, 257), (64, 96)), ((300, 420), (0, 0))]


@pytest.mark.parametrize("src,dst", DECODE_CASES)
def test_decode_jpeg_bit_equal(src, dst):
    data = _scene_jpeg(src[0] + src[1], src)
    got = native.decode_jpeg(data, *dst)
    assert got.shape == ((*src, 3) if dst == (0, 0) else (*dst, 3))
    np.testing.assert_array_equal(got, jax_native.decode_jpeg(data, *dst))
    assert native.jpeg_dims(data) == jax_native.jpeg_dims(data) == src


@pytest.mark.parametrize("src,dst", DECODE_CASES[:-1])
def test_pil_fallback_gives_the_native_pixels(monkeypatch, src, dst):
    """Without the library's libjpeg half, PIL decodes at the same DCT scale
    and the library resizes: the JAX package's native pixels."""
    data = _scene_jpeg(src[0] + src[1], src)
    monkeypatch.setattr(native, "jpeg_available", lambda: False)
    np.testing.assert_array_equal(native.decode_jpeg(data, *dst),
                                  jax_native.decode_jpeg(data, *dst))
    assert native.jpeg_dims(data) == src


def test_decode_jpeg_batch_bit_equal():
    sizes = [(128, 128), (96, 160), (300, 420), (520, 600), (256, 256)]
    datas = [_scene_jpeg(i, hw) for i, hw in enumerate(sizes)]
    got = native.decode_jpeg_batch(datas, 128, 128, n_threads=3)
    np.testing.assert_array_equal(
        got, jax_native.decode_jpeg_batch(datas, 128, 128, n_threads=3))
    for d, g in zip(datas, got):
        np.testing.assert_array_equal(g, native.decode_jpeg(d, 128, 128))


def test_decode_other_formats_and_garbage():
    image = np.random.default_rng(0).integers(0, 256, (40, 60, 3),
                                              dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    # libjpeg refuses a PNG; PIL decodes it
    np.testing.assert_array_equal(native.decode_jpeg(buf.getvalue()), image)
    with pytest.raises(OSError):  # PIL's UnidentifiedImageError
        native.decode_jpeg(b"not an image", 64, 64)
    with pytest.raises(ValueError, match="empty"):
        native.decode_jpeg(b"", 64, 64)


def test_no_decoder_raises(monkeypatch):
    data = _scene_jpeg(0, (128, 128))
    monkeypatch.setattr(native, "jpeg_available", lambda: False)
    monkeypatch.setattr(native, "pil_available", lambda: False)
    with pytest.raises(RuntimeError, match="no JPEG decoder"):
        native.decode_jpeg(data, 64, 64)
    with pytest.raises(RuntimeError, match="no JPEG decoder"):
        native.jpeg_dims(data)


def test_library_builds_without_its_jpeg_half(tmp_path):
    """Where no libjpeg is found the library still builds, exports resize
    and pack (bit-equal), and says it has no JPEG half."""
    out = str(tmp_path / "loader-nojpeg.so")
    cmd = _build.host_command("loader", out, _build.host_compiler(),
                              jpeg=False)
    assert "-ljpeg" not in cmd and "-DSSD_WITH_JPEG" not in cmd
    subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    lib = native._bind(ctypes.CDLL(out))
    assert lib.ssd_jpeg_available() == 0
    assert not hasattr(lib, "ssd_decode_jpeg")
    x = np.random.default_rng(1).integers(0, 256, (2, 16, 24, 3),
                                          dtype=np.uint8)
    packed = np.empty((2, 4, 6, 48), np.int8)
    assert lib.ssd_pack_s2d(x.ctypes.data_as(ctypes.c_void_p), 2, 16, 24,
                            packed.ctypes.data_as(ctypes.c_void_p), 2) == 0
    np.testing.assert_array_equal(packed, plain_pack(x))
    small = np.empty((5, 7, 3), np.uint8)
    assert lib.ssd_resize(x[0].ctypes.data_as(ctypes.c_void_p), 16, 24,
                          small.ctypes.data_as(ctypes.c_void_p), 5, 7) == 0
    np.testing.assert_array_equal(small, jax_native.resize(x[0], 5, 7))


def test_build_is_keyed_and_raises_on_failure(tmp_path, monkeypatch):
    cxx = _build.host_compiler()
    with_jpeg = _build.host_target("loader", cxx, True)
    without = _build.host_target("loader", cxx, False)
    assert with_jpeg != without and os.path.exists(with_jpeg)
    # a failing compiler raises; nothing falls back to numpy
    fake = tmp_path / "fake-cxx"
    fake.write_text("#!/bin/sh\necho refusing >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="host library build failed"):
        _build.load_host("loader")


@pytest.mark.parametrize("hw", [(480, 640), (333, 517), (64, 64)])
def test_predictor_resize_and_letterbox_match_jax(hw):
    image = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3),
                                                  dtype=np.uint8)
    np.testing.assert_array_equal(
        port_predictor.resize_image(image, 128),
        jax_predictor.resize_image(image, 128))
    got, gh, gw = port_predictor.letterbox_image(image, (96, 128))
    want, wh, ww = jax_predictor.letterbox_image(image, (96, 128))
    np.testing.assert_array_equal(got, want)
    assert (gh, gw) == (wh, ww)
