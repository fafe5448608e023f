"""The port's ops against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go through both. Geometry is held
at f32 1e-6. The NMS module (``ssd_tpu_torch.ops.nms_cuda.batched_nms_cuda``
on CPU tensors, which runs the kernel's plain version) is held against both
JAX paths, ``ssd_tpu.ops.nms.batched_nms`` and the Pallas kernel in
interpret mode, case for case as ``tests/test_nms_pallas.py`` holds the
Pallas kernel: exact ``num_boxes`` and labels, scores within 1e-6 on
tie-free inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssd_tpu.config import AnchorConfig as JaxAnchorConfig
from ssd_tpu.config import NMSConfig as JaxNMSConfig
from ssd_tpu.ops import anchors as jax_anchors
from ssd_tpu.ops import box_utils as jax_box
from ssd_tpu.ops import ingest as jax_ingest
from ssd_tpu.ops import nms as jax_nms
from ssd_tpu.ops import postprocess as jax_post
from ssd_tpu.ops.nms_pallas import batched_nms_pallas
from ssd_tpu_torch.config import AnchorConfig, NMSConfig
from ssd_tpu_torch.data.resize import resize
from ssd_tpu_torch.ops import anchors, box_utils, ingest, nms, nms_cuda
from ssd_tpu_torch.ops import postprocess
from tests.test_nms import nms_oracle


def _boxes(rng, shape):
    lo = rng.uniform(0, 0.7, shape + (2,))
    hi = lo + rng.uniform(0.05, 0.3, shape + (2,))
    return np.concatenate([lo, hi], axis=-1).astype(np.float32)


# ------------------------------------------------------------------ geometry

@pytest.mark.parametrize("image_size", [128, 640, (96, 160), (100, 75)])
def test_anchors_match(image_size):
    cfg = AnchorConfig()
    want = jax_anchors.generate_anchors(image_size, JaxAnchorConfig())
    got = anchors.generate_anchors(image_size, cfg)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_iou_decode_clip_match(rng):
    b1 = _boxes(rng, (3, 17))
    b2 = _boxes(rng, (3, 11))
    b2[0, :3] = b2[0, :3][:, [2, 3, 0, 1]]  # degenerate boxes: area 0
    np.testing.assert_allclose(
        box_utils.iou(torch.from_numpy(b1), torch.from_numpy(b2)).numpy(),
        np.asarray(jax_box.iou(b1, b2)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        box_utils.area(torch.from_numpy(b1)).numpy(),
        np.asarray(jax_box.area(b1)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        box_utils.to_center_form(torch.from_numpy(b1)).numpy(),
        np.asarray(jax_box.to_center_form(b1)), atol=1e-6, rtol=0)

    codes = rng.normal(0, 2.0, (4, 50, 4)).astype(np.float32)
    codes[0, :5, 2:] = 80.0  # past the exp clamp
    anc = _boxes(rng, (50,))
    want = jax_box.clip_boxes(jax_box.decode(codes, anc))
    got = box_utils.clip_boxes(box_utils.decode(torch.from_numpy(codes),
                                                torch.from_numpy(anc)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_pack_s2d_bit_identical(rng):
    imgs = rng.integers(0, 256, (3, 16, 24, 3)).astype(np.uint8)
    got = ingest.pack_s2d(imgs)
    want = jax_ingest.pack_s2d(imgs)
    assert got.dtype == np.int8 and got.shape == ingest.packed_shape((16, 24), 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ingest.unpack_s2d(got), imgs)


@pytest.mark.parametrize("src,dst", [((37, 53), (128, 128)),
                                     ((481, 333), (97, 131)),
                                     ((64, 64), (31, 95))])
def test_resize_within_one_lsb(rng, src, dst):
    from ssd_tpu.data import native
    img = rng.integers(0, 256, src + (3,)).astype(np.uint8)
    want = native.resize(img, *dst)
    got = resize(img, *dst)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


# ------------------------------------------------------------------ select

def test_select_candidates_cells_matches(rng):
    """Cell-major selection with the refine stage, f32 raw maps."""
    c, k = 3, 9
    sizes = [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]
    raw = [(rng.normal(-3.0, 1.5, (2, h, w, k * c)).astype(np.float32),
            rng.normal(0.0, 1.0, (2, h, w, k * 4)).astype(np.float32))
           for h, w in sizes]
    anc = _boxes(rng, (sum(h * w for h, w in sizes) * k,))
    kw = dict(score_threshold=0.05, num_candidates=64, cell_overprovision=2.0)
    want_b, want_s = jax_post.select_candidates_cells(
        [(jnp.asarray(a), jnp.asarray(b)) for a, b in raw], jnp.asarray(anc),
        c, JaxNMSConfig(**kw))
    got_b, got_s = postprocess.select_candidates_cells(
        [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in raw],
        torch.from_numpy(anc), c, NMSConfig(**kw))
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-6,
                               rtol=0)


# ------------------------------------------------------------------ NMS

def _random_instance(rng, n, a, c):
    boxes = _boxes(rng, (n, a))
    # tie-free scores so every path orders candidates the same way
    base = rng.permutation(n * a * c).astype(np.float32) / (n * a * c)
    return boxes, base.reshape(n, a, c)


def _port(boxes, scores, cfg_kw):
    return nms_cuda.batched_nms_cuda(torch.from_numpy(boxes),
                                     torch.from_numpy(scores),
                                     NMSConfig(**cfg_kw))


def _assert_same(got, want):
    """Exact num_boxes and labels, scores and boxes within 1e-6."""
    np.testing.assert_array_equal(got.num_boxes.numpy(),
                                  np.asarray(want.num_boxes))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               atol=1e-6, rtol=0)


def _assert_matches_both_jax_paths(boxes, scores, cfg_kw):
    got = _port(boxes, scores, cfg_kw)
    _assert_same(got, jax_nms.batched_nms(boxes, scores, JaxNMSConfig(**cfg_kw)))
    _assert_same(got, batched_nms_pallas(boxes, scores, JaxNMSConfig(**cfg_kw),
                                         interpret=True))
    return got


@pytest.mark.parametrize("n,a,c", [(1, 60, 4), (2, 200, 3)])
def test_nms_matches_oracle(rng, n, a, c):
    boxes, scores = _random_instance(rng, n, a, c)
    cfg_kw = dict(score_threshold=0.2, iou_threshold=0.5, max_boxes=400,
                  pre_nms_top_k=a)
    det = _assert_matches_both_jax_paths(boxes, scores, cfg_kw)
    for i in range(n):
        want = []
        for cl in range(c):
            for j in nms_oracle(boxes[i], scores[i, :, cl], 0.5, 0.2):
                want.append((cl, round(float(scores[i, j, cl]), 6)))
        nb = int(det.num_boxes[i])
        got = [(int(det.labels[i, q]), round(float(det.scores[i, q]), 6))
               for q in range(nb)]
        assert sorted(got) == sorted(want)


def test_nms_matches_jnp_reference(rng):
    boxes, scores = _random_instance(rng, 2, 150, 5)
    _assert_matches_both_jax_paths(
        boxes, scores, dict(score_threshold=0.3, iou_threshold=0.45,
                            max_boxes=50, pre_nms_top_k=128))


@pytest.mark.parametrize("iou_thr,kept", [(0.3, 8), (0.2, 4)])
def test_nms_adversarial_overlaps(iou_thr, kept):
    # chains of boxes where each overlaps the next (IoU 0.25) but not the one
    # after: at 0.2 a dropped box must not suppress its successor
    boxes = np.zeros((1, 8, 4), np.float32)
    for i in range(8):
        boxes[0, i] = [0.0, 0.06 * i, 0.2, 0.06 * i + 0.1]
    scores = np.linspace(0.9, 0.5, 8, dtype=np.float32).reshape(1, 8, 1)
    det = _assert_matches_both_jax_paths(
        boxes, scores, dict(score_threshold=0.1, iou_threshold=iou_thr,
                            max_boxes=8, pre_nms_top_k=8))
    want = nms_oracle(boxes[0], scores[0, :, 0], iou_thr, 0.1)
    assert int(det.num_boxes[0]) == len(want) == kept


def test_nms_empty():
    boxes = np.zeros((1, 16, 4), np.float32)
    scores = np.zeros((1, 16, 2), np.float32)
    det = _assert_matches_both_jax_paths(
        boxes, scores, dict(score_threshold=0.5, max_boxes=5,
                            pre_nms_top_k=16))
    assert int(det.num_boxes[0]) == 0
    assert (det.labels.numpy() == -1).all()


def test_nms_large_k(rng):
    """K = 400: the TPU kernel's jnp fallback range; the port's kernel takes
    any K its shared memory holds, and the plain path is exact."""
    boxes, scores = _random_instance(rng, 1, 600, 2)
    _assert_matches_both_jax_paths(
        boxes, scores, dict(score_threshold=0.2, iou_threshold=0.5,
                            max_boxes=50, pre_nms_top_k=400))


def test_nms_ties_take_lower_index_first():
    """Equal scores (common with bf16 logits): the lower candidate index
    wins every top-k, as XLA's TopK orders them."""
    boxes = np.asarray([[[0.1, 0.1, 0.4, 0.4], [0.1, 0.1, 0.41, 0.41],
                         [0.6, 0.6, 0.9, 0.9], [0.6, 0.6, 0.91, 0.9]]],
                       np.float32)
    scores = np.full((1, 4, 2), 0.5, np.float32)
    _assert_matches_both_jax_paths(
        boxes, scores, dict(score_threshold=0.1, iou_threshold=0.5,
                            max_boxes=3, pre_nms_top_k=4))


def test_plain_batched_nms_is_the_cpu_dispatch(rng):
    boxes, scores = _random_instance(rng, 2, 90, 4)
    cfg = NMSConfig(score_threshold=0.2, max_boxes=40, pre_nms_top_k=64)
    a = nms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores), cfg)
    b = nms_cuda.batched_nms_cuda(torch.from_numpy(boxes),
                                  torch.from_numpy(scores), cfg)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
