"""The port's anchor matching and training targets against the JAX package.

On the CPU the port's matcher is the plain version of the matching kernel
(``ssd_tpu_torch/ops/matching.py``). It must equal JAX's ``match_anchors``
and its Pallas kernel run in interpret mode exactly, case for case as
``tests/test_matching_pallas.py`` holds them, and its kernel-shaped core
outputs must equal the Pallas kernel's. ``create_targets`` must be exact on
matches, weights and labels, with regression targets within 1e-6.

The kernel itself (``csrc/match.cu``) runs only on the card: the one test
of it here is marked ``cuda`` and skips without a GPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tpu.config import AnchorConfig as JaxAnchorConfig
from ssd_tpu.config import MatcherConfig as JaxMatcherConfig
from ssd_tpu.ops import box_utils as jax_box
from ssd_tpu.ops import targets as jax_targets
from ssd_tpu.ops.anchors import generate_anchors as jax_generate_anchors
from ssd_tpu.ops.matching import match_anchors as jax_match_anchors
from ssd_tpu.ops.matching_pallas import _match_core, match_anchors_pallas
from ssd_tpu.tools.crowded_validation import crowded_example as jax_crowded
from ssd_tpu_torch.config import MatcherConfig
from ssd_tpu_torch.data.synthetic import crowded_example, pad_batch
from ssd_tpu_torch.ops import matching, matching_cuda
from ssd_tpu_torch.ops.targets import create_targets

CFG = MatcherConfig()
JCFG = JaxMatcherConfig()


def _random_instance(rng, n, a, m):
    """Random anchors and padded gt boxes with varying num_boxes (the
    generator of tests/test_matching_pallas.py)."""
    def boxes(shape):
        c = rng.uniform(0.1, 0.9, shape + (2,))
        s = rng.uniform(0.02, 0.3, shape + (2,))
        return np.concatenate([c - s / 2, c + s / 2], axis=-1).astype(
            np.float32).clip(0, 1)

    anchors = boxes((a,))
    gt = boxes((n, m))
    num = rng.integers(0, m + 1, (n,)).astype(np.int32)
    return anchors, gt, num


def _port(anchors, gt, num, cfg=CFG) -> np.ndarray:
    out = matching_cuda.match_anchors(torch.from_numpy(anchors),
                                      torch.from_numpy(gt),
                                      torch.from_numpy(num), cfg)
    assert out.dtype == torch.int32
    return out.numpy()


def _assert_matches_both_jax_paths(anchors, gt, num, force=True):
    cfg = dataclasses.replace(CFG, force_match_for_each_gt=force)
    jcfg = dataclasses.replace(JCFG, force_match_for_each_gt=force)
    got = _port(anchors, gt, num, cfg)
    a, g, nb = jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(num)
    np.testing.assert_array_equal(
        got, np.asarray(jax_match_anchors(a, g, nb, jcfg)))
    np.testing.assert_array_equal(
        got, np.asarray(match_anchors_pallas(a, g, nb, jcfg, interpret=True)))
    return got


@pytest.mark.parametrize("n,a,m", [(2, 500, 8), (3, 3000, 100), (1, 2048, 1),
                                   (2, 700, 13)])
def test_matches_jax_reference_and_kernel(rng, n, a, m):
    _assert_matches_both_jax_paths(*_random_instance(rng, n, a, m))


def test_zero_gt_images(rng):
    """num_boxes=0 images: everything negative (force-match is a no-op)."""
    anchors, gt, _ = _random_instance(rng, 2, 600, 10)
    got = _assert_matches_both_jax_paths(anchors, gt,
                                         np.asarray([0, 3], np.int32))
    assert np.all(got[0] == -1)


def test_duplicate_boxes_tiebreak(rng):
    """Identical gt boxes tie on every IoU: first occurrence per anchor."""
    anchors, gt, num = _random_instance(rng, 2, 400, 6)
    gt[:, 3] = gt[:, 1]
    _assert_matches_both_jax_paths(anchors, gt, np.asarray([6, 5], np.int32))


def test_forced_collision_takes_the_later_gt():
    """Two gts whose best anchor is the same anchor, each below the
    matching threshold: the later gt index wins the forced match."""
    anchors = np.asarray([[0.0, 0.0, 0.5, 0.5], [0.5, 0.5, 1.0, 1.0],
                          [0.0, 0.5, 0.5, 1.0]], np.float32)
    gt = np.asarray([[[0.0, 0.0, 0.2, 0.2], [0.1, 0.1, 0.3, 0.3],
                      [0.6, 0.6, 0.8, 0.8]]], np.float32)
    got = _assert_matches_both_jax_paths(anchors, gt,
                                         np.asarray([3], np.int32))
    np.testing.assert_array_equal(got, [[1, 2, -1]])


def test_no_force_match(rng):
    anchors, gt, num = _random_instance(rng, 2, 512, 12)
    _assert_matches_both_jax_paths(anchors, gt, num, force=False)


def test_degenerate_and_outside_gts(rng):
    """A zero-area gt and a gt that overlaps no anchor both score IoU 0
    with every anchor: each force-matches anchor 0, the first maximum."""
    anchors, gt, _ = _random_instance(rng, 1, 300, 4)
    gt[0, 1] = [0.5, 0.5, 0.5, 0.7]  # zero height
    anchors = anchors * 0.5  # every anchor in the top-left quarter
    gt[0, 2] = [0.8, 0.8, 0.95, 0.95]
    got = _assert_matches_both_jax_paths(anchors, gt,
                                         np.asarray([4], np.int32))
    best_gt, best_iou, best_anchor = matching.match_core(
        torch.from_numpy(anchors), torch.from_numpy(gt),
        torch.tensor([4], dtype=torch.int32))
    assert best_anchor[0, 1] == 0 and best_anchor[0, 2] == 0
    assert (got == 1).sum() == 0 and got[0, 0] != 1  # gt 1 lost to later gts


@pytest.mark.parametrize("n,a,m", [(3, 1000, 100), (2, 4096, 1),
                                   (2, 2500, 13)])
def test_core_outputs_equal_the_pallas_kernel(rng, n, a, m):
    """best_gt, best_iou and best_anchor, the kernel's three outputs.

    The indices equal the Pallas kernel's. The IoUs equal the jnp
    matcher's exactly. The interpret-mode Pallas kernel's IoUs differ from
    both by up to 4 ulps on up to 13% of anchors at M = 13 (seeds 0-3; XLA's
    CPU code for the kernel rounds the IoU's ops differently), so they are
    held to rtol 1e-6 (8 ulps) there.
    """
    anchors, gt, num = _random_instance(rng, n, a, m)
    num[0] = 0
    want = _match_core(jnp.asarray(anchors), jnp.asarray(gt),
                       jnp.asarray(num), interpret=True)
    got = matching.match_core(torch.from_numpy(anchors),
                              torch.from_numpy(gt), torch.from_numpy(num))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=0)
    ious = jax_box.iou(jnp.asarray(anchors)[None], jnp.asarray(gt))
    valid = jnp.arange(m)[None, None, :] < jnp.asarray(num)[:, None, None]
    np.testing.assert_array_equal(
        got[1].numpy(), np.asarray(jnp.where(valid, ious, -1.0).max(-1)))
    assert (got[1][0] == -1).all() and (got[0][0] == 0).all()


def _crowded_batch(seed, n, size, classes, max_gt):
    rng = np.random.default_rng(seed)
    return pad_batch([crowded_example(rng, classes, size) for _ in range(n)],
                     max_gt)


@pytest.mark.parametrize("class_onehot", [True, False])
def test_create_targets_matches_jax(class_onehot):
    """Crowded scenes at 128 px on the real anchor grid: matches, weights
    and labels exact; regression targets within 1e-6."""
    b = _crowded_batch(3, 3, 128, 8, 100)
    b["num_boxes"][1] = 0
    anchors = jax_generate_anchors(128, JaxAnchorConfig())
    want = jax_targets.create_targets(
        jnp.asarray(anchors), jnp.asarray(b["boxes"]),
        jnp.asarray(b["labels"]), jnp.asarray(b["num_boxes"]), 8, JCFG,
        class_onehot=class_onehot)
    got = create_targets(torch.from_numpy(anchors),
                         torch.from_numpy(b["boxes"]),
                         torch.from_numpy(b["labels"]),
                         torch.from_numpy(b["num_boxes"]), 8, CFG,
                         class_onehot=class_onehot)
    assert (np.asarray(want.matches) >= 0).sum() > 100
    for field in ("matches", "cls_weights", "reg_weights", "cls_targets",
                  "matched_labels"):
        w, g = getattr(want, field), getattr(got, field)
        if w is None:
            assert g is None, field
            continue
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), field)
    np.testing.assert_allclose(got.reg_targets.numpy(),
                               np.asarray(want.reg_targets), rtol=0, atol=1e-6)


def test_crowded_example_scenes_equal_jax():
    """The port's crowded scenes are JAX's: boxes and labels equal (the
    JAX generator returns a JPEG, so its pixels are not compared)."""
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(3):
        img, boxes, labels = crowded_example(r1, 80, 640)
        _, jboxes, jlabels = jax_crowded(r2, 80, 640)
        assert img.shape == (640, 640, 3) and img.dtype == np.uint8
        np.testing.assert_array_equal(boxes, jboxes)
        np.testing.assert_array_equal(labels, jlabels)


@pytest.mark.cuda
def test_kernel_equals_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(0)
    anchors, gt, num = _random_instance(rng, 4, 20000, 100)
    num[0] = 0
    dev = torch.device("cuda")
    a, g, nb = (torch.from_numpy(x).to(dev) for x in (anchors, gt, num))
    got = matching_cuda.match_core_cuda(a, g, nb)
    want = matching.match_core(a, g, nb)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert torch.equal(matching_cuda.match_anchors(a, g, nb, CFG),
                       matching.match_anchors(a, g, nb, CFG))
