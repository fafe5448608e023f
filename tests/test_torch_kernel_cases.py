"""The kernels' edge cases (``ssd_tpu_torch/tools/kernel_cases.py``): the
port's plain versions against the JAX package on the CPU, at small sizes.

The same cases hold the NMS and matching kernels to these plain versions on
the card (``chip_smoke.py``). Here, on every case:

- NMS: the port's ``batched_nms`` path against
  ``ssd_tpu.ops.nms.batched_nms``: ``num_boxes`` and labels exact, scores
  and boxes within 1e-6, and the kept count where the case fixes it;
- matching: the port's matches against ``ssd_tpu.ops.matching``'s
  exactly, and its best IoUs against the jnp IoU exactly; its ``best_gt``
  and ``best_anchor`` against the Pallas kernel's ``_match_core`` in
  interpret mode, equal but at near-ties of its rounding, its ``best_iou``
  within 1e-6 relative, and the matches made from its decisions equal to
  ``match_anchors_pallas``'s.

The tests of the kernels themselves are marked ``cuda`` and skip without a
card: the NMS and matching kernels against their plain versions on every
case, and the int8 conv (``csrc/conv_s8.cu``) against its plain version,
bit for bit, on each of ``kernel_cases.conv_cases`` (kernels 1, 3 and 7,
strides 1 and 2, C of 3 to 256, O of 7 to 720, M from 25 to a P3 head map
at b32, height strips, static and calibrated scales, bias and none, bf16
and s8 input in channels_last and NCHW memory, the raw s32 epilogue).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tpu.config import MatcherConfig as JaxMatcherConfig
from ssd_tpu.config import NMSConfig as JaxNMSConfig
from ssd_tpu.ops import box_utils as jax_box
from ssd_tpu.ops import nms as jax_nms
from ssd_tpu.ops.matching import match_anchors as jax_match_anchors
from ssd_tpu.ops.matching_pallas import _match_core, match_anchors_pallas
from ssd_tpu_torch.config import AnchorConfig, MatcherConfig, NMSConfig
from ssd_tpu_torch.data import synthetic
from ssd_tpu_torch.ops import box_utils, matching, matching_cuda, nms
from ssd_tpu_torch.ops import nms_cuda
from ssd_tpu_torch.ops.anchors import generate_anchors
from ssd_tpu_torch.tools import bench_conv_s8, kernel_cases

# the largest K the kernel admits in a block's default 48 KB of shared
# memory (csrc/nms.cu: 644 bytes per 32 candidates); on the card the case
# takes the card's own limit
SMALL_MAX_K = 32 * (48 * 1024 // 644)


@functools.lru_cache(maxsize=None)
def _nms_cases(max_k: int = SMALL_MAX_K) -> dict:
    return {c.name: c for c in kernel_cases.nms_cases(2, 640, 3, max_k)}


@functools.lru_cache(maxsize=None)
def _match_cases() -> dict:
    """Crowded 128 px scenes on the 128 px anchor grid (3069 anchors)."""
    b = synthetic.crowded_batch(0, 0, 8, 128, 8, 100)
    anchors = generate_anchors(128, AnchorConfig())
    return {c.name: c for c in kernel_cases.match_cases(
        anchors, b["boxes"], b["num_boxes"])}


@pytest.mark.parametrize("name", kernel_cases.NMS_CASES)
def test_nms_case_equals_jax(name):
    case = _nms_cases()[name]
    got = nms_cuda.batched_nms_cuda(torch.from_numpy(case.boxes),
                                    torch.from_numpy(case.scores),
                                    NMSConfig(**case.cfg))
    want = jax_nms.batched_nms(jnp.asarray(case.boxes),
                               jnp.asarray(case.scores),
                               JaxNMSConfig(**case.cfg))
    np.testing.assert_array_equal(got.num_boxes.numpy(),
                                  np.asarray(want.num_boxes))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               atol=1e-6, rtol=0)
    if case.kept is not None:
        cfg = NMSConfig(**case.cfg)
        top_scores, top_idx = nms.class_topk(torch.from_numpy(case.scores),
                                             cfg)
        kept = nms.suppress(torch.from_numpy(case.boxes), top_idx,
                            top_scores, cfg.iou_threshold)
        assert int((kept > 0).sum()) == case.kept


def test_nms_cases_reach_their_edges():
    """The cases are what their names say at these sizes."""
    cases = _nms_cases()
    assert [cases[f"k{k}"].cfg["pre_nms_top_k"] for k in (1, 32, 33, 100,
                                                           512)] == [
        1, 32, 33, 100, 512]
    mk = cases["max_k"]
    assert mk.cfg["pre_nms_top_k"] == SMALL_MAX_K == mk.boxes.shape[1]
    tie = torch.from_numpy(cases["iou_at_threshold"].boxes[0])
    assert float(box_utils.iou(tie[:1], tie[1:2])) == 0.5


def _near_ties(ious, got, want, axis: int) -> None:
    """Where two argmaxes differ, the IoUs they pick (JAX's, ``(N, A, M)``)
    differ by less than 1e-6 relative: a near-tie that rounding decides."""
    n_idx, k_idx = np.nonzero(got != want)
    if axis == 2:  # best gt per (image, anchor)
        a = ious[n_idx, k_idx, got[n_idx, k_idx]]
        b = ious[n_idx, k_idx, want[n_idx, k_idx]]
    else:  # best anchor per (image, gt)
        a = ious[n_idx, got[n_idx, k_idx], k_idx]
        b = ious[n_idx, want[n_idx, k_idx], k_idx]
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", kernel_cases.MATCH_CASES)
def test_match_case_equals_jax(name):
    """Exact against the jnp matcher. Against the Pallas kernel in
    interpret mode, whose IoUs are up to 4 ulps off (``ROADMAP.md`` §3):
    equal decisions but at near-ties, which the real anchor grid has (its
    aspect ratios give equal IoUs in exact arithmetic), and equal matches
    from its decisions."""
    case = _match_cases()[name]
    cfg = dataclasses.replace(MatcherConfig(),
                              force_match_for_each_gt=case.force_match)
    jcfg = dataclasses.replace(JaxMatcherConfig(),
                               force_match_for_each_gt=case.force_match)
    anchors, gt, num = (torch.from_numpy(x)
                        for x in (case.anchors, case.gt, case.num))
    ja, jg, jn = (jnp.asarray(x) for x in (case.anchors, case.gt, case.num))
    got = matching_cuda.match_anchors(anchors, gt, num, cfg).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_match_anchors(ja, jg, jn, jcfg)))
    core = [x.numpy() for x in matching.match_core(anchors, gt, num)]
    m = case.gt.shape[1]
    ious = np.asarray(jax_box.iou(ja[None], jg))
    valid = np.arange(m)[None, None, :] < case.num[:, None, None]
    np.testing.assert_array_equal(core[1],
                                  np.where(valid, ious, -1.0).max(-1))

    want = [np.array(x) for x in _match_core(ja, jg, jn, interpret=True)]
    _near_ties(ious, core[0], want[0], axis=2)
    _near_ties(ious, core[2], want[2], axis=1)
    np.testing.assert_allclose(core[1], want[1], rtol=1e-6, atol=0)
    from_pallas = matching.finish_matches(
        *(torch.from_numpy(x) for x in want), num, cfg)
    np.testing.assert_array_equal(
        from_pallas.numpy(),
        np.asarray(match_anchors_pallas(ja, jg, jn, jcfg, interpret=True)))


def test_match_cases_reach_their_edges():
    """Anchor 5's box repeats at 700 and 1500 and a gt sits on it, so the
    gt's best IoU ties across blocks and anchor 5 wins; the gts on a run's
    bound from outside overlap none of its anchors."""
    cases = _match_cases()
    twins = cases["dup_anchors"]
    np.testing.assert_array_equal(twins.anchors[700], twins.anchors[5])
    np.testing.assert_array_equal(twins.anchors[1500], twins.anchors[5])
    core = matching.match_core(*(torch.from_numpy(x) for x in (
        twins.anchors, twins.gt, twins.num)))
    assert (core[2][:, 0] == 5).all()
    edge = cases["edge_on_bound"]
    anchors = torch.from_numpy(edge.anchors)
    outside = torch.from_numpy(edge.gt[0, :4])  # the first run's four sides
    assert float(box_utils.iou(anchors[:32], outside).max()) == 0.0
    assert float(box_utils.iou(anchors[32:], outside).max()) > 0.0
    out = cases["outside_unit"].gt
    assert (out < 0).any() and (out > 1).any()


@pytest.mark.cuda
def test_kernels_equal_plain_on_every_case():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    for case in _nms_cases(nms_cuda._max_k(dev)).values():
        cfg = NMSConfig(**case.cfg)
        boxes = torch.from_numpy(case.boxes).to(dev)
        top_scores, top_idx = nms.class_topk(
            torch.from_numpy(case.scores).to(dev), cfg)
        got = nms_cuda.suppress_cuda(boxes, top_idx, top_scores,
                                     cfg.iou_threshold)
        want = nms.suppress(boxes, top_idx, top_scores, cfg.iou_threshold)
        assert torch.equal(got > 0, want > 0), case.name
        assert float((got - want).abs().max()) <= 1e-6, case.name
    for case in _match_cases().values():
        cfg = dataclasses.replace(MatcherConfig(),
                                  force_match_for_each_gt=case.force_match)
        a, g, nb = (torch.from_numpy(x).to(dev)
                    for x in (case.anchors, case.gt, case.num))
        for x, y in zip(matching_cuda.match_core_cuda(a, g, nb),
                        matching.match_core(a, g, nb)):
            assert torch.equal(x, y), case.name
        assert torch.equal(matching_cuda.match_anchors(a, g, nb, cfg),
                           matching.match_anchors(a, g, nb, cfg)), case.name


@pytest.mark.cuda
@pytest.mark.parametrize("name", kernel_cases.CONV_CASES)
def test_conv_kernel_equals_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    case = {c.name: c for c in kernel_cases.conv_cases()}[name]
    row = bench_conv_s8.check_case(case, torch.device("cuda"))
    assert row["bit_equal"]
