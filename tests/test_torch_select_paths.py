"""The port's other selection paths, the fused head and Soft-NMS against the
JAX package's, on the CPU; then ``Detector.predict`` of each new config.

On the same f32 inputs (f32: labels and counts equal, scores and boxes
within 1e-6):

* ``select="anchors"`` (``select_candidates``, ``postprocess_detections``),
  with few anchors over the threshold, so the order among the -inf maxima
  matters (JAX's ``approx_max_k`` lowers to an exact top-k on the CPU);
  sub-threshold picks keep their scores there;
* the pyramid path (``select_candidates_pyramid``, ``postprocess_pyramid``)
  on per-level maps, which zeroes sub-threshold picks;
* the fused 1x1 head (``fused_head_detections``) on the same trunks and
  1x1 kernels, and against the port's own unfused path on tie-free inputs,
  as ``tests/test_fused_head.py`` holds JAX's;
* Soft-NMS, linear and gaussian, through ``batched_nms``, including a
  crowded scene of near-duplicates like ``tests/test_soft_nms.py``'s.

Then the slice as a whole: ``Detector.predict`` of each new config (64 px,
the backbone widths of ``tests/test_torch_backbones.py``, 8 classes, FPN
32, head depth 1, f32, a class bias that keeps detections live) and of the
MobileNet-v1 config with ``select="anchors"``, the fused head, and Soft-NMS,
against JAX's jitted ``Detector.predict`` under the golden set rule.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tpu.config import NMSConfig as JaxNMSConfig
from ssd_tpu.models.detector import Detector as JaxDetector
from ssd_tpu.ops import fused_head as jax_fused_head
from ssd_tpu.ops import nms as jax_nms
from ssd_tpu.ops import postprocess as jax_post
from ssd_tpu_torch.config import NMSConfig
from ssd_tpu_torch.convert import convert_variables
from ssd_tpu_torch.models.detector import Detector
from ssd_tpu_torch.models.fpn import RetinaHead
from ssd_tpu_torch.ops import fused_head, nms, nms_cuda, postprocess
from tests.test_torch_backbones import configs
from tests.test_torch_backbones import torch_threads  # noqa: F401
from tests.test_torch_model import seeded_variables
from tests.test_torch_slice import assert_set_match

DET_KEYS = ("boxes", "scores", "labels", "num_boxes")
NMS = dict(score_threshold=0.05, iou_threshold=0.5, max_boxes=30,
           num_candidates=96, pre_nms_top_k=24)


def cfgs(**kw):
    return JaxNMSConfig(**{**NMS, **kw}), NMSConfig(**{**NMS, **kw})


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x))


def assert_equal_dets(got, want, tol: float = 1e-6) -> None:
    """Labels and counts equal, scores and boxes within ``tol``."""
    g = {k: np.asarray(getattr(got, k)) for k in DET_KEYS}
    w = {k: np.asarray(getattr(want, k)) for k in DET_KEYS}
    np.testing.assert_array_equal(g["num_boxes"], w["num_boxes"])
    np.testing.assert_array_equal(g["labels"], w["labels"])
    np.testing.assert_allclose(g["scores"], w["scores"], atol=tol, rtol=0)
    np.testing.assert_allclose(g["boxes"], w["boxes"], atol=tol, rtol=0)
    assert int(g["num_boxes"].sum()) > 0


def random_anchors(rng, a: int) -> np.ndarray:
    lo = rng.uniform(0, 0.8, (a, 2))
    return np.concatenate([lo, lo + rng.uniform(0.05, 0.2, (a, 2))],
                          -1).astype(np.float32)


def raw_levels(rng, n: int, sizes, k: int, c: int, live: float):
    """Per-level NHWC maps; about ``live`` of the class logits over the
    threshold (logit -2.94)."""
    levels = []
    for h, w in sizes:
        cls = rng.normal(-6.0, 1.0, (n, h, w, k * c))
        hot = rng.uniform(size=cls.shape) < live
        cls = np.where(hot, rng.normal(0.0, 1.5, cls.shape), cls)
        box = rng.normal(0.0, 0.5, (n, h, w, k * 4))
        levels.append((cls.astype(np.float32), box.astype(np.float32)))
    return levels


def flat(levels, c: int):
    n = levels[0][0].shape[0]
    return (np.concatenate([cl.reshape(n, -1, c) for cl, _ in levels], 1),
            np.concatenate([b.reshape(n, -1, 4) for _, b in levels], 1))


SIZES = [(8, 8), (4, 4), (2, 2), (1, 1)]


@pytest.mark.parametrize("live", [0.0005, 0.01, 0.2])
def test_select_anchors_matches(live):
    """Few live anchors (``live`` 0.0005: fewer than Q pass the threshold)
    make the -inf order decide the rest of the picks."""
    rng = np.random.default_rng(1)
    k, c = 9, 5
    levels = raw_levels(rng, 2, SIZES, k, c, live)
    logits, deltas = flat(levels, c)
    anchors = random_anchors(rng, logits.shape[1])
    jcfg, cfg = cfgs()
    jb, js = jax_post.select_candidates(jnp.asarray(logits),
                                       jnp.asarray(deltas),
                                       jnp.asarray(anchors), jcfg)
    pb, ps = postprocess.select_candidates(_t(logits), _t(deltas),
                                           _t(anchors), cfg)
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), atol=1e-6)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-6)
    if live < 0.001:  # sub-threshold picks keep their (small) scores
        assert (ps.amax(-1) < 0.05).any() and (ps > 0).all()
    want = jax_post.postprocess_detections(
        jnp.asarray(logits), jnp.asarray(deltas), jnp.asarray(anchors), jcfg)
    got = postprocess.postprocess_detections(_t(logits), _t(deltas),
                                             _t(anchors), cfg)
    assert_equal_dets(got, want)


@pytest.mark.parametrize("live", [0.0005, 0.01, 0.2])
def test_select_pyramid_matches(live):
    rng = np.random.default_rng(2)
    k, c = 9, 5
    levels = raw_levels(rng, 2, SIZES, k, c, live)
    anchors = random_anchors(rng, sum(h * w * k for h, w in SIZES))
    jcfg, cfg = cfgs()
    jlev = [(jnp.asarray(a), jnp.asarray(b)) for a, b in levels]
    plev = [(_t(a), _t(b)) for a, b in levels]
    jb, js = jax_post.select_candidates_pyramid(jlev, jnp.asarray(anchors),
                                               c, jcfg)
    pb, ps = postprocess.select_candidates_pyramid(plev, _t(anchors), c, cfg)
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), atol=1e-6)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-6)
    if live < 0.001:  # sub-threshold picks are zeroed here
        assert (ps == 0).all(-1).any()
    want = jax_post.postprocess_pyramid(jlev, jnp.asarray(anchors), c, jcfg)
    got = postprocess.postprocess_pyramid(plev, _t(anchors), c, cfg)
    assert_equal_dets(got, want)
    # the same anchors as the flat selection, read from the level maps
    logits, deltas = flat(levels, c)
    fb, _ = postprocess.select_candidates(_t(logits), _t(deltas),
                                          _t(anchors), cfg)
    np.testing.assert_array_equal(pb.numpy(), fb.numpy())


def _head_params(rng, ch: int, k: int, c: int):
    return {"class_net": {"predict": {
                "kernel": rng.normal(0, 0.3, (1, 1, ch, k * c)).astype(
                    np.float32),
                "bias": rng.normal(-2.0, 0.5, k * c).astype(np.float32)}},
            "box_net": {"predict": {
                "kernel": rng.normal(0, 0.1, (1, 1, ch, k * 4)).astype(
                    np.float32),
                "bias": rng.normal(0, 0.1, k * 4).astype(np.float32)}}}


def _port_head(params: dict, ch: int, k: int, c: int) -> RetinaHead:
    head = RetinaHead(ch, c, k, depth=0, channels=ch, final_kernel=1)
    with torch.no_grad():
        for net in ("class_net", "box_net"):
            conv = getattr(head, net).predict
            p = params[net]["predict"]
            conv.weight.copy_(_t(p["kernel"].transpose(3, 2, 0, 1)))
            conv.bias.copy_(_t(p["bias"]))
    return head


@pytest.mark.parametrize("method", ["hard", "soft_linear"])
def test_fused_head_matches_jax(method):
    """The bf16 x bf16 product with an f32 result (JAX's
    ``preferred_element_type``), the top-Q, the f32 recompute and NMS, on
    the same trunks and 1x1 kernels."""
    rng = np.random.default_rng(3)
    n, cells, ch, k, c = 2, 85, 16, 9, 6
    cls_t = rng.normal(0, 1, (n, cells, ch)).astype(np.float32)
    box_t = rng.normal(0, 1, (n, cells, ch)).astype(np.float32)
    params = _head_params(rng, ch, k, c)
    anchors = random_anchors(rng, cells * k)
    jcfg, cfg = cfgs(method=method)
    jmax = jax_fused_head.fused_logit_max(
        jnp.asarray(cls_t),
        jnp.asarray(params["class_net"]["predict"]["kernel"].reshape(ch, -1)),
        jnp.asarray(params["class_net"]["predict"]["bias"]), k)
    head = _port_head(params, ch, k, c)
    w_cls, b_cls, _, _ = fused_head.predict_params(head)
    pmax = fused_head.fused_logit_max(_t(cls_t), w_cls, b_cls, k)
    np.testing.assert_allclose(pmax.numpy(), np.asarray(jmax), atol=2e-6,
                               rtol=1e-6)
    want = jax_fused_head.fused_head_detections(
        jnp.asarray(cls_t), jnp.asarray(box_t), params, jnp.asarray(anchors),
        c, k, jcfg, interpret=True)
    got = fused_head.fused_head_detections(_t(cls_t), _t(box_t), head,
                                           _t(anchors), c, k, cfg)
    assert_equal_dets(got, want)


def test_fused_logit_max_rounds_operands_to_bf16():
    """The f32 result of bf16-rounded operands, not an f32 product."""
    rng = np.random.default_rng(4)
    trunk = torch.from_numpy(rng.normal(0, 1, (1, 40, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.3, (16, 18)).astype(np.float32))
    b = torch.zeros(18)
    got = fused_head.fused_logit_max(trunk, w, b, 3)
    exact = (trunk.reshape(40, 16) @ w).reshape(120, 6).amax(1)
    rounded = (trunk.to(torch.bfloat16).double().reshape(40, 16)
               @ w.to(torch.bfloat16).double()).reshape(120, 6).amax(1)
    np.testing.assert_allclose(got.reshape(-1).numpy(), rounded.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert (got.reshape(-1) - exact).abs().max() > 1e-4


@pytest.mark.parametrize("gaussian", [False, True], ids=["linear",
                                                          "gaussian"])
@pytest.mark.parametrize("scene", ["random", "crowded"])
def test_soft_nms_matches(gaussian, scene):
    method = "soft_gaussian" if gaussian else "soft_linear"
    rng = np.random.default_rng(5)
    if scene == "random":
        n, q, c = 2, 64, 4
        boxes = random_anchors(rng, n * q).reshape(n, q, 4)
        scores = rng.uniform(0, 1, (n, q, c)).astype(np.float32)
        jcfg, cfg = cfgs(method=method)
    else:  # near-duplicates of a few objects, as in test_soft_nms.py
        k = 40
        centers = rng.uniform(0.2, 0.8, (5, 2))
        obj = rng.integers(0, 5, k)
        jitter = rng.normal(0, 0.02, (k, 2))
        lo = centers[obj] - 0.1 + jitter
        boxes = np.concatenate([lo, lo + 0.2], -1).astype(
            np.float32)[None]
        scores = rng.uniform(0.3, 1.0, (1, k, 2)).astype(np.float32)
        jcfg, cfg = cfgs(method=method, score_threshold=0.1, max_boxes=40,
                         pre_nms_top_k=k)
    want = jax_nms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores), jcfg)
    nms_cuda.launches = 0
    got = postprocess.run_nms(_t(boxes), _t(scores), cfg)
    assert nms_cuda.launches == 0
    assert_equal_dets(got, want)
    if scene == "crowded":  # the duplicates decay, not vanish
        hard = nms.batched_nms(_t(boxes), _t(scores),
                               dataclasses.replace(cfg, method="hard"))
        assert int(got.num_boxes.sum()) > int(hard.num_boxes.sum())


# ------------------------------------------------------------------ predict

PREDICT_CASES = {
    "mobilenet_v2": dict(backbone="mobilenet_v2", width_multiplier=0.25),
    "efficientnet_lite": dict(backbone="efficientnet_lite",
                              width_multiplier=0.25),
    "shufflenet": dict(backbone="shufflenet", width_multiplier=0.5),
    "resnet50": dict(backbone="resnet50", width_multiplier=1.0),
    "anchors": dict(backbone="mobilenet", width_multiplier=0.25,
                    stem_schedule="dense4"),
    "fused_head": dict(backbone="mobilenet", width_multiplier=0.25,
                       stem_schedule="dense4", head_final_kernel=1),
    "soft_linear": dict(backbone="mobilenet", width_multiplier=0.25,
                        stem_schedule="dense4"),
    "soft_gaussian": dict(backbone="mobilenet", width_multiplier=0.25,
                          stem_schedule="dense4"),
}
PREDICT_NMS = {"anchors": dict(select="anchors"),
               "soft_linear": dict(method="soft_linear"),
               "soft_gaussian": dict(method="soft_gaussian")}


@pytest.mark.parametrize("name", list(PREDICT_CASES))
def test_detector_predict_matches_jax(name):
    nms_kw = dict(NMS, **PREDICT_NMS.get(name, {}))
    jcfg, cfg = configs(PREDICT_CASES[name], nms=nms_kw)
    abstract = jax.eval_shape(
        lambda: JaxDetector(jcfg).init(jax.random.PRNGKey(0)))
    variables = seeded_variables(abstract, 11, class_bias=-2.0)
    images = np.random.default_rng(12).integers(0, 256, (2, 64, 64, 3)
                                               ).astype(np.uint8)
    jdet = JaxDetector(jcfg)
    want = jax.jit(jdet.predict)(variables, images)
    det = Detector(cfg, convert_variables(variables, cfg), device="cpu")
    nms_cuda.launches = 0
    got = det.predict(images)
    assert nms_cuda.launches == 0  # CPU tensors: the plain version
    assert int(got.num_boxes.min()) > 0
    assert_set_match({k: getattr(got, k).numpy() for k in DET_KEYS},
                     {k: np.asarray(getattr(want, k)) for k in DET_KEYS})


def test_fused_head_matches_unfused_detections():
    """The port's fused head against its own flat path on the same 1x1
    weights (tie-free inputs): the same detections within 5e-3, as
    ``tests/test_fused_head.py`` holds JAX's."""
    jcfg, cfg = configs(PREDICT_CASES["fused_head"], nms=NMS)
    abstract = jax.eval_shape(
        lambda: JaxDetector(jcfg).init(jax.random.PRNGKey(0)))
    state = convert_variables(seeded_variables(abstract, 13, class_bias=-2.0),
                              cfg)
    images = np.random.default_rng(14).integers(0, 256, (2, 64, 64, 3)
                                               ).astype(np.uint8)
    fused = Detector(cfg, state, device="cpu").predict(images)
    flat_cfg = dataclasses.replace(cfg, nms=dataclasses.replace(
        cfg.nms, select="anchors"))
    det = Detector(flat_cfg, state, device="cpu")
    logits, deltas = (t for t in postprocess_flat(det, images))
    unfused = postprocess.postprocess_detections(logits, deltas, det.anchors,
                                                 cfg.nms)
    np.testing.assert_array_equal(fused.num_boxes, unfused.num_boxes)
    nb = int(unfused.num_boxes.max())
    assert nb > 0
    np.testing.assert_array_equal(fused.labels[:, :nb],
                                  unfused.labels[:, :nb])
    np.testing.assert_allclose(fused.scores[:, :nb], unfused.scores[:, :nb],
                               atol=5e-3)
    np.testing.assert_allclose(fused.boxes[:, :nb], unfused.boxes[:, :nb],
                               atol=5e-3)


def postprocess_flat(det: Detector, images):
    from ssd_tpu_torch.models.fpn import flatten_levels
    return flatten_levels(det.raw(images), det.cfg.num_classes)
