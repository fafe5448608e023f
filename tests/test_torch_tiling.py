"""Tiled inference and its merge against the JAX package on the CPU.

* ``box_utils.ios`` and ``greedy_suppression_mask(metric="ios" | "iou")``
  bit-equal to JAX's jitted ones;
* ``tile_origins`` and ``TileGrid`` (origins, crops, ``to_global``,
  ``interior_edge_mask``) equal to JAX's on grids from a 4K frame to an
  image smaller than a tile;
* ``merge_nms`` bit-equal to JAX's jitted ``_merge_nms`` on adversarial
  candidate sets (tied scores, tile fragments, empty, fewer candidates than
  ``max_boxes``, a crowded random set), with both metrics, and batched
  equal to per image;
* ``TiledPredictor`` on a 64 px f32 model and a 200 x 208 image (3x the
  model size, 17 passes, bucket 32): the port's merge of JAX's own per-tile
  detections bit-equal to JAX's ``TiledPredictor``, and the port end to end
  equal to JAX's under the golden set rule; the predictor CLI's
  ``--tiled``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ssd_tpu import tiling as jax_tiling
from ssd_tpu.config import Config as JaxConfig
from ssd_tpu.models.detector import Detector as JaxDetector
from ssd_tpu.ops import box_utils as jax_box_utils
from ssd_tpu.ops import nms as jax_nms
from ssd_tpu.predictor import Predictor as JaxPredictor
from ssd_tpu_torch import tiling
from ssd_tpu_torch.config import Config
from ssd_tpu_torch.convert import (convert_variables, label_map_array,
                                   save_npz_artifact)
from ssd_tpu_torch.data import synthetic
from ssd_tpu_torch.ops import box_utils, nms
from ssd_tpu_torch.predictor import Predictor
from ssd_tpu_torch.predictor import main as predictor_main
from tests.test_torch_model import seeded_variables
from tests.test_torch_slice import assert_set_match

TORCH_THREADS = 1
DET_KEYS = ("boxes", "scores", "labels", "num_boxes")
MODEL = dict(num_classes=3, image_size=64,
             model=dict(backbone="mobilenet", width_multiplier=0.25,
                        fpn_channels=16, head_depth=1,
                        compute_dtype="float32"),
             nms=dict(max_boxes=8, num_candidates=64, pre_nms_top_k=32))
LABELS = {0: "cat", 1: "dog", 2: "cow"}


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)


def random_boxes(rng, n: int, lo: float = 0.0, hi: float = 1.0):
    """Corner-form boxes; a few degenerate (zero area) and inverted."""
    a = rng.uniform(lo, hi, (n, 2)).astype(np.float32)
    size = rng.uniform(0.0, 0.4, (n, 2)).astype(np.float32)
    boxes = np.concatenate([a, np.minimum(a + size, hi)], axis=1)
    boxes[::7, 2] = boxes[::7, 0]  # zero height
    return boxes


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_ios_matches_jax():
    rng = np.random.default_rng(0)
    b1 = random_boxes(rng, 70)
    b2 = np.concatenate([random_boxes(rng, 20), b1[:10] * 0.5 + 0.1,
                         b1[10:15]])  # contained, identical
    want = np.asarray(jax.jit(jax_box_utils.ios)(b1, b2))
    got = box_utils.ios(_t(b1), _t(b2)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want == 1.0).sum() >= 5 and (want == 0.0).any()
    batched = box_utils.ios(_t(np.stack([b1, b1])), _t(np.stack([b2, b2])))
    assert torch.equal(batched[1], torch.from_numpy(got))


@pytest.mark.parametrize("metric", ["iou", "ios"])
def test_greedy_suppression_mask_matches_jax(metric):
    rng = np.random.default_rng(1)
    boxes = np.stack([random_boxes(rng, 60) for _ in range(3)])
    boxes[0, 30:] = boxes[0, :30]  # duplicates
    valid = rng.uniform(size=(3, 60)) > 0.2
    want = np.asarray(jax.jit(
        jax_nms.greedy_suppression_mask, static_argnames=("metric",))(
        boxes, valid, jnp.float32(0.45), metric=metric))
    got = nms.greedy_suppression_mask(_t(boxes), _t(valid), 0.45,
                                      metric=metric).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum()


GRIDS = {
    "4k": ((2160, 3840), (640, 640), 0.25),
    "smaller_than_tile": ((100, 50), (64, 64), 0.25),
    "one_over": ((130, 64), (64, 64), 0.5),
    "exact": ((64, 128), (64, 64), 0.0),
    "dense": ((200, 208), (64, 64), 0.9),
    "rect_tile": ((300, 500), (96, 128), 0.3),
}


@pytest.mark.parametrize("case", sorted(GRIDS))
def test_tile_grid_matches_jax(case):
    image_hw, tile_hw, overlap = GRIDS[case]
    for dim, tile in zip(image_hw, tile_hw):
        assert tiling.tile_origins(dim, tile, overlap) == \
            jax_tiling.tile_origins(dim, tile, overlap)
    want = jax_tiling.TileGrid.build(image_hw, tile_hw, overlap)
    got = tiling.TileGrid.build(image_hw, tile_hw, overlap)
    assert got.origins == want.origins and got.tile_hw == want.tile_hw
    if case == "4k":
        assert len(got.origins) == 40
    rng = np.random.default_rng(len(got.origins))
    if image_hw[0] * image_hw[1] < 1 << 18:
        image = rng.integers(0, 256, (*image_hw, 3), dtype=np.uint8)
        np.testing.assert_array_equal(got.crops(image), want.crops(image))
    boxes = random_boxes(rng, 40)
    boxes[:4] = [[0.0, 0.2, 0.5, 0.6], [0.3, 0.0, 0.9, 0.4],
                 [0.2, 0.3, 1.0, 0.5], [0.1, 0.1, 0.3, 1.0]]  # edge touches
    for i in range(len(got.origins)):
        np.testing.assert_array_equal(got.to_global(i, boxes),
                                      want.to_global(i, boxes))
        np.testing.assert_array_equal(got.interior_edge_mask(i, boxes),
                                      want.interior_edge_mask(i, boxes))


def merge_case(name: str):
    """(boxes, scores, labels, max_boxes) of one adversarial set."""
    rng = np.random.default_rng(sorted(MERGE_CASES).index(name))
    if name == "ties":
        base = random_boxes(rng, 6)
        boxes = np.concatenate([base, base, base[::-1]])
        scores = np.full(18, 0.5, np.float32)
        scores[::4] = 0.75
        labels = np.tile([0, 1, 0], 6)
        return boxes, scores, labels, 10
    if name == "fragments":  # a whole box, its halves and quarters, per tile
        whole = np.array([[0.2, 0.2, 0.6, 0.6]], np.float32)
        parts = [[0.2, 0.2, 0.6, 0.4], [0.2, 0.4, 0.6, 0.6],
                 [0.2, 0.2, 0.4, 0.4], [0.25, 0.25, 0.55, 0.55]]
        boxes = np.concatenate([whole, np.asarray(parts, np.float32),
                                random_boxes(rng, 5)])
        scores = np.array([0.6, 0.9, 0.85, 0.7, 0.65, 0.3, 0.2, 0.5, 0.4,
                           0.1], np.float32)
        labels = np.array([2, 2, 2, 2, 2, 0, 1, 2, 0, 1])
        return boxes, scores, labels, 8
    if name == "empty":
        return (random_boxes(rng, 12), np.zeros(12, np.float32),
                np.zeros(12, np.int64), 8)
    if name == "few":  # fewer candidates than max_boxes, two padded
        boxes = random_boxes(rng, 5)
        scores = np.array([0.3, 0.0, 0.8, 0.3, 0.0], np.float32)
        return boxes, scores, np.array([1, 0, 1, 1, 2]), 8
    boxes = random_boxes(rng, 300)  # crowded: a 4K tile set's density
    boxes[100:200] = boxes[:100] + rng.uniform(
        -0.01, 0.01, (100, 4)).astype(np.float32)
    scores = rng.uniform(0.0, 1.0, 300).astype(np.float32)
    scores[rng.uniform(size=300) < 0.2] = 0.0
    return boxes, scores, rng.integers(0, 3, 300), 50


MERGE_CASES = ("ties", "fragments", "empty", "few", "crowded")


@pytest.mark.parametrize("metric", ["ios", "iou"])
@pytest.mark.parametrize("case", MERGE_CASES)
def test_merge_nms_matches_jax(case, metric):
    boxes, scores, labels, m = merge_case(case)
    want = jax_tiling._merge_nms(
        jnp.asarray(boxes), jnp.asarray(scores),
        jnp.asarray(labels, jnp.int32), jnp.float32(0.5),
        jnp.zeros((m,), jnp.float32), metric=metric)
    got = tiling.merge_nms(_t(boxes), _t(scores), _t(labels), 0.5, m,
                           metric=metric)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape == (m, 4) and got[2].dtype == torch.int32
    # a batch of two images: each row is that image's merge
    batched = tiling.merge_nms(_t(np.stack([boxes, boxes[::-1]])),
                               _t(np.stack([scores, scores[::-1]])),
                               _t(np.stack([labels, labels[::-1]])), 0.5, m,
                               metric=metric)
    for g, b in zip(got, batched):
        assert torch.equal(b[0], g)


def test_merge_metrics_differ_on_fragments():
    boxes, scores, labels, m = merge_case("fragments")
    ios = tiling.merge_nms(_t(boxes), _t(scores), _t(labels), 0.5, m)
    iou = tiling.merge_nms(_t(boxes), _t(scores), _t(labels), 0.5, m,
                           metric="iou")
    assert int(ios[3]) < int(iou[3])  # IoS drops the fragments IoU keeps


# ------------------------------------------------------------- predictor

@pytest.fixture(scope="module")
def predictors():
    jcfg = JaxConfig.from_dict(MODEL)
    abstract = jax.eval_shape(
        lambda: JaxDetector(jcfg).init(jax.random.PRNGKey(0)))
    variables = seeded_variables(abstract, seed=11, class_bias=-1.0)
    cfg = Config.from_dict(MODEL)
    return (JaxPredictor(jcfg, variables, label_map=LABELS),
            Predictor(cfg, convert_variables(variables, cfg),
                      label_map=LABELS, device="cpu"))


class Recording:
    """A predictor that passes through another's results and keeps them."""

    def __init__(self, inner):
        self.inner = inner
        self.cfg = inner.cfg
        self.device = torch.device("cpu")
        self.label_map = inner.label_map
        self.outs = []

    def predict(self, images):
        out = self.inner.predict(images)
        self.outs.append({k: np.asarray(out[k]) for k in DET_KEYS})
        return out


class Replay:
    """A predictor that returns recorded results."""

    def __init__(self, cfg, outs):
        self.cfg = cfg
        self.device = torch.device("cpu")
        self.label_map = LABELS
        self.outs = list(outs)

    def predict(self, images):
        return self.outs.pop(0)


def big_image(seed: int, hw=(200, 208)) -> np.ndarray:
    """A scene of sanity objects on a frame 3x the model size."""
    rng = np.random.default_rng(seed)
    image = np.array(Image.fromarray(synthetic.sanity_scene(rng)[0]).resize(
        hw[::-1], Image.BILINEAR))
    image[:90, :100] = np.asarray(Image.fromarray(
        synthetic.sanity_scene(rng)[0]).resize((100, 90), Image.BILINEAR))
    return image


@pytest.mark.parametrize("edge_penalty", [0.5, 0.0])
def test_tiled_predictor_matches_jax(predictors, edge_penalty):
    jpred, pred = predictors
    image = big_image(3)
    recorder = Recording(jpred)
    want = jax_tiling.TiledPredictor(recorder, edge_penalty=edge_penalty
                                     ).predict(image)
    assert len(recorder.outs[0]["num_boxes"]) == 17  # 16 tiles + full
    # the port's merge of JAX's own per-tile detections: bit-equal
    replay = tiling.TiledPredictor(Replay(pred.cfg, recorder.outs),
                                   edge_penalty=edge_penalty)
    got = replay.predict(image)
    for k in DET_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["names"], want["names"])
    # end to end: the port's own tiles (f32) under the golden set rule
    tiler = tiling.TiledPredictor(pred, edge_penalty=edge_penalty)
    port = tiler.predict(image)
    assert port["num_boxes"] > 0 and port["boxes"].shape == (8, 4)
    assert_set_match({k: np.asarray(port[k])[None] for k in DET_KEYS},
                     {k: np.asarray(want[k])[None] for k in DET_KEYS})
    assert tiler.grid_for(image.shape[:2]) == tiling.TileGrid.build(
        image.shape[:2], (64, 64), 0.25)


def test_predictor_cli_tiled(predictors, tmp_path, capsys):
    _, pred = predictors
    npz = str(tmp_path / "m.npz")
    save_npz_artifact(npz, pred.cfg, pred.detector.model.state_dict(),
                      label_map=label_map_array(LABELS))
    image = big_image(4)
    path = str(tmp_path / "big.png")
    Image.fromarray(image).save(path)
    predictor_main(["--npz", npz, "--images", path, "--tiled",
                    "--score-threshold", "0", "--device", "cpu"])
    rows = json.loads(capsys.readouterr().out)[0]["detections"]
    want = tiling.TiledPredictor(pred).predict(image)
    assert len(rows) == int(want["num_boxes"]) > 0
    assert [r["label"] for r in rows] == list(want["labels"][:len(rows)])
    assert rows[0]["name"] == LABELS[rows[0]["label"]]
    with pytest.raises(SystemExit):
        predictor_main(["--npz", npz, "--images", path, "--tiled", "--tta",
                        "--device", "cpu"])
    assert "mutually exclusive" in capsys.readouterr().err
