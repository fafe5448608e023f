"""Weighted box fusion, flip TTA, ensembles, the daemon's ``--tta`` and the
eval CLI against the JAX package on the CPU.

* ``weighted_box_fusion`` bit-equal to JAX's jitted one (clusters, tied
  scores, padding, fewer candidates than ``max_boxes``, an empty set, a
  crowded one) with ``num_views`` 1, 2 and 3, and batched equal to per
  image. XLA:CPU contracts the running sum ``wsum + score * box`` into a
  fused multiply-add, which the port rounds once as well;
* ``TTAPredictor`` (WBF and NMS merges), ``EnsemblePredictor`` and TTA
  over an ensemble on a 64 px f32 model: the port's fusion of JAX's own
  view detections bit-equal to JAX's predictors, and the port end to end
  equal to them under the golden set rule;
* the daemon with ``--tta`` equal to the direct call (``scan_depth`` 1);
* ``python -m ssd_tpu_torch.eval`` on the sanity scenes' shard
  (``assets/eval_golden_v1.npz``) in f32: without ``--tta`` JAX's stored
  numbers to 1e-6, with ``--tta`` JAX's own CLI's printed table to its
  last printed digit; ``--dump-coco`` and ``--limit``.
"""

import io
import json
import os
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ssd_tpu import tta as jax_tta
from ssd_tpu.config import Config as JaxConfig
from ssd_tpu.eval import __main__ as jax_eval_cli
from ssd_tpu.models.detector import Detector as JaxDetector
from ssd_tpu.ops import wbf as jax_wbf
from ssd_tpu.predictor import Predictor as JaxPredictor
from ssd_tpu_torch import serve, tta
from ssd_tpu_torch.config import Config
from ssd_tpu_torch.convert import convert_variables
from ssd_tpu_torch.data import native, synthetic
from ssd_tpu_torch.eval import __main__ as eval_cli
from ssd_tpu_torch.eval import sanity
from ssd_tpu_torch.ops.wbf import weighted_box_fusion
from ssd_tpu_torch.predictor import Predictor
from tests.test_torch_model import seeded_variables
from tests.test_torch_slice import assert_set_match
from tests.test_torch_tiling import (LABELS, MODEL, Recording, Replay,
                                     random_boxes)
from tests.test_torch_train_loop import EVAL_ASSET, EVAL_KEYS

TORCH_THREADS = 1
DET_KEYS = ("boxes", "scores", "labels", "num_boxes")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SANITY_ARTIFACT = os.path.join(ROOT, "bench_assets", "sanity_artifact")


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a))


WBF_CASES = ("clusters", "ties", "padding", "few", "empty", "crowded")


def wbf_case(name: str):
    """(boxes, scores, labels, max_boxes, threshold) of one set."""
    rng = np.random.default_rng(WBF_CASES.index(name) + 10)
    if name == "clusters":  # jittered views of six objects, two classes
        base = random_boxes(rng, 6, 0.1, 0.8)
        boxes = np.concatenate([base + rng.normal(0, 0.01, base.shape)
                                for _ in range(4)]).astype(np.float32)
        scores = rng.uniform(0.3, 0.95, 24).astype(np.float32)
        return boxes, scores, np.tile([0, 1, 1, 0, 1, 0], 4), 16, 0.55
    if name == "ties":  # equal scores, equal boxes across classes
        base = random_boxes(rng, 5)
        boxes = np.concatenate([base, base, base])
        scores = np.full(15, 0.5, np.float32)
        scores[3::5] = 0.25
        return boxes, scores, np.repeat([0, 1, 0], 5), 12, 0.5
    if name == "padding":  # two views' padded outputs, zeros past num
        boxes = random_boxes(rng, 16)
        boxes[5:8] = 0.0
        boxes[13:] = 0.0
        scores = np.concatenate([rng.uniform(0.2, 0.9, 5), np.zeros(3),
                                 rng.uniform(0.2, 0.9, 5), np.zeros(3)])
        labels = np.where(scores > 0, rng.integers(0, 3, 16), -1)
        return boxes, scores.astype(np.float32), labels, 8, 0.5
    if name == "few":
        return (random_boxes(rng, 3), np.array([0.4, 0.9, 0.0], np.float32),
                np.array([2, 2, 1]), 8, 0.5)
    if name == "empty":
        return (random_boxes(rng, 10), np.zeros(10, np.float32),
                np.full(10, -1), 6, 0.5)
    boxes = random_boxes(rng, 200, 0.0, 1.0)  # crowded
    boxes[100:] = boxes[:100] + rng.normal(0, 0.02, (100, 4)).astype(
        np.float32)
    scores = rng.uniform(0.0, 1.0, 200).astype(np.float32)
    scores[::9] = 0.0
    return boxes, scores, rng.integers(0, 4, 200), 100, 0.55


@pytest.mark.parametrize("views", [1, 2, 3])
@pytest.mark.parametrize("case", WBF_CASES)
def test_wbf_matches_jax(case, views):
    boxes, scores, labels, m, thr = wbf_case(case)
    want = jax_wbf.weighted_box_fusion(
        jnp.asarray(boxes), jnp.asarray(scores),
        jnp.asarray(labels, jnp.int32), jnp.float32(thr),
        jnp.zeros((m,), jnp.float32), num_views=views)
    got = weighted_box_fusion(_t(boxes), _t(scores), _t(labels), thr, m,
                              num_views=views)
    for name, g, w in zip(("boxes", "scores", "labels", "count"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert got[0].shape == (m, 4) and got[2].dtype == torch.int32
    batched = weighted_box_fusion(
        _t(np.stack([boxes[::-1], boxes])), _t(np.stack([scores[::-1],
                                                          scores])),
        _t(np.stack([labels[::-1], labels])), thr, m, num_views=views)
    for g, b in zip(got, batched):
        assert torch.equal(b[1], g)


def test_running_sum_rounds_once_as_jitted_jax():
    """WBF's running sum ``wsum + score * box``: XLA:CPU contracts it into
    one fused multiply-add under ``jax.jit`` (op by op it rounds twice);
    the port's f64 form rounds once, as the jitted program does."""
    rng = np.random.default_rng(3)
    wsum = rng.uniform(0.0, 3.0, (500, 4)).astype(np.float32)
    score = rng.uniform(0.0, 1.0, (500, 1)).astype(np.float32)
    box = random_boxes(rng, 500)
    onehot = np.ones(500, np.float32)
    jitted = np.asarray(jax.jit(
        lambda w, s, b, o: w + (o[:, None] * s) * b)(wsum, score, box,
                                                     onehot))
    twice = wsum + score * box  # numpy: two roundings
    once = (wsum.astype(np.float64) + score.astype(np.float64)
            * box.astype(np.float64)).astype(np.float32)
    share = float((jitted != twice).mean())
    print(f"jitted sum vs two roundings: {share:.4f} of values differ")
    assert share > 0.01
    np.testing.assert_array_equal(once, jitted)


# ------------------------------------------------------------- predictors

def _variables(seed: int):
    jcfg = JaxConfig.from_dict(MODEL)
    abstract = jax.eval_shape(
        lambda: JaxDetector(jcfg).init(jax.random.PRNGKey(0)))
    return jcfg, seeded_variables(abstract, seed=seed, class_bias=-1.0)


@pytest.fixture(scope="module")
def predictors():
    """(JAX predictor, port predictor) pairs on two seeded weight sets."""
    cfg = Config.from_dict(MODEL)
    pairs = []
    for seed in (11, 12):
        jcfg, variables = _variables(seed)
        pairs.append((JaxPredictor(jcfg, variables, label_map=LABELS),
                      Predictor(cfg, convert_variables(variables, cfg),
                                label_map=LABELS, device="cpu")))
    return pairs


def scenes(n: int, seed: int) -> np.ndarray:
    return next(synthetic.sanity_batches(n, seed, batch=n))[0]


def _as_batch(out: dict) -> dict:
    return {k: np.asarray(out[k]) for k in DET_KEYS}


class ReplayDispatch(Replay):
    """``Replay`` with the dispatch/collect split ``TTAPredictor`` uses."""

    def predict_dispatch(self, images):
        return {"images": images}

    def predict_collect(self, handle):
        return self.predict(handle["images"])


@pytest.mark.parametrize("merge", ["wbf", "nms"])
def test_tta_predictor_matches_jax(predictors, merge):
    jpred, pred = predictors[0]
    images = np.asarray(
        [np.asarray(Image.fromarray(im).resize((64, 64), Image.BILINEAR))
         for im in scenes(2, 5)])
    recorder = Recording(jpred)
    want = jax_tta.TTAPredictor(recorder, merge=merge).predict(images)
    assert len(recorder.outs[0]["num_boxes"]) == 4  # two views of two
    got = tta.TTAPredictor(ReplayDispatch(pred.cfg, recorder.outs),
                           merge=merge).predict(images)
    for k in DET_KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(got["names"], want["names"])
    port = tta.TTAPredictor(pred, merge=merge)
    end = port.predict(images)
    assert end["boxes"].shape == (2, 8, 4) and end["num_boxes"].min() > 0
    assert_set_match(end, _as_batch(want))
    single = port.predict(images[0])
    for k in DET_KEYS:
        np.testing.assert_array_equal(single[k], end[k][0])
    assert port._bucket_for(3) == 8


def test_ensemble_matches_jax(predictors):
    (j1, p1), (j2, p2) = predictors
    images = list(scenes(2, 6))
    recs = [Recording(j1), Recording(j2)]
    want = jax_tta.EnsemblePredictor(recs, weights=[1.0, 0.7]).predict(
        images)
    got = tta.EnsemblePredictor(
        [Replay(p1.cfg, r.outs) for r in recs], weights=[1.0, 0.7]
    ).predict(images)
    for k in DET_KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    end = tta.EnsemblePredictor([p1, p2], weights=[1.0, 0.7]).predict(images)
    assert end["num_boxes"].min() > 0
    assert_set_match(end, _as_batch(want))


def test_tta_over_ensemble_matches_jax(predictors):
    """TTA over a member without the dispatch/collect split (an ensemble):
    the doubled batch runs at dispatch, as JAX's ``TTAPredictor`` does."""
    (j1, p1), (j2, p2) = predictors
    images = np.asarray(
        [np.asarray(Image.fromarray(im).resize((64, 64), Image.BILINEAR))
         for im in scenes(2, 5)])
    want = jax_tta.TTAPredictor(
        jax_tta.EnsemblePredictor([j1, j2])).predict(images)
    member = tta.EnsemblePredictor([p1, p2])
    assert not hasattr(member, "predict_dispatch")
    got = tta.TTAPredictor(member).predict(images)
    assert got["boxes"].shape == (2, 8, 4) and got["num_boxes"].min() > 0
    assert_set_match(got, _as_batch(want))
    np.testing.assert_array_equal(got["names"][got["labels"] >= 0],
                                  [LABELS[x] for x in
                                   got["labels"][got["labels"] >= 0]])


def _jpeg(image: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def test_daemon_tta_equals_direct(predictors):
    _, pred = predictors[0]
    ttap = tta.TTAPredictor(pred)
    srv = serve.DetectionServer(ttap, host="127.0.0.1", port=0, max_batch=4,
                                max_wait_ms=20.0, default_score_threshold=0.0,
                                scan_depth=3)
    assert srv.dispatcher.scan_depth == 1  # no grouped dispatch under TTA
    srv.warmup()
    srv.start()
    try:
        for image in scenes(2, 7):
            body = _jpeg(image)
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/v1/detect", data=body,
                headers={"Content-Type": "image/jpeg"}, method="POST")
            with urllib.request.urlopen(req, timeout=60) as resp:
                dets = json.loads(resp.read())["detections"]
            direct = ttap.predict(native.decode_jpeg(body, 64, 64))
            n = int(direct["num_boxes"])
            assert len(dets) == n > 0
            for i, det in enumerate(dets):
                np.testing.assert_allclose(det["box_yxyx"],
                                           direct["boxes"][i], atol=5e-5)
                assert det["score"] == round(float(direct["scores"][i]), 4)
                assert det["label"] == int(direct["labels"][i])
                assert det["name"] == LABELS[det["label"]]
    finally:
        srv.stop()


# ------------------------------------------------------------- eval CLI

@pytest.fixture(scope="module")
def val_shard(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    with np.load(EVAL_ASSET, allow_pickle=False) as z:
        want = {k: float(z[f"jax/{k}"]) for k in EVAL_KEYS}
        z["shard"].tofile(str(root / "val-00000-of-00001.tfrecords"))
    return str(root / "val-*-of-*"), want


F32 = ["--set", "model.compute_dtype=float32"]


def test_eval_cli_gives_jax_numbers(val_shard, tmp_path, capsys):
    pattern, want = val_shard
    dump = str(tmp_path / "coco.json")
    got = eval_cli.main(["--npz", sanity.SANITY_NPZ, "--val-pattern",
                         pattern, "--batch-size", "12", "--device", "cpu",
                         "--dump-coco", dump, *F32])
    assert got["images"] == 32
    for k in EVAL_KEYS:
        assert got[k] == pytest.approx(want[k], abs=1e-6, nan_ok=True), k
    out = capsys.readouterr().out
    assert f"= {want['mAP']:.4f}" in out and "AP50[" in out
    with open(dump) as f:
        rows = json.load(f)
    assert rows and {"image_id", "category_id", "bbox", "score"} <= set(
        rows[0])
    limited = eval_cli.main(["--npz", sanity.SANITY_NPZ, "--val-pattern",
                             pattern, "--batch-size", "12", "--limit", "1",
                             "--device", "cpu", *F32])
    assert limited["images"] == 12


def _table(text: str) -> dict:
    """The printed ``label = value`` rows of an eval CLI."""
    rows = {}
    for line in text.splitlines():
        if " = " in line:
            label, _, value = line.strip().rpartition(" = ")
            rows[label] = float(value)
    return rows


def test_eval_cli_tta_matches_jax_cli(val_shard, monkeypatch, capsys):
    pattern, _ = val_shard
    monkeypatch.setattr(sys, "argv", [
        "ssd_tpu.eval", "--export", SANITY_ARTIFACT, "--val-pattern",
        pattern, "--batch-size", "12", "--tta", *F32])
    jax_eval_cli.main()
    want = _table(capsys.readouterr().out)
    eval_cli.main(["--npz", sanity.SANITY_NPZ, "--val-pattern", pattern,
                   "--batch-size", "12", "--tta", "--device", "cpu", *F32])
    got = _table(capsys.readouterr().out)
    assert len(want) > 12 and set(got) == set(want)
    assert want["AP @[.50:.95] | area=   all | maxDets=100"] > 0.1
    # printed to 4 decimals: one unit of the last printed digit
    for k, v in want.items():
        if np.isnan(v):  # no ground truth of this size
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - v) <= 1e-4 + 1e-9, (k, got[k], v)
