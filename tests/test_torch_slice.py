"""The port's serving path as a whole against the JAX package's, on the CPU.

* Full flagship width (MobileNet-v1 x1.0, FPN 128, head depth 4, 80
  classes) at 128 px, f32, seeded weights: raw head maps at the golden bars
  and detections under the golden set-matching rule.
* The committed sanity artifact (``bench_assets/sanity_artifact``, trained,
  8 classes), converted and served by ``Predictor(device="cpu")`` on its 32
  seed-derived val scenes: f32 detections set-equal to JAX's; bf16 mAP
  within 0.002 of JAX's, both scored here by the JAX package's evaluator.
* ``ssd_tpu_torch/assets/sanity_v1.npz``, the card's copy of that artifact
  with the scenes and JAX's detections, matches what ``regen`` writes:

      python tests/test_torch_slice.py regen
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

if __name__ == "__main__":  # regen: JAX on the CPU, as tests/conftest.py sets
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # for ``python tests/test_torch_slice.py regen``
    sys.path.insert(0, ROOT)

from ssd_tpu.config import Config as JaxConfig  # noqa: E402
from ssd_tpu.eval import sanity  # noqa: E402
from ssd_tpu.eval.coco_map import DetectionEvaluator  # noqa: E402
from ssd_tpu.export import load_inference_artifact  # noqa: E402
from ssd_tpu.models.detector import Detector as JaxDetector  # noqa: E402
from ssd_tpu_torch.config import Config  # noqa: E402
from ssd_tpu_torch.convert import (convert_variables,  # noqa: E402
                                   load_npz_artifact, save_npz_artifact)
from ssd_tpu_torch.models.detector import Detector  # noqa: E402
from ssd_tpu_torch.predictor import Predictor  # noqa: E402

ASSET = os.path.join(ROOT, "ssd_tpu_torch", "assets", "sanity_v1.npz")
FLAGSHIP = os.path.join(ROOT, "configs", "coco_mobilenet_640_flagship.json")
DET_KEYS = ("boxes", "scores", "labels", "num_boxes")


def _with_dtype(cfg, dtype: str):
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype=dtype))


def assert_set_match(got: dict, want: dict) -> None:
    """``tests/test_golden.py``'s rule: equal ``num_boxes``, and every wanted
    detection pairs one to one with a got one of the same label, score
    within 1e-3 and box within 1e-2."""
    np.testing.assert_array_equal(got["num_boxes"], want["num_boxes"])
    for i in range(len(want["num_boxes"])):
        nb = int(want["num_boxes"][i])
        used = set()
        for j in range(nb):
            found = next(
                (q for q in range(nb) if q not in used
                 and got["labels"][i, q] == want["labels"][i, j]
                 and abs(got["scores"][i, q] - want["scores"][i, j]) < 1e-3
                 and np.abs(got["boxes"][i, q]
                            - want["boxes"][i, j]).max() < 1e-2), None)
            assert found is not None, (
                f"image {i}: detection {j} (label {want['labels'][i, j]}, "
                f"score {want['scores'][i, j]:.4f}) has no match")
            used.add(found)


def _det_numpy(det) -> dict:
    return {k: np.asarray(getattr(det, k)) for k in DET_KEYS}


# ------------------------------------------------------ full flagship width

def test_flagship_full_width_matches_jax():
    from tests.test_torch_model import seeded_variables
    jcfg = _with_dtype(dataclasses.replace(JaxConfig.load(FLAGSHIP),
                                           image_size=128), "float32")
    cfg = _with_dtype(dataclasses.replace(Config.load(FLAGSHIP),
                                          image_size=128), "float32")
    jdet = JaxDetector(jcfg)
    abstract = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0)))
    # class-head bias -3 (sigmoid 0.047, just under the 0.05 threshold):
    # logits spread about it, so every class has live candidates for NMS
    variables = seeded_variables(abstract, seed=11, class_bias=-3.0)
    images = np.random.default_rng(5).integers(
        0, 256, (2, 128, 128, 3)).astype(np.uint8)

    want_raw = jdet.model.apply(variables, images, flatten=False,
                                raw_input=True)
    want = _det_numpy(jax.jit(jdet.predict)(variables, images))

    det = Detector(cfg, convert_variables(variables, cfg), device="cpu")
    got_raw = det.raw(images)
    for (gc, gb), (wc, wb) in zip(got_raw, want_raw):
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc),
                                   atol=2e-4, rtol=2e-3)
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb),
                                   atol=2e-4, rtol=2e-3)
    got = _det_numpy(det.predict(images))
    assert (want["num_boxes"] > 20).all()  # NMS had work to do
    assert_set_match(got, want)


# ------------------------------------------------------ sanity artifact

def _sanity_scenes():
    imgs, boxes, labels, nb = [], [], [], []
    for i, b, l, n, _ in sanity.sanity_batches(sanity.SANITY_VAL_IMAGES,
                                               sanity.SANITY_SEED_VAL):
        imgs.append(i)
        boxes.append(b)
        labels.append(l)
        nb.append(n)
    k = sanity.SANITY_VAL_IMAGES
    return (np.concatenate(imgs)[:k], np.concatenate(boxes)[:k],
            np.concatenate(labels)[:k], np.concatenate(nb)[:k])


def _jax_detections(jcfg, variables, images) -> dict:
    predict = jax.jit(JaxDetector(jcfg).predict)
    outs = [_det_numpy(predict(variables, images[i:i + 8]))
            for i in range(0, len(images), 8)]
    return {k: np.concatenate([o[k] for o in outs]) for k in DET_KEYS}


def sanity_asset_arrays() -> tuple[Config, dict, dict]:
    """-> (cfg, state, extra arrays) of ``sanity_v1.npz``."""
    jcfg, variables = load_inference_artifact(sanity.ARTIFACT_DIR)
    variables = jax.device_get(variables)
    cfg = Config.from_json(jcfg.to_json())
    state = convert_variables(variables, cfg)
    images, gt_boxes, gt_labels, gt_num = _sanity_scenes()
    extra = {"images": images, "gt_boxes": gt_boxes, "gt_labels": gt_labels,
             "gt_num_boxes": gt_num}
    for dtype in ("float32", "bfloat16"):
        det = _jax_detections(_with_dtype(jcfg, dtype), variables, images)
        tag = {"float32": "f32", "bfloat16": "bf16"}[dtype]
        extra.update({f"jax_{tag}_{k}": v for k, v in det.items()})
    return cfg, state, extra


@pytest.fixture(scope="module")
def sanity_asset():
    return sanity_asset_arrays()


def _map(num_classes, det, extra) -> float:
    ev = DetectionEvaluator(num_classes)
    ev.add_batch(det, extra["gt_boxes"], extra["gt_labels"],
                 extra["gt_num_boxes"])
    return float(ev.result()["mAP"])


def test_sanity_artifact_f32_detections_match_jax(sanity_asset):
    cfg, state, extra = sanity_asset
    pred = Predictor(_with_dtype(cfg, "float32"), state, device="cpu")
    got = pred.predict(extra["images"])
    assert_set_match(got, {k: extra[f"jax_f32_{k}"] for k in DET_KEYS})


def test_sanity_artifact_bf16_map_matches_jax(sanity_asset):
    cfg, state, extra = sanity_asset
    assert cfg.model.compute_dtype == "bfloat16"
    got = Predictor(cfg, state, device="cpu").predict(list(extra["images"]))
    port_map = _map(cfg.num_classes, got, extra)
    jax_map = _map(cfg.num_classes,
                   {k: extra[f"jax_bf16_{k}"] for k in DET_KEYS}, extra)
    assert jax_map > 0.1  # the trained artifact, not noise
    print(f"sanity bf16 mAP: port {port_map:.4f}, JAX {jax_map:.4f}")
    assert abs(port_map - jax_map) <= 0.002, (port_map, jax_map)


def test_committed_asset_matches_regen(sanity_asset):
    cfg, state, extra = sanity_asset
    got_cfg, got_state = load_npz_artifact(ASSET)
    assert got_cfg == cfg
    assert set(got_state) == set(state)
    for k, v in state.items():
        assert torch.equal(got_state[k], v), k
    with np.load(ASSET) as z:
        for k in ("images", "gt_boxes", "gt_labels", "gt_num_boxes"):
            np.testing.assert_array_equal(z[k], extra[k])
        # JAX's CPU detections may move in the last bits across CPUs
        for tag in ("f32", "bf16"):
            assert_set_match({k: z[f"jax_{tag}_{k}"] for k in DET_KEYS},
                             {k: extra[f"jax_{tag}_{k}"] for k in DET_KEYS})


if __name__ == "__main__":
    if sys.argv[1:] == ["regen"]:
        os.makedirs(os.path.dirname(ASSET), exist_ok=True)
        cfg, state, extra = sanity_asset_arrays()
        save_npz_artifact(ASSET, cfg, state, **extra)
        print(f"wrote {ASSET} ({os.path.getsize(ASSET)} bytes)")
    else:
        sys.exit("usage: python tests/test_torch_slice.py regen")
