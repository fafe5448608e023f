"""The port's accuracy studies against the JAX package's: the crowded-scene
sweep, the tiled study, the int8 calibration study and the sanity-artifact
trainer.

The crowded task's files (tfrecords written with JPEG quality 95) are the
JAX tool's byte for byte, its config JSON and its 24 variants' names and
order are JAX's. On the same TINY weights (JAX's ``init`` with the class
head's bias at -2, so that the random model detects; converted by
``convert.convert_variables``), both in f32 on the CPU:

* ``run_sweep`` over 8 val scenes: every row within 1e-6 of JAX's;
* the tiled study's variants (``--ablate``) on 2 scenes at 128 px, the
  model at 64 px: every score within 1e-6 of JAX's;
* the calibration study on 2 val scenes at 128 px (dense4), calibrated on
  8 train or 8 val images, absmax and p99.9: the f32 row within 1e-6 of
  JAX's, the int8 rows of the train images within 0.002 mAP of JAX's (the
  int8 bar of ``tests/test_torch_int8.py``);
* the sanity-artifact trainer from ``--init assets/train_ref_v1.npz`` (JAX's
  seed-0 state of the f32 sanity task): its first 3 losses within 1e-4 of
  JAX's stored steps (measured 1.5e-5 to 1.9e-5).
"""

import dataclasses
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import jax  # noqa: E402

from ssd_tpu.config import Config as JaxConfig  # noqa: E402
from ssd_tpu.tools import crowded_validation as jax_crowded  # noqa: E402
from ssd_tpu_torch.config import Config  # noqa: E402
from ssd_tpu_torch.convert import convert_variables  # noqa: E402
from ssd_tpu_torch.tools import crowded_validation as crowded  # noqa: E402

ROW_TOL = 1e-6
INT8_MAP_BAR = 0.002
LOSS_RTOL = 1e-4
CLASS_BIAS = -2.0


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(jcfg: JaxConfig, size: int, **model) -> JaxConfig:
    """``jcfg`` cut to TINY, in f32, its anchors scaled down with the image
    (anchor scale 1.5: P3's anchors 12 px, the objects' size at 128 px), so
    that the random model's boxes (its anchors) meet the objects."""
    return dataclasses.replace(
        jcfg, image_size=size,
        anchors=dataclasses.replace(jcfg.anchors, anchor_scale=1.5),
        model=dataclasses.replace(
            jcfg.model, width_multiplier=0.25, fpn_channels=16, head_depth=1,
            compute_dtype="float32", **model))


def jax_weights(jcfg: JaxConfig) -> tuple[dict, dict]:
    """JAX's ``init`` (seed 0) with the class bias raised -> (JAX
    variables, the port's state)."""
    from ssd_tpu.models.detector import Detector as JaxDetector

    variables = jax.device_get(JaxDetector(jcfg).init(jax.random.PRNGKey(0)))
    bias = variables["params"]["head"]["class_net"]["predict"]["bias"]
    variables["params"]["head"]["class_net"]["predict"]["bias"] = \
        np.full_like(bias, CLASS_BIAS)
    return variables, convert_variables(variables,
                                        Config.from_json(jcfg.to_json()))


@pytest.fixture(scope="module")
def crowd(tmp_path_factory):
    """The crowded task's train (8) and val (8) sets, written by the port,
    and the TINY f32 config and weights."""
    tmp = str(tmp_path_factory.mktemp("crowd"))
    crowded.write_dataset(os.path.join(tmp, "train.tfrecords"), 8, seed=0)
    crowded.write_dataset(os.path.join(tmp, "val.tfrecords"), 8, seed=1)
    jcfg = tiny(jax_crowded.make_config(tmp, 10), 128)
    variables, state = jax_weights(jcfg)
    return tmp, jcfg, variables, state


def _rows_close(got: list, want: list, keys, tol: float) -> None:
    assert [r["variant"] if "variant" in r else r["regime"] for r in got] \
        == [r["variant"] if "variant" in r else r["regime"] for r in want]
    for g, w in zip(got, want):
        for k in keys:
            assert abs(g[k] - w[k]) <= tol, (g, w, k)


# --------------------------------------------------------------- crowded

def test_crowded_files_config_and_variants_equal_jax(crowd, tmp_path):
    tmp, _, _, _ = crowd
    jax_crowded.write_dataset(str(tmp_path / "val.tfrecords"), 8, seed=1)
    with open(tmp_path / "val.tfrecords", "rb") as a, \
            open(os.path.join(tmp, "val.tfrecords"), "rb") as b:
        assert a.read() == b.read()
    assert (crowded.make_config(tmp, 2500).to_json()
            == jax_crowded.make_config(tmp, 2500).to_json())
    assert np.array_equal(crowded._palette(40), jax_crowded._palette(40))

    from ssd_tpu.models.detector import Detector as JaxDetector
    from ssd_tpu_torch.models.detector import Detector

    jcfg = jax_crowded.make_config(tmp, 10)
    want = [(n, k) for n, k, _ in jax_crowded.variant_postprocessors(
        JaxDetector(jcfg), jcfg, on_tpu=False)]
    cfg = Config.from_json(jcfg.to_json())
    got = [(n, k) for n, k, _ in crowded.variant_postprocessors(
        Detector(cfg, device="cpu"), cfg)]
    assert got == want and len(got) == 24


def test_crowded_sweep_equals_jax(crowd):
    tmp, jcfg, variables, state = crowd
    val = os.path.join(tmp, "val.tfrecords")
    want = jax_crowded.run_sweep(jcfg, variables, val, 8, batch_size=8)
    got = crowded.run_sweep(Config.from_json(jcfg.to_json()), state, val, 8,
                            batch_size=8, device="cpu")
    assert got[0]["images"] == 8 and got[0]["AR@100"] > 0
    _rows_close(got, want, ("mAP", "AP50", "AR@100", "d_mAP"), ROW_TOL)
    # the port's top-k is exact: each approx row is its exact twin
    by = {r["variant"]: r for r in got}
    for q in (256, 512, 1024, 2048):
        assert by[f"anchors-approx q={q}"]["mAP"] == \
            by[f"anchors-exact q={q}"]["mAP"]


# ----------------------------------------------------------------- tiled

def test_tiled_study_equals_jax(crowd):
    from ssd_tpu.tools.tiled_validation import \
        evaluate_variants as jax_evaluate
    from ssd_tpu.tools.tiled_validation import hires_scenes as jax_scenes
    from ssd_tpu_torch.tools.tiled_validation import (evaluate_variants,
                                                      hires_scenes)

    _, jcfg, variables, state = crowd
    jcfg = dataclasses.replace(jcfg, image_size=64)
    cfg = Config.from_json(jcfg.to_json())
    for (a, ba, la), (b, bb, lb) in zip(jax_scenes(2, 7, 128),
                                        hires_scenes(2, 7, 128)):
        assert a == b
        np.testing.assert_array_equal(ba, bb)
        np.testing.assert_array_equal(la, lb)
    args = SimpleNamespace(ablate=True, hires_size=128, val_images=2)
    want = jax_evaluate(variables, jcfg, args)
    got = evaluate_variants(state, cfg, args, device="cpu")
    assert len(got) == 5
    _rows_close(got, want, ("mAP", "AP50", "AP_small", "AR@100"), ROW_TOL)


# ----------------------------------------------------------- calibration

def test_calibration_study_equals_jax(crowd):
    from ssd_tpu.models.detector import Detector as JaxDetector
    from ssd_tpu.quant import calibrate as jax_calibrate
    from ssd_tpu.tools import calibration_study as jax_study
    from ssd_tpu_torch.tools import calibration_study as study

    tmp, jcfg, _, _ = crowd
    jcfg = tiny(jax_crowded.make_config(tmp, 10), 128,
                stem_schedule="dense4")
    variables, state = jax_weights(jcfg)
    train, val = (os.path.join(tmp, f"{s}.tfrecords")
                  for s in ("train", "val"))
    cfg = Config.from_json(jcfg.to_json())
    got = study.sweep(cfg, state, train, val, 2, [8], 99.9, device="cpu")

    for pattern in (train, val):
        for a, b in zip(jax_study._batches_from(pattern, jcfg, 8),
                        study._batches_from(pattern, cfg, 8)):
            np.testing.assert_array_equal(a, b)
    # JAX's rows of the train distribution (the val rows run the same code
    # on other calibration images)
    f32_map = jax_study.eval_map(jcfg, variables, val, 2)
    jcfg8 = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, compute_dtype="int8", int8_neck=True))
    want = [{"regime": "bf16 baseline", "mAP": f32_map, "d_mAP": 0.0}]
    batches = jax_study._batches_from(train, jcfg, 8)
    for clip in (None, 99.9):
        qv, seen = jax_calibrate(JaxDetector(jcfg8), dict(variables),
                                 batches, percentile=clip)
        m = jax_study.eval_map(jcfg8, qv, val, 2)
        name = (f"int8 cal=train n={seen} "
                f"clip={'absmax' if clip is None else f'p{clip:g}'}")
        want.append({"regime": name, "mAP": m, "d_mAP": m - f32_map})
    assert want[0]["mAP"] > 0 and len(got) == 5
    _rows_close(got[:1], want[:1], ("mAP",), ROW_TOL)
    _rows_close(got[:3], want, ("mAP", "d_mAP"), INT8_MAP_BAR)
    assert [r["regime"] for r in got[3:]] == [
        "int8 cal=val n=8 clip=absmax", "int8 cal=val n=8 clip=p99.9"]
    assert all(0.0 <= r["mAP"] <= 1.0 for r in got)


# ------------------------------------------------------ sanity artifact

def test_make_bench_artifact_steps_like_jax(tmp_path):
    from ssd_tpu_torch.tools.make_bench_artifact import (check_out,
                                                         train_artifact)

    init = os.path.join(ROOT, "ssd_tpu_torch", "assets", "train_ref_v1.npz")
    r = train_artifact(str(tmp_path / "art"), steps=3, init=init,
                       device="cpu")
    with np.load(init) as z:
        want = z["jax_loss"][:3]
    np.testing.assert_allclose(r["losses"], want, rtol=LOSS_RTOL)
    assert r["dtype"] == "f32" and 0.0 <= r["sanity_map"] <= 1.0
    assert os.path.exists(tmp_path / "art" / "variables.npz")
    for protected in ("ssd_tpu_torch/assets/x", "bench_assets"):
        with pytest.raises(ValueError, match="never overwritten"):
            check_out(os.path.join(ROOT, protected))
