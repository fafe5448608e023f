"""The reference-schedule MobileNet-v1 path of the port against the JAX
package's, on the CPU.

* ``configs/coco_mobilenet_640.json``: every leaf of JAX's variable tree
  converts and nothing is left unfilled.
* Raw head maps of the reference schedule at the golden bars in f32 (atol
  2e-4, rtol 2e-3): width 0.25 at 96 px, full width x1.0 at 64 px, and with
  ``stem_space_to_depth``; and in bf16 at the bars
  ``tests/test_torch_model.py`` holds the head to.
* ``tests/goldens/predict_cells_v1.npz`` reproduced from JAX's
  ``PRNGKey(42)`` weights: raw slices at the golden bars, detections under
  the golden set rule, through ``Detector`` and through
  ``Predictor(device="cpu")`` with the raw uint8 feed.
* ``ssd_tpu_torch/assets/golden_cells_v1.npz``, the card's copy of that
  golden, matches what ``regen`` writes:

      python tests/test_torch_reference.py regen

* One f32 train-mode loss and gradient on the reference schedule against
  JAX's (the stem's batch norm on a 3-channel input is a new gradient path).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

if __name__ == "__main__":  # regen: JAX on the CPU, as tests/conftest.py sets
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # for ``python tests/test_torch_reference.py regen``
    sys.path.insert(0, ROOT)

from ssd_tpu.config import Config as JaxConfig  # noqa: E402
from ssd_tpu.models.detector import Detector as JaxDetector  # noqa: E402
from ssd_tpu_torch.config import Config  # noqa: E402
from ssd_tpu_torch.convert import (convert_params,  # noqa: E402
                                   convert_variables, load_npz_artifact,
                                   save_npz_artifact)
from ssd_tpu_torch.models.detector import Detector, SSDModel  # noqa: E402
from ssd_tpu_torch.models.fpn import flatten_levels  # noqa: E402
from ssd_tpu_torch.models.layers import space_to_depth  # noqa: E402
from ssd_tpu_torch.predictor import Predictor  # noqa: E402
from tests import test_golden  # noqa: E402
from tests.test_torch_model import seeded_variables  # noqa: E402
from tests.test_torch_slice import DET_KEYS, assert_set_match  # noqa: E402

ASSET = os.path.join(ROOT, "ssd_tpu_torch", "assets", "golden_cells_v1.npz")
REFERENCE = os.path.join(ROOT, "configs", "coco_mobilenet_640.json")
GOLDEN_BARS = dict(atol=2e-4, rtol=2e-3)
RAW_KEYS = ("logits_slice", "deltas_slice", "anchors_head")


def _replace_model(cfg, **kw):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **kw))


def _small_cfg(dtype="float32", width=0.25, image_size=96, **model_kw):
    """The golden's model (5 classes, FPN 32, head depth 1) with cell-major
    selection."""
    jcfg = dataclasses.replace(
        test_golden.CFG, image_size=image_size,
        nms=dataclasses.replace(test_golden.CFG.nms, select="cells"))
    jcfg = _replace_model(jcfg, compute_dtype=dtype, width_multiplier=width,
                          **model_kw)
    return jcfg, Config.from_json(jcfg.to_json())


def _seeded(jcfg, seed: int):
    abstract = jax.eval_shape(
        lambda: JaxDetector(jcfg).init(jax.random.PRNGKey(0)))
    return seeded_variables(abstract, seed)


def _images(seed: int, n: int, size: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, (n, size, size, 3)).astype(np.uint8)


# ------------------------------------------------------------------ weights

def test_convert_accounts_for_every_reference_leaf():
    jcfg = JaxConfig.load(REFERENCE)
    variables = _seeded(jcfg, seed=1)
    cfg = Config.load(REFERENCE)
    state = convert_variables(variables, cfg)
    assert len(jax.tree_util.tree_leaves(variables)) == len(state)
    model = SSDModel(cfg)
    model.load_state_dict(state, strict=True)
    bb = variables["params"]["backbone"]
    np.testing.assert_array_equal(
        model.backbone.stem.conv.weight.detach().numpy(),
        bb["stem"]["conv"]["kernel"].transpose(3, 2, 0, 1))
    assert tuple(model.backbone.stem.conv.weight.shape) == (32, 3, 3, 3)
    assert tuple(model.backbone.ds2.pointwise.conv.weight.shape) == (
        128, 64, 1, 1)


def test_space_to_depth_matches_jax(rng):
    from ssd_tpu.models.layers import space_to_depth as jax_s2d
    x = rng.normal(size=(2, 6, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        space_to_depth(torch.from_numpy(x), 2).numpy(), np.asarray(jax_s2d(x, 2)))


def test_dense4_still_refuses_stem_space_to_depth():
    _, cfg = _small_cfg(stem_schedule="dense4", stem_space_to_depth=True)
    with pytest.raises(ValueError, match="stem_space_to_depth"):
        SSDModel(cfg)


# ------------------------------------------------------------------ raw maps

def _raw_both(jcfg, cfg, variables, images):
    want = JaxDetector(jcfg).model.apply(variables, images, flatten=False,
                                         raw_input=True)
    got = Detector(cfg, convert_variables(variables, cfg),
                   device="cpu").raw(images)
    assert len(got) == len(want) == 5
    return got, want


@pytest.mark.parametrize("case", ["x0.25_96px", "x1.0_64px", "s2d"])
def test_reference_raw_maps_match_f32(case):
    if case == "x1.0_64px":
        jcfg = _replace_model(dataclasses.replace(
            JaxConfig.load(REFERENCE), image_size=64), compute_dtype="float32")
        cfg = Config.from_json(jcfg.to_json())
        images = _images(2, 2, 64)
    else:
        jcfg, cfg = _small_cfg(stem_space_to_depth=case == "s2d")
        images = _images(2, 2, 96)
    got, want = _raw_both(jcfg, cfg, _seeded(jcfg, seed=4), images)
    for (gc, gb), (wc, wb) in zip(got, want):
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), **GOLDEN_BARS)
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), **GOLDEN_BARS)


def test_reference_raw_maps_match_bf16():
    """bf16: the head's bars in ``tests/test_torch_model.py`` (2^-4
    absolute, 2% relative): every conv rounds its output to bf16, in an
    order that differs between the two frameworks."""
    jcfg, cfg = _small_cfg("bfloat16")
    got, want = _raw_both(jcfg, cfg, _seeded(jcfg, seed=5), _images(3, 2, 96))
    for (gc, gb), (wc, wb) in zip(got, want):
        for g, w in ((gc, wc), (gb, wb)):
            assert g.dtype == torch.bfloat16
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(w, np.float32),
                                       atol=2 ** -4, rtol=2e-2)


def test_raw_input_normalizes_to_bf16_in_f32_models():
    """A raw uint8 batch reaches an f32 reference model as bf16-rounded
    pixels; ``raw_input=False`` takes the normalized batch as it is."""
    from ssd_tpu_torch.models.detector import normalize_images
    _, cfg = _small_cfg()
    model = SSDModel(cfg)
    model.reset_parameters(seed=0)
    model.eval()
    images = torch.from_numpy(_images(6, 1, 96))
    norm = normalize_images(images)
    assert norm.dtype == torch.bfloat16
    with torch.no_grad():
        a = model(images)
        b = model(norm.float(), raw_input=False)
    for (ac, ab), (bc, bb) in zip(a, b):
        assert torch.equal(ac, bc) and torch.equal(ab, bb)


def test_normalize_images_equals_jax_on_every_pixel_value():
    from ssd_tpu.models.detector import normalize_images as jax_normalize
    from ssd_tpu_torch.models.detector import normalize_images
    px = np.arange(256, dtype=np.uint8).reshape(1, 256, 1, 1).repeat(3, -1)
    want = np.asarray(jax.jit(jax_normalize)(px), np.float32)
    got = normalize_images(torch.from_numpy(px)).float().numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ golden

def _golden_want() -> dict:
    """JAX's f32 outputs as ``tests/test_golden.py`` stores them."""
    with np.load(test_golden.GOLDEN_CELLS) as z:
        return {k: z[k] for k in z.files}


def golden_arrays() -> tuple[Config, dict, dict]:
    """-> (cfg, state, extra arrays) of ``golden_cells_v1.npz``: the golden
    cells config, JAX's ``PRNGKey(42)`` variables converted, the two
    seeded 96 px images, and JAX's f32 outputs (the stored golden)."""
    jcfg = dataclasses.replace(test_golden.CFG, nms=dataclasses.replace(
        test_golden.CFG.nms, select="cells"))
    cfg = Config.from_json(jcfg.to_json())
    variables = jax.device_get(
        JaxDetector(jcfg).init(jax.random.PRNGKey(42)))
    state = convert_variables(variables, cfg)
    images = np.random.default_rng(7).integers(
        0, 255, (2, 96, 96, 3)).astype(np.uint8)  # test_golden's images
    extra = {"images": images}
    extra.update({f"jax_{k}": v for k, v in _golden_want().items()})
    return cfg, state, extra


@pytest.fixture(scope="module")
def golden():
    return golden_arrays()


def test_port_reproduces_the_cells_golden(golden):
    cfg, state, extra = golden
    want = _golden_want()
    det = Detector(cfg, state, device="cpu")
    norm = (extra["images"].astype(np.float32) - 127.5) / 64.0
    with torch.no_grad():
        logits, deltas = flatten_levels(
            det.model.eval()(torch.from_numpy(norm), raw_input=False),
            cfg.num_classes)
    got = {"logits_slice": logits[:, :64].numpy(),
           "deltas_slice": deltas[:, :64].numpy(),
           "anchors_head": det.anchors[:64].numpy()}
    for k in RAW_KEYS:
        np.testing.assert_allclose(got[k], want[k], **GOLDEN_BARS, err_msg=k)
    out = det.predict(extra["images"])
    assert_set_match({k: getattr(out, k).numpy() for k in DET_KEYS},
                     {k: want[k] for k in DET_KEYS})


def test_predictor_serves_the_raw_feed(golden):
    cfg, state, extra = golden
    pred = Predictor(cfg, state, device="cpu")
    assert not pred._packed and pred._feed_shape(4) == (4, 96, 96, 3)
    with pytest.raises(ValueError, match="dense4"):
        Predictor(cfg, state, device="cpu", packed_ingest=True)
    pred.warmup(2)
    want = _golden_want()
    assert_set_match(pred.predict(extra["images"]),
                     {k: want[k] for k in DET_KEYS})
    rng = np.random.default_rng(8)
    mixed = [rng.integers(0, 256, s + (3,), dtype=np.uint8)
             for s in ((120, 80), (96, 96), (50, 200))]
    out = pred.predict(mixed)
    assert out["boxes"].shape == (3, cfg.nms.max_boxes, 4)
    pred.preserve_aspect = True
    one = pred.predict(mixed[2])
    assert one["boxes"].shape == (cfg.nms.max_boxes, 4)
    assert np.isfinite(one["boxes"]).all()


def test_committed_golden_asset_matches_regen(golden):
    cfg, state, extra = golden
    got_cfg, got_state = load_npz_artifact(ASSET)
    assert got_cfg == cfg
    assert set(got_state) == set(state)
    for k, v in state.items():
        assert torch.equal(got_state[k], v), k
    with np.load(ASSET) as z:
        assert sorted(z.files) == sorted(
            [f"state/{k}" for k in state] + ["config_json", *extra])
        for k, v in extra.items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)


# ------------------------------------------------------------------ training

def _cos(a: dict, b: dict, keys) -> float:
    x = torch.cat([a[k].flatten() for k in keys])
    y = torch.cat([b[k].flatten() for k in keys])
    return float(x @ y / (x.norm() * y.norm()))


def test_reference_train_step_matches_jax():
    """One f32 train-mode loss and gradient (64 px, x0.25): loss terms at
    ``tests/test_torch_train.py``'s rtol 1e-4, num_positives equal, the
    new BN running statistics within 1e-4 relative and 1e-5 absolute (a
    mean of 0.08 moved by 2.1e-6 and a variance of 0.98 by 2.0e-5 here:
    sums with cancellation, in another order). Gradients
    per part: cosine 0.9999 with
    JAX's for the backbone, FPN and head (measured 0.99996 or above), 0.999
    for the stem and each of its leaves (measured 0.99988). Leaf by leaf
    the two differ more here than on the dense4 schedule (up to 16% of a
    deep depthwise leaf's largest entry, in one channel; about 1% in the
    stem): the batch norm's fast variance cancels, and the two frameworks
    sum its terms in another order (ROADMAP.md section 3)."""
    from tests.test_torch_train import (jax_state, port_from_jax, small_batch,
                                        small_cfg)
    cfg = _replace_model(small_cfg(), stem_schedule="reference")
    jdet, _, jstate = jax_state(cfg)

    def loss_fn(params, batch):
        return jdet.loss({"params": params,
                          "batch_stats": jstate.batch_stats}, batch)

    batch = small_batch(0)
    (_, (metrics, new_state)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jstate.params, batch)
    metrics, new_state, grads = jax.device_get((metrics, new_state, grads))
    det, _, _ = port_from_jax(cfg, jstate)
    total, got = det.loss(batch)
    total.backward()
    assert float(metrics["num_positives"]) > 20
    assert float(got["num_positives"]) == float(metrics["num_positives"])
    for k, w in metrics.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    want = convert_params(grads, cfg)
    port = {k: p.grad for k, p in det.model.named_parameters()}
    assert float(port["backbone.stem.conv.weight"].abs().max()) > 0
    for part in ("backbone.", "fpn.", "head."):
        keys = [k for k in port if k.startswith(part)]
        assert _cos(port, want, keys) >= 0.9999, part
    stem = [k for k in port if k.startswith("backbone.stem.")]
    for keys in [stem] + [[k] for k in stem]:
        assert _cos(port, want, keys) >= 0.999, keys
    stats = convert_variables({"params": jstate.params, **new_state}, cfg)
    for name, b in det.model.named_buffers():
        if name in stats:
            np.testing.assert_allclose(b.numpy(), stats[name].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


if __name__ == "__main__":
    if sys.argv[1:] == ["regen"]:
        os.makedirs(os.path.dirname(ASSET), exist_ok=True)
        cfg, state, extra = golden_arrays()
        save_npz_artifact(ASSET, cfg, state, **extra)
        print(f"wrote {ASSET} ({os.path.getsize(ASSET)} bytes)")
    else:
        sys.exit("usage: python tests/test_torch_reference.py regen")
