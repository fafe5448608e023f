"""int8 on MobileNet-v2, EfficientNet-lite0, ShuffleNet-v2 and ResNet-50,
with the calibrated neck, against the JAX package on the CPU.

Each backbone at 64 px (narrow where it has a width multiplier; ResNet-50
has none), seeded weights, ``int8_neck``:

* calibration on one seeded batch: every scale the JAX package records,
  by path, the port records. JAX runs op by op (``jax.disable_jit``), as
  the port rounds its bf16 ops (its jitted calibration fuses them), so its
  ``amax / 127`` divides where the jitted program, and the port, multiply
  by f32(1/127): the port's scale is compared as its observed max (a bf16
  value, recovered exactly from the scale) against JAX's. Calibration runs
  the plain bf16 convs, whose f32 sums each framework orders its own way,
  so a rounding that flips upstream moves the maxima downstream: the bar
  is ``tests/test_torch_int8.py``'s, 3% (measured on this sandbox's CPU:
  MobileNet-v2, EfficientNet-lite0 and ShuffleNet equal in every scale;
  ResNet-50 14 of 77 scales 1-3 bf16 steps apart, at most 1.2%);
* the raw maps of the port served on those scales bit-equal to op-by-op
  JAX (the dense convs are exact integer products; the bf16 depthwise
  convs, norms and adds round as JAX's do);
* the refusal of uncalibrated int8 off MobileNet-v1 (no ``int8_neck``),
  as the JAX package's ``build_backbone`` refuses it, and the raise of an
  ``int8_neck`` model served without scales;
* the ``.npz`` round trip of a calibrated artifact and ``quant.int8_config``.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tpu import quant as jax_quant
from ssd_tpu.config import Config as JaxConfig
from ssd_tpu.models.detector import Detector as JaxDetector
from ssd_tpu_torch import quant
from ssd_tpu_torch.config import Config
from ssd_tpu_torch.convert import (convert_variables, load_npz_artifact,
                                   save_npz_artifact, scale_name)
from ssd_tpu_torch.models.detector import Detector, check_supported
from ssd_tpu_torch.predictor import Predictor
from tests.test_torch_model import seeded_variables

TORCH_THREADS = 1
CALIBRATION_RTOL = 0.03  # tests/test_torch_int8.py's

# backbone -> model fields (the width, where it has one)
BACKBONES = {
    "mobilenet_v2": dict(backbone="mobilenet_v2", width_multiplier=0.25),
    "efficientnet_lite": dict(backbone="efficientnet_lite",
                              width_multiplier=0.25),
    "shufflenet": dict(backbone="shufflenet", width_multiplier=0.5),
    "resnet50": dict(backbone="resnet50"),
}


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)


def configs(case: str, neck: bool = True, size: int = 64):
    d = dict(num_classes=4, image_size=size,
             model=dict(fpn_channels=16, head_depth=1, compute_dtype="int8",
                        int8_neck=neck, **BACKBONES[case]))
    return JaxConfig.from_dict(d), Config.from_dict(d)


def seeded(jcfg, seed: int) -> dict:
    """Seeded f32 weights for ``jcfg``'s model (its float twin's tree)."""
    f32 = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, compute_dtype="float32", int8_neck=False))
    det = JaxDetector(f32)
    abstract = jax.eval_shape(lambda: det.init(jax.random.PRNGKey(0)))
    return seeded_variables(abstract, seed)


@contextlib.contextmanager
def torch_rsqrt():
    """JAX's ``lax.rsqrt`` as torch computes it, for op-by-op JAX (concrete
    values). Neither CPU's f32 rsqrt is correctly rounded, and they differ
    in a third of all values (``ROADMAP.md`` §3); one ulp in a norm's
    multiplier flips a bf16 rounding now and then, which int8 quantization
    downstream amplifies. With the norms' rsqrt shared, every other op is
    held bit for bit."""
    real = jax.lax.rsqrt

    def rsqrt(x):
        return jnp.asarray(torch.rsqrt(torch.from_numpy(np.array(x))).numpy())

    jax.lax.rsqrt = rsqrt
    try:
        yield
    finally:
        jax.lax.rsqrt = real


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().float() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


def test_rsqrt_differs_between_frameworks():
    """Why the model cases share torch's rsqrt: XLA:CPU's f32 ``lax.rsqrt``
    and torch's CPU ``torch.rsqrt`` are neither correctly rounded, and they
    disagree on a third of the values a norm sees (``ROADMAP.md`` §3)."""
    x = np.random.default_rng(0).uniform(0.5, 1.5, 200_000).astype(
        np.float32) + np.float32(1e-3)
    xla = np.asarray(jax.jit(jax.lax.rsqrt)(x))
    port = torch.rsqrt(torch.from_numpy(x)).numpy()
    truth = (1.0 / np.sqrt(x.astype(np.float64))).astype(np.float32)
    share = float((xla != port).mean())
    print(f"rsqrt: XLA and torch differ on {share:.4f}; off the f64 truth "
          f"XLA {float((xla != truth).mean()):.4f}, torch "
          f"{float((port != truth).mean()):.4f}")
    assert share > 0.01
    assert np.abs(xla.astype(np.float64) - port).max() <= np.spacing(
        np.float32(1.5)) * 2


@pytest.fixture(scope="module")
def cases():
    return {}


def case_result(cases: dict, case: str) -> dict:
    """JAX's op-by-op calibration and raw maps, and the port's, once a
    module."""
    if case in cases:
        return cases[case]
    jcfg, cfg = configs(case)
    variables = seeded(jcfg, sorted(BACKBONES).index(case))
    rng = np.random.default_rng(40 + sorted(BACKBONES).index(case))
    cal = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    images = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    jdet = JaxDetector(jcfg)
    with jax.disable_jit(), torch_rsqrt():
        qvars, _ = jax_quant.calibrate(jdet, variables, [cal])
        want = jdet.model.apply(qvars, images, flatten=False,
                                raw_input=True)
    flat = jax.tree_util.tree_flatten_with_path(qvars["quant"])[0]
    jax_scales = {scale_name("quant/" + "/".join(p.key for p in path)):
                  float(np.float32(v)) for path, v in flat}
    f32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32", int8_neck=False))
    det = Detector(cfg, convert_variables(variables, f32), device="cpu")
    assert quant.calibrate(det, [cal]) == 2
    port_scales = {k: float(v) for k, v in det.model.state_dict().items()
                   if "act_scale_" in k}
    served = Detector(cfg, convert_variables(qvars, cfg), device="cpu")
    got = served.raw(images)
    cases[case] = dict(jax_scales=jax_scales, port_scales=port_scales,
                       want=want, got=got, det=det, images=images)
    return cases[case]


@pytest.mark.parametrize("case", sorted(BACKBONES))
def test_calibrated_scales_equal_jax(cases, case):
    r = case_result(cases, case)
    want, got = r["jax_scales"], r["port_scales"]
    assert set(got) == set(want)
    backbone = [k for k in want if k.startswith("backbone.")]
    assert backbone, "every backbone conv records a scale"
    recip = np.float32(1.0) / np.float32(127.0)
    # JAX's observed max: a bf16 activation, so its scale * 127 rounds
    # back to it exactly
    amax = {k: observed(v) for k, v in want.items()}
    assert all(np.float32(amax[k] / np.float32(127.0)) == np.float32(v)
               for k, v in want.items())
    diff = [k for k in want
            if np.float32(got[k]) != np.float32(amax[k] * recip)]
    # the port's scale is its own observed max times f32(1/127)
    assert all(np.float32(v) == np.float32(observed(v) * recip)
               for v in got.values())
    steps = {k: bf16_steps(observed(got[k]), amax[k]) for k in diff}
    rel = max([abs(observed(got[k]) / amax[k] - 1) for k in diff] or [0.0])
    print(f"{case}: {len(want)} scales ({len(backbone)} in the backbone), "
          f"{len(diff)} apart in the observed max, by at most "
          f"{max(steps.values() or [0])} bf16 steps, {rel:.2e} relative")
    assert rel <= CALIBRATION_RTOL, steps


def observed(scale: float) -> np.float32:
    """The bf16 max a scale was made from: scale * 127 rounded to bf16."""
    return np.float32(jnp.asarray(np.float64(scale) * 127.0, jnp.bfloat16))


def bf16_steps(got: float, want: float) -> float:
    """|got - want| in bf16 steps at the larger magnitude."""
    mag = max(abs(float(got)), abs(float(want)))
    return abs(float(got) - float(want)) / 2.0 ** (np.floor(np.log2(mag))
                                                   - 7)


@pytest.mark.parametrize("case", sorted(BACKBONES))
def test_raw_maps_bit_equal_to_jax(cases, case):
    r = case_result(cases, case)
    worst = 0.0
    for (gc, gb), (wc, wb) in zip(r["got"], r["want"]):
        for g, w in ((gc, wc), (gb, wb)):
            assert g.dtype == torch.bfloat16
            worst = max(worst, float(np.abs(_np(g) - _np(w)).max()))
    print(f"{case}: raw maps max |diff| {worst}")
    assert worst == 0.0


@pytest.mark.parametrize("case", ["mobilenet_v2", "resnet50", "shufflenet",
                                  "efficientnet_lite"])
def test_uncalibrated_int8_refused_as_jax(case):
    jcfg, cfg = configs(case, neck=False)
    with pytest.raises(ValueError, match="uncalibrated int8") as jerr:
        JaxDetector(jcfg).init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="uncalibrated int8") as err:
        check_supported(cfg)
    assert str(err.value).split(":")[0] == str(jerr.value).split(":")[0]
    with pytest.raises(ValueError, match="uncalibrated int8"):
        Detector(cfg, device="cpu")
    with pytest.raises(ValueError, match="uncalibrated int8"):
        quant.int8_config(dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype="bfloat16")), int8_neck=False)
    # MobileNet-v1 keeps its calibration-free backbone-only int8
    check_supported(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone="mobilenet", width_multiplier=0.25)))


def test_neck_without_scales_raises():
    _, cfg = configs("resnet50")
    det = Detector(cfg, device="cpu")
    with pytest.raises(ValueError, match="calibrated activation scale"):
        det.raw(np.zeros((1, 64, 64, 3), np.uint8))


def test_calibrated_npz_round_trip_serves(cases, tmp_path):
    r = case_result(cases, "shufflenet")
    det = r["det"]
    path = str(tmp_path / "int8.npz")
    save_npz_artifact(path, det.cfg, det.model.state_dict())
    cfg, state = load_npz_artifact(path)
    assert cfg == det.cfg
    assert sum("act_scale_" in k for k in state) == len(r["port_scales"])
    pred = Predictor.from_npz(path, device="cpu")
    a = pred.predict(r["images"])
    b = Predictor(det.cfg, det.model.state_dict(), device="cpu").predict(
        r["images"])
    for k in ("boxes", "scores", "labels", "num_boxes"):
        np.testing.assert_array_equal(a[k], b[k])
