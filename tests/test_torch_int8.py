"""The port's int8 serving path against the JAX package's, on the CPU.

Mirrors ``tests/test_quant.py``'s cases, each against JAX on the same
inputs (seeded numpy), with the bar stated at each:

* ``QuantConv`` alone (1x1, 3x3, stride 1 and 2, with and without bias,
  N = 36, M < 17, static and calibrated scales): the s32 product and the
  bf16 output bit-equal to JAX's; the padded GEMM equal to unpadded int32
  sums;
* the int8 conv's operator (``ops/conv_s8_cuda.conv_s8``, whose CPU path is
  the plain version of the card's kernel): with explicit padding over
  height strips equal to the implicit-padding im2col under strips; the
  weights it takes prepared once per weight version, again after
  ``load_state_dict``, an in-place edit and ``.to()``; its argument
  checks; an exported int8 program records it, its weights as constants;
* the int8 dense4 stem on both feeds;
* a few-layer int8 model with and without ``int8_neck``, from JAX's
  calibrated scales;
* the raises: an uncalibrated neck conv, a stale resolution, an
  ``int8_neck`` artifact saved without scales;
* calibration on the sanity artifact against JAX's, the percentile mode
  bit-equal to ``jnp.percentile``;
* the sanity artifact's int8 mAP from the port's own evaluator within
  0.002 of JAX's, and that evaluator equal to JAX's on the same detections;
* the npz round trip of an int8 artifact, served by
  ``Predictor(device="cpu")``, and the ``python -m ssd_tpu_torch.quant`` CLI;
* ``ssd_tpu_torch/assets/sanity_int8_v1.npz`` (JAX's 39 calibrated scales
  by path, its int8 detections on the 32 val scenes and its CPU mAP, for
  the card, which has no JAX) matches what ``regen`` writes:

      python tests/test_torch_int8.py regen
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

if __name__ == "__main__":  # regen: JAX on the CPU, as tests/conftest.py sets
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # for ``python tests/test_torch_int8.py regen``
    sys.path.insert(0, ROOT)

from ssd_tpu import quant as jax_quant  # noqa: E402
from ssd_tpu.config import Config as JaxConfig  # noqa: E402
from ssd_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from ssd_tpu.eval import sanity as jax_sanity  # noqa: E402
from ssd_tpu.eval.coco_map import \
    DetectionEvaluator as JaxEvaluator  # noqa: E402
from ssd_tpu.export import load_inference_artifact  # noqa: E402
from ssd_tpu.models.detector import Detector as JaxDetector  # noqa: E402
from ssd_tpu.models.layers import QuantConv as JaxQuantConv  # noqa: E402
from ssd_tpu.models.mobilenet import \
    _Int8FoldedS2DConv as JaxInt8Stem  # noqa: E402
from ssd_tpu.ops.ingest import pack_s2d as jax_pack_s2d  # noqa: E402
from ssd_tpu_torch import quant  # noqa: E402
from ssd_tpu_torch.config import Config  # noqa: E402
from ssd_tpu_torch.convert import (convert_variables,  # noqa: E402
                                   load_npz_artifact, save_npz_artifact,
                                   scale_name)
from ssd_tpu_torch.data import synthetic  # noqa: E402
from ssd_tpu_torch.eval import sanity  # noqa: E402
from ssd_tpu_torch.eval.coco_map import DetectionEvaluator  # noqa: E402
from ssd_tpu_torch.export import \
    load_inference_artifact as load_artifact  # noqa: E402
from ssd_tpu_torch.models.detector import Detector  # noqa: E402
from ssd_tpu_torch.models.layers import (QuantConv, conv_int8,  # noqa: E402
                                         int_mm, percentile,
                                         quantize_activation,
                                         quantize_weight, same_pad)
from ssd_tpu_torch.ops import conv_s8_cuda  # noqa: E402
from ssd_tpu_torch.parallel import spatial  # noqa: E402
from ssd_tpu_torch.parallel.spatial import SpatialRunner  # noqa: E402
from ssd_tpu_torch import export  # noqa: E402
from ssd_tpu_torch.models.mobilenet import Int8FoldedS2DConv  # noqa: E402
from ssd_tpu_torch.ops.ingest import pack_s2d  # noqa: E402
from ssd_tpu_torch.predictor import Predictor  # noqa: E402
from tests.test_torch_model import seeded_variables  # noqa: E402
from tests.test_torch_slice import assert_set_match  # noqa: E402

ASSET = os.path.join(ROOT, "ssd_tpu_torch", "assets", "sanity_int8_v1.npz")
DET_KEYS = ("boxes", "scores", "labels", "num_boxes")
DN = ("NHWC", "HWIO", "NHWC")


def _bf16(a: np.ndarray) -> np.ndarray:
    """f32 values that bf16 holds exactly."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().float() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


def bf16_ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want| in units of the bf16 spacing at the larger magnitude."""
    mag = np.maximum(np.abs(got), np.abs(want)).astype(np.float64)
    ulp = np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7)
    return np.abs(got.astype(np.float64) - want) / ulp


# ------------------------------------------------------------ QuantConv

def _jax_product(x, kernel, stride, a_scale):
    """The JAX package's QuantConv s32 product, step by step
    (``ssd_tpu/models/layers.py:216-235``)."""
    x_q = jnp.clip(jnp.round(x.astype(jnp.float32) / a_scale), -127,
                   127).astype(jnp.int8)
    k_absmax = jnp.max(jnp.abs(kernel), axis=(0, 1, 2), keepdims=True)
    k_scale = jnp.maximum(k_absmax / 127.0, 1e-8)
    k_q = jnp.clip(jnp.round(kernel / k_scale), -127, 127).astype(jnp.int8)
    return jax.lax.conv_general_dilated(
        x_q, k_q, (stride, stride), "SAME", dimension_numbers=DN,
        preferred_element_type=jnp.int32)


# (kernel, stride, bias, in_ch, out_ch, batch, hw, calibrated scale)
QUANT_CASES = {
    "1x1": (1, 1, True, 16, 24, 2, (8, 8), 0.031),
    "3x3": (3, 1, False, 16, 32, 2, (8, 8), None),
    "3x3_s2_even": (3, 2, True, 24, 16, 2, (8, 10), 0.047),
    "3x3_s2_odd": (3, 2, True, 8, 16, 2, (7, 9), 0.02),
    "n36": (3, 1, True, 32, 36, 2, (6, 6), 0.05),
    "m8": (3, 1, True, 16, 72, 8, (1, 1), 0.08),   # the sanity P7 at b8
    "m1": (3, 2, True, 16, 40, 1, (2, 2), 0.06),   # one image, M = 1
    "tiny_scale": (1, 1, False, 8, 16, 2, (4, 4), 1e-9),  # floored at 1e-8
}


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quant_conv_bit_equal_to_jax(case):
    """Same bf16 input, weights and scale: the s32 product and the bf16
    output equal JAX's bit for bit (integer sums are exact in any order;
    the dequantize is the same f32 ops in the same order)."""
    k, s, bias, cin, cout, n, (h, w), scale = QUANT_CASES[case]
    rng = np.random.default_rng(sorted(QUANT_CASES).index(case))
    x = _bf16(rng.normal(0.0, 2.0, (n, h, w, cin)).astype(np.float32))
    kernel = rng.normal(0.0, 0.2, (k, k, cin, cout)).astype(np.float32)
    kernel[..., 0] = 0.0  # an all-zero channel: k_scale floored at 1e-8
    b = rng.normal(0.0, 0.5, (cout,)).astype(np.float32)
    key = f"act_scale_{h}x{w}"
    variables = {"params": {"kernel": kernel}}
    if bias:
        variables["params"]["bias"] = b
    if scale is not None:
        variables["quant"] = {key: np.float32(scale)}
    jconv = JaxQuantConv(cout, k, s, use_bias=bias, act_range=6.0)
    want = np.asarray(jax.jit(jconv.apply)(variables, jnp.asarray(
        x, jnp.bfloat16)).astype(jnp.float32))
    a_scale = (jnp.maximum(jnp.float32(scale), 1e-8) if scale is not None
               else jnp.asarray(6.0 / 127.0, jnp.float32))
    want_int = np.asarray(jax.jit(_jax_product, static_argnums=2)(
        jnp.asarray(x, jnp.bfloat16), kernel, s, a_scale))

    conv = QuantConv(cin, cout, k, s, bias=bias).eval()
    state = {"weight": torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())}
    if bias:
        state["bias"] = torch.from_numpy(b)
    if scale is not None:
        state[key] = torch.tensor(scale, dtype=torch.float32)
    conv.load_state_dict(state, strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16)
    with torch.inference_mode():
        a_scale, reciprocal = conv.act_scale(xt), None
        if a_scale is None:
            a_scale, reciprocal = conv.static_scale, conv.static_reciprocal
        got_int = conv_int8(quantize_activation(xt, a_scale, reciprocal),
                            quantize_weight(conv.weight)[0], s)
        got = conv(xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_int.numpy(), want_int)
    np.testing.assert_array_equal(_np(got.permute(0, 2, 3, 1)), want)
    assert np.abs(want_int).max() > 0


INT_MM_SHAPES = [(5, 36, 36), (8, 12, 13), (16, 1152, 36), (17, 8, 8),
                 (300, 432, 40), (1, 27, 720)]


@pytest.mark.parametrize("mkn", INT_MM_SHAPES)
def test_padded_int_mm_equals_int32_sums(mkn):
    """The zero padding that meets ``_int_mm``'s CUDA limits (M > 16, K and
    N multiples of 8) leaves the sums exact: equal to an int32 matmul,
    also at the extremes (every product 127^2 or -127^2)."""
    m, k, n = mkn
    rng = np.random.default_rng(m * k + n)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8))
    want = a.int() @ w.int().t()
    got = int_mm(a, w)
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    assert torch.equal(got, want)
    ext = torch.full((m, k), 127, dtype=torch.int8)
    sign = torch.from_numpy(rng.choice([-127, 127], (n, k)).astype(np.int8))
    assert torch.equal(int_mm(ext, sign), ext.int() @ sign.int().t())


# ------------------------------------------------- the int8 conv's operator

def _implicit_im2col(x, kernel: int, stride: int):
    """``layers.im2col`` as it was before the padding became explicit, the
    halo taken on the NHWC strip: the reference the explicit padding is
    held to."""
    if kernel == 1 and stride == 1:
        return x
    strips = spatial.current()
    if strips is not None:
        x, ph, rows = strips.halo(x, kernel, stride, dim=1)
        ho = rows[1] - rows[0]
    else:
        ph = same_pad(x.shape[1], kernel, stride)
        ho = -(-x.shape[1] // stride)
    w = x.shape[2]
    pw, wo = same_pad(w, kernel, stride), -(-w // stride)
    xp = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    taps = [xp[:, dy:dy + stride * (ho - 1) + 1:stride,
               dx:dx + stride * (wo - 1) + 1:stride]
            for dy in range(kernel) for dx in range(kernel)]
    return torch.cat(taps, dim=-1)


def _in_strips(strips: int, x: torch.Tensor, fn) -> torch.Tensor:
    """``fn`` on each of ``strips`` near-equal row strips of the NCHW
    ``x``, each in its strip's thread; the outputs joined along rows (dim
    1: the operator's NHWC)."""
    h = x.shape[2]
    sizes = [h // strips + (i < h % strips) for i in range(strips)]
    runner = SpatialRunner(["cpu"] * strips)
    try:
        return torch.cat(runner.run(lambda j, p: fn(p),
                                    list(torch.split(x, sizes, 2))), 1)
    finally:
        runner.pool.shutdown()


def _quant_conv(cin: int, cout: int, k: int, s: int, seed: int,
                bias: bool = True) -> QuantConv:
    conv = QuantConv(cin, cout, k, s, bias=bias).eval()
    conv.reset_parameters(torch.Generator().manual_seed(seed),
                          bias_value=0.25)
    return conv


@pytest.mark.parametrize("kernel,stride,height,strips", [
    (3, 1, 13, 3), (3, 2, 13, 3), (1, 2, 11, 4), (7, 2, 16, 3),
    (3, 2, 3, 4), (1, 1, 5, 3)])
def test_explicit_padding_matches_seed_im2col_in_strips(kernel, stride,
                                                        height, strips):
    """Over height strips, the operator's plain version (the halo'd rows,
    the whole map's padding given explicitly) equals the implicit-padding
    im2col under the same strips, product for product, and the whole map's
    conv row for row; ``QuantConv`` the same, bf16 for bf16."""
    rng = np.random.default_rng(kernel * 100 + height)
    conv = _quant_conv(8, 16, kernel, stride, seed=height)
    x = torch.from_numpy(rng.normal(0.0, 2.0, (2, 8, height, 10)).astype(
        np.float32)).to(torch.bfloat16)
    x_q = quantize_activation(x, conv.static_scale, conv.static_reciprocal)
    k_q, _ = quantize_weight(conv.weight)
    w2d = k_q.permute(0, 2, 3, 1).reshape(16, -1)

    def implicit_product(p):
        cols = _implicit_im2col(p.permute(0, 2, 3, 1), kernel, stride)
        n, ho, wo, kk = cols.shape
        return int_mm(cols.reshape(-1, kk), w2d).reshape(n, ho, wo, 16)

    x_qt = x_q.permute(0, 3, 1, 2)  # NCHW view of the s8 NHWC map
    with torch.inference_mode():
        want = _in_strips(strips, x_qt, implicit_product)
        got = _in_strips(strips, x_qt, lambda p: conv_int8(
            p.permute(0, 2, 3, 1), k_q, stride))
        whole = conv_int8(x_q, k_q, stride)
        assert torch.equal(got, want) and torch.equal(got, whole)
        split = _in_strips(strips, x, lambda p: conv(p).permute(0, 2, 3, 1))
        assert torch.equal(split, conv(x).permute(0, 2, 3, 1))


def test_weights_prepared_once_per_version():
    """Two forwards prepare the weights once; ``load_state_dict``, an
    in-place edit and ``.to()`` each prepare them again, and the output is
    then a fresh module's on the same weights."""
    conv = _quant_conv(16, 24, 3, 1, seed=1)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        0.0, 2.0, (2, 16, 6, 7)).astype(np.float32)).to(torch.bfloat16)

    def fresh_output():
        other = QuantConv(16, 24, 3, 1).eval()
        other.load_state_dict(conv.state_dict())
        return other(x)

    conv_s8_cuda.preparations = 0
    with torch.inference_mode():
        y = conv(x)
        assert torch.equal(conv(x), y) and conv_s8_cuda.preparations == 1
        state = conv.state_dict()
        state["weight"] = state["weight"] * 0.5
        conv.load_state_dict(state)
        y2 = conv(x)
        assert conv_s8_cuda.preparations == 2 and not torch.equal(y2, y)
    with torch.no_grad():
        conv.weight.mul_(-1.0)
    with torch.inference_mode():
        y3 = conv(x)
        assert conv_s8_cuda.preparations == 3
        assert torch.equal(y3, fresh_output())  # the fresh module's own
        assert conv_s8_cuda.preparations == 4
    conv.to(torch.float64).to(torch.float32)  # new storage, same values
    with torch.inference_mode():
        assert torch.equal(conv(x), y3) and torch.equal(conv(x), y3)
        assert conv_s8_cuda.preparations == 5
        # moved in inference mode: no version counter, prepared every call
        conv.to(torch.float64).to(torch.float32)
        assert torch.equal(conv(x), y3) and torch.equal(conv(x), y3)
        assert conv_s8_cuda.preparations == 7


def _op_args(**change):
    k_q = torch.zeros((8, 4, 3, 3), dtype=torch.int8)
    args = {"x": torch.zeros((1, 4, 6, 6), dtype=torch.bfloat16),
            "w": conv_s8_cuda.pack_weight(k_q),
            "geometry": [8, 4, 3, 3, 1, 1, 1, 1, 1, 6, 6],
            "k_scale": torch.ones(8), "bias": None,
            "a_scale": torch.tensor(0.1), "reciprocal": None}
    args.update(change)
    return args


ARG_FAULTS = {
    "x_float32": (dict(x=torch.zeros((1, 4, 6, 6))), TypeError),
    "x_3d": (dict(x=torch.zeros((4, 6, 6), dtype=torch.bfloat16)),
             ValueError),
    "x_channels": (dict(x=torch.zeros((1, 5, 6, 6), dtype=torch.bfloat16)),
                   ValueError),
    "w_dtype": (dict(w=torch.zeros((32, 64), dtype=torch.float32)),
                TypeError),
    "w_unpacked": (dict(w=torch.zeros((8, 36), dtype=torch.int8)),
                   ValueError),
    "w_strided": (dict(w=torch.zeros((64, 32), dtype=torch.int8).t()),
                  ValueError),
    "no_scale": (dict(a_scale=None), ValueError),
    "scale_shape": (dict(a_scale=torch.ones(1)), TypeError),
    "k_scale_dtype": (dict(k_scale=torch.ones(8, dtype=torch.float64)),
                      TypeError),
    "bias_shape": (dict(bias=torch.ones(7)), ValueError),
    "s8_with_scales": (dict(x=torch.zeros((1, 4, 6, 6), dtype=torch.int8)),
                       ValueError),
    "kernel_9": (dict(geometry=[8, 4, 9, 9, 1, 4, 4, 4, 4, 6, 6]),
                 ValueError),
    "reads_past": (dict(geometry=[8, 4, 3, 3, 1, 1, 0, 1, 1, 6, 6]),
                   ValueError),
    "geometry_short": (dict(geometry=[8, 4, 3, 3, 1]), ValueError),
}


@pytest.mark.parametrize("fault", sorted(ARG_FAULTS))
def test_conv_op_argument_checks(fault):
    """The checks both versions share raise on what the kernel does not
    take (the CPU's plain version raises as the card's wrapper would)."""
    change, error = ARG_FAULTS[fault]
    with pytest.raises(error):
        conv_s8_cuda.conv_s8(**_op_args(**change))
    conv_s8_cuda.conv_s8(**_op_args())  # the unchanged call is taken


def test_int8_export_records_the_conv_op(tmp_path):
    """An exported int8 program calls ``ssd_tpu_torch::conv_s8`` with each
    conv's prepared weights as its constants (no weight quantize in the
    graph) and serves what eager serves."""
    _, cfg = _configs(64, "reference", True)
    det = Detector(cfg, device="cpu")
    images = np.random.default_rng(8).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    quant.calibrate(det, [images])
    state = det.model.state_dict()
    want = det.predict(images)
    path = export.export_program(str(tmp_path / "p"), cfg, state,
                                 batch_size=2, device="cpu")
    program = torch.export.load(path)
    code = program.graph_module.code
    convs = sum(isinstance(m, QuantConv) for m in det.model.modules())
    assert code.count("ssd_tpu_torch.conv_s8") >= convs > 0
    assert "_int_mm" not in code
    packed = [k for k in program.constants if k.endswith(".packed_weight")]
    assert len(packed) == convs
    assert not any(isinstance(m, QuantConv) and "packed_weight" in m._buffers
                   for m in det.model.modules())
    got = export.load_program(path)(images)
    for k in DET_KEYS:
        assert torch.equal(got[k], getattr(want, k)), k


# ------------------------------------------------------------ int8 stem

# Measured on this sandbox's CPU (torch 2.13.0+cpu, JAX 0.9.0): every value
# of the stem output below (2 x 16 x 24 x 32) is bit-equal to JAX's, on both
# feeds. The border correction's f32 conv is the one sum here whose order
# can differ from JAX's, so the bar allows one bf16 ulp on a few values.
STEM_BIT_EQUAL = 0.999


def test_int8_stem_matches_jax_on_both_feeds():
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (2, 64, 96, 3), dtype=np.uint8)
    images[0, :16] = 128  # a flat region: the correction map alone
    kernel = rng.normal(0.0, 0.05, (3, 3, 48, 32)).astype(np.float32)
    kernel[..., 1] = 0.0
    variables = {"params": {"kernel": kernel}}
    jstem = jax.jit(JaxInt8Stem(32).apply)
    want = np.asarray(jstem(variables, images).astype(jnp.float32))
    want_packed = np.asarray(jstem(variables, jax_pack_s2d(images)).astype(
        jnp.float32))
    np.testing.assert_array_equal(want_packed, want)  # JAX's own claim

    stem = Int8FoldedS2DConv(32).eval()
    with torch.no_grad():
        stem.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
    with torch.inference_mode():
        got = stem(torch.from_numpy(images), torch.bfloat16)
        got_packed = stem(torch.from_numpy(pack_s2d(images)), torch.bfloat16)
    assert torch.equal(got, got_packed)
    got = _np(got.permute(0, 2, 3, 1))
    ulps = bf16_ulps(got, want)
    share = float((got == want).mean())
    print(f"int8 stem: {share:.5f} bit-equal to JAX, max {ulps.max()} ulps")
    assert ulps.max() <= 1.0
    assert share >= STEM_BIT_EQUAL, share


# ------------------------------------------------------------ int8 models

def _configs(size: int, schedule: str, neck: bool):
    model = dict(backbone="mobilenet", width_multiplier=0.25,
                 fpn_channels=32, head_depth=1, stem_schedule=schedule,
                 compute_dtype="int8", int8_neck=neck)
    jcfg = JaxConfig(num_classes=4, image_size=size,
                     model=JaxModelConfig(**model))
    return jcfg, Config.from_json(jcfg.to_json())


def _perturbed(jcfg, seed: int):
    """Seeded weights for ``jcfg``'s model: activation-dominated logits, so
    a clipping fault shows."""
    f32 = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, compute_dtype="float32", int8_neck=False))
    det = JaxDetector(f32)
    abstract = jax.eval_shape(lambda: det.init(jax.random.PRNGKey(0)))
    return seeded_variables(abstract, seed)


# (image size, schedule, int8_neck, bar on every raw map's largest |diff|).
# JAX runs op by op here, rounding every bf16 op as the port does; under
# jit XLA fuses the bf16 ops and its maps move by up to 0.033 from these
# (measured). Measured on this sandbox's CPU against op-by-op JAX: with the
# int8 neck the maps are bit-equal (max |diff| 0, both schedules); backbone
# only, the bf16 FPN and head's conv sums leave 0.0078125, one bf16 step
# at the maps' largest magnitude (0.93). The bar is that step.
MODEL_CASES = {
    "dense4_neck": (64, "dense4", True, 2.0 ** -7),
    "dense4_backbone_only": (64, "dense4", False, 2.0 ** -7),
    "reference_neck": (64, "reference", True, 2.0 ** -7),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_int8_model_matches_jax(case):
    size, schedule, neck, bar = MODEL_CASES[case]
    jcfg, cfg = _configs(size, schedule, neck)
    variables = _perturbed(jcfg, seed=4)
    rng = np.random.default_rng(6)
    images = rng.integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    jdet = JaxDetector(jcfg)
    if neck:
        variables, _ = jax_quant.calibrate(jdet, variables, [images])
    want = jdet.model.apply(variables, images, flatten=False, raw_input=True)
    det = Detector(cfg, convert_variables(variables, cfg), device="cpu")
    got = det.raw(images)
    worst = max(float(np.abs(_np(g) - _np(w)).max())
                for gw, ww in zip(got, want) for g, w in zip(gw, ww))
    print(f"{case}: max |diff| {worst}")
    assert worst <= bar, worst
    if schedule == "dense4":  # the packed feed: the same maps, bit for bit
        packed = det.raw(pack_s2d(images))
        for (gc, gb), (pc, pb) in zip(got, packed):
            assert torch.equal(gc, pc) and torch.equal(gb, pb)


def test_uncalibrated_neck_raises():
    _, cfg = _configs(64, "dense4", True)
    det = Detector(cfg, device="cpu")  # seeded weights, no scales
    with pytest.raises(ValueError, match="calibrated activation scale"):
        det.raw(np.zeros((1, 64, 64, 3), np.uint8))


def test_stale_calibration_wrong_resolution_raises():
    """Calibrated at 64, served at 128: the shape-keyed neck scales are
    missing for the new shapes, and the request raises rather than fall
    back to the (inapplicable) static bound."""
    _, cfg = _configs(64, "dense4", True)
    det = Detector(cfg, device="cpu")
    quant.calibrate(det, [np.full((2, 64, 64, 3), 90, np.uint8)])
    state = det.model.state_dict()
    pred = Predictor(dataclasses.replace(cfg, image_size=128), state,
                     device="cpu")
    with pytest.raises(ValueError, match="calibrated activation scale"):
        pred.predict(np.zeros((128, 128, 3), np.uint8))


def test_int8_neck_save_without_scales_raises(tmp_path):
    _, cfg = _configs(64, "dense4", True)
    state = Detector(cfg, device="cpu").model.state_dict()
    with pytest.raises(ValueError, match="quant"):
        save_npz_artifact(str(tmp_path / "x.npz"), cfg, state)
    # backbone-only int8 needs no scales
    bb = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, int8_neck=False))
    save_npz_artifact(str(tmp_path / "bb.npz"), bb, state)


def test_convert_requires_every_scale():
    """A ``quant`` collection converts one to one; a missing scale, or one
    no conv has, raises."""
    jcfg, cfg = _configs(64, "dense4", True)
    variables = _perturbed(jcfg, seed=1)
    images = np.random.default_rng(2).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    qv, _ = jax_quant.calibrate(JaxDetector(jcfg), variables, [images])
    state = convert_variables(qv, cfg)
    head = qv["quant"]["head"]["class_net"]["conv0"]
    assert float(state["head.class_net.conv0.act_scale_8x8"]) == float(
        head["act_scale_8x8"])
    with pytest.raises(ValueError, match="unfilled"):
        convert_variables(variables, cfg)  # int8_neck: scales required
    del head["act_scale_1x1"]
    with pytest.raises(ValueError, match="act_scale_1x1"):
        convert_variables(qv, cfg)
    head["act_scale_1x1"] = np.float32(0.1)
    head["act_scale_3x3"] = np.float32(0.1)
    with pytest.raises(ValueError, match="act_scale_3x3"):
        convert_variables(qv, cfg)


# ------------------------------------------------------------ percentile

PERCENTILES = np.asarray([0.0, 33.3, 50.0, 90.0, 99.0, 99.9, 100.0],
                         np.float32)


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 2 ** 24 + 3])
def test_percentile_bit_equal_to_jnp(n):
    """``jnp.percentile`` as the JAX package's calibration runs it (the
    percentile a constant of the jitted program), including above 2^24
    elements, where ``torch.quantile`` refuses, JAX's f32 index rounds and
    ``n - 1`` rounds past the last element (at p = 100)."""
    x = np.abs(np.random.default_rng(n).standard_normal(n, np.float32))
    # all seven in one jitted call: one sort of the large array
    want = np.asarray(jax.jit(lambda a: jnp.percentile(a, PERCENTILES))(x))
    if n < 2 ** 20:  # the same values as one constant percentile at a time
        np.testing.assert_array_equal(want, [jax.jit(
            lambda a: jnp.percentile(a, float(p)))(x) for p in PERCENTILES])
    xt = torch.from_numpy(x)
    for p, w in zip(PERCENTILES, want):
        got = percentile(xt, float(p))
        assert got.dtype == torch.float32
        assert got.numpy() == w, (n, p, float(got), float(w))


# ------------------------------------------------------------ sanity

def jax_sanity_int8() -> dict:
    """The JAX package's int8 sanity artifact on the CPU, as
    ``ssd_tpu.eval.sanity.evaluate_artifact_map(int8=True)`` computes it:
    its scales (flat, by path), its detections on the 32 val scenes, and
    its mAP."""
    jcfg, variables = load_inference_artifact(jax_sanity.ARTIFACT_DIR)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, compute_dtype="int8", int8_neck=True))
    det = JaxDetector(jcfg)
    cal = next(jax_sanity.sanity_batches(8, jax_sanity.SANITY_SEED_TRAIN))[0]
    variables, _ = jax_quant.calibrate(det, jax.device_get(variables), [cal])
    predict = jax.jit(det.predict)
    ev = JaxEvaluator(jcfg.num_classes)
    outs = []
    for imgs, boxes, labels, nb, valid in jax_sanity.sanity_batches(
            jax_sanity.SANITY_VAL_IMAGES, jax_sanity.SANITY_SEED_VAL):
        out = {k: np.asarray(v) for k, v in
               jax.device_get(predict(variables, imgs))._asdict().items()}
        ev.add_batch(out, boxes, labels, nb, valid=valid)
        outs.append(out)
    flat = jax.tree_util.tree_flatten_with_path(variables["quant"])[0]
    scales = {"quant/" + "/".join(p.key for p in path): np.float32(v)
              for path, v in flat}
    dets = {f"jax_int8_{k}": np.concatenate([o[k] for o in outs])
            for k in DET_KEYS}
    return {**scales, **dets,
            "jax_int8_map": np.float64(ev.result()["mAP"])}


@pytest.fixture(scope="module")
def jax_int8():
    return jax_sanity_int8()


@pytest.fixture(scope="module")
def port_int8():
    """The port's int8 sanity predictor, calibrated as the reference is."""
    return sanity.sanity_predictor(int8=True, device="cpu")


# Measured on this sandbox's CPU: the 28 FPN/head scales are within
# 1.471e-2 relative of JAX's (each is the max of a bf16 activation that the
# two compute with their own conv sums); the backbone's 11 saturate at 6/127.
CALIBRATION_RTOL = 0.03


def test_calibration_matches_jax(jax_int8, port_int8):
    want = {scale_name(k): float(v) for k, v in jax_int8.items()
            if k.startswith("quant/")}
    got = {k: float(v) for k, v in
           port_int8.detector.model.state_dict().items()
           if "act_scale_" in k}
    assert len(want) == 39 and set(got) == set(want)
    backbone = [k for k in want if k.startswith("backbone.")]
    assert len(backbone) == 11
    six = float(np.float32(6.0) / np.float32(127.0))
    for k in backbone:
        assert got[k] == six == want[k], k
    rel = max(abs(got[k] / want[k] - 1) for k in want)
    print(f"calibration: largest relative difference {rel:.3e}")
    assert rel <= CALIBRATION_RTOL


def test_calibration_scales_only_widen():
    cfg, state = load_npz_artifact(sanity.SANITY_NPZ)
    det = Detector(quant.int8_config(cfg), state, device="cpu")
    first = next(synthetic.sanity_batches(4, 11, batch=4))[0]
    assert quant.calibrate(det, [first]) == 4
    s1 = {k: v.clone() for k, v in det.model.state_dict().items()
          if "act_scale_" in k}
    quant.calibrate(det, [np.zeros((2, 128, 128, 3), np.uint8),
                          next(synthetic.sanity_batches(4, 12, batch=4))[0]])
    s2 = {k: v for k, v in det.model.state_dict().items()
          if "act_scale_" in k}
    assert set(s1) == set(s2)
    assert all(float(s2[k]) >= float(s1[k]) for k in s1)
    assert any(float(s2[k]) > float(s1[k]) for k in s1)
    # the percentile mode narrows where absmax widened
    pct = Detector(quant.int8_config(cfg), state, device="cpu")
    quant.calibrate(pct, [first], percentile=90.0)
    s3 = {k: v for k, v in pct.model.state_dict().items()
          if "act_scale_" in k}
    assert all(float(s3[k]) <= float(s1[k]) for k in s1)
    assert any(float(s3[k]) < 0.999 * float(s1[k]) for k in s1)


def _evaluate(evaluator_cls, num_classes, det: dict) -> dict:
    ev = evaluator_cls(num_classes)
    for i, (_, boxes, labels, nb, valid) in enumerate(
            synthetic.sanity_batches(sanity.SANITY_VAL_IMAGES,
                                     sanity.SANITY_SEED_VAL)):
        part = {k: v[8 * i:8 * i + 8] for k, v in det.items()}
        ev.add_batch(part, boxes, labels, nb, valid=valid)
    return ev.result()


def test_sanity_int8_map_matches_jax(jax_int8, port_int8):
    """The port's int8 mAP from its own evaluator within 0.002 of JAX's
    (the bar bf16 is held to); the port's evaluator equals JAX's exactly,
    every metric, on the same detections."""
    jax_det = {k: jax_int8[f"jax_int8_{k}"] for k in DET_KEYS}
    jax_map = float(jax_int8["jax_int8_map"])
    assert jax_map > 0.1  # the trained artifact, not noise
    port_map = float(sanity.evaluate_predictor(port_int8)["mAP"])
    print(f"sanity int8 mAP: port {port_map:.5f}, JAX {jax_map:.5f}")
    assert abs(port_map - jax_map) <= 0.002, (port_map, jax_map)
    ours = _evaluate(DetectionEvaluator, 8, jax_det)
    theirs = _evaluate(JaxEvaluator, 8, jax_det)
    assert ours["mAP"] == theirs["mAP"] == jax_map
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k], v)


def test_int8_npz_round_trip_serves(tmp_path, port_int8):
    """An int8 artifact with its scales through ``save_npz_artifact`` and
    ``Predictor.from_npz``: the same detections as the calibrated model."""
    images = next(synthetic.sanity_batches(8, 99))[0]
    cfg = port_int8.cfg
    state = port_int8.detector.model.state_dict()
    path = str(tmp_path / "int8.npz")
    save_npz_artifact(path, cfg, state)
    got_cfg, got_state = load_npz_artifact(path)
    assert got_cfg == cfg and set(got_state) == set(state)
    pred = Predictor.from_npz(path, device="cpu")
    a, b = pred.predict(images), port_int8.predict(images)
    for k in DET_KEYS:
        np.testing.assert_array_equal(a[k], b[k])
    assert int(a["num_boxes"].sum()) > 0


def test_quantize_cli(tmp_path):
    """``python -m ssd_tpu_torch.quant`` on image files, int8_neck and
    backbone-only; both artifacts serve."""
    from PIL import Image
    paths = []
    for i, img in enumerate(next(synthetic.sanity_batches(3, 5, batch=3))[0]):
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(img).save(paths[-1])
    out = str(tmp_path / "int8")
    quant.main(["--npz", sanity.SANITY_NPZ, "--output", out, "--images",
                *paths, "--batch-size", "2", "--device", "cpu"])
    cfg, state = load_artifact(out)
    assert cfg.model.compute_dtype == "int8" and cfg.model.int8_neck
    assert sum("act_scale_" in k for k in state) == 39
    bb = str(tmp_path / "bb")
    quant.main(["--npz", sanity.SANITY_NPZ, "--output", bb,
                "--backbone-only", "--device", "cpu"])
    cfg_bb, state_bb = load_artifact(bb)
    assert not cfg_bb.model.int8_neck
    assert not any("act_scale_" in k for k in state_bb)
    for path in (out, bb):
        r = Predictor.from_checkpoint(path, device="cpu").predict(
            np.zeros((128, 128, 3), np.uint8))
        assert r["boxes"].shape == (cfg.nms.max_boxes, 4)


def test_committed_asset_matches_regen(jax_int8):
    with np.load(ASSET) as z:
        got = {k: z[k] for k in z.files}
    assert set(got) == set(jax_int8)
    for k, v in jax_int8.items():
        if k.startswith("quant/"):
            np.testing.assert_allclose(got[k], v, rtol=1e-6)
    # JAX's CPU detections may move in the last bits across CPUs
    assert_set_match({k: got[f"jax_int8_{k}"] for k in DET_KEYS},
                     {k: jax_int8[f"jax_int8_{k}"] for k in DET_KEYS})
    assert abs(float(got["jax_int8_map"]) - float(jax_int8["jax_int8_map"])
               ) <= 1e-4


if __name__ == "__main__":
    if sys.argv[1:] == ["regen"]:
        arrays = jax_sanity_int8()
        np.savez_compressed(ASSET, **arrays)
        print(f"wrote {ASSET} ({os.path.getsize(ASSET)} bytes), JAX int8 "
              f"mAP {float(arrays['jax_int8_map']):.5f}")
    else:
        sys.exit("usage: python tests/test_torch_int8.py regen")
