"""The port's model modules against the JAX package's flax modules, on CPU.

Weights are seeded numpy values poured into the flax tree's shapes
(``jax.eval_shape``), converted by ``ssd_tpu_torch.convert``, and run through
both. f32 is held at the golden bars (atol 2e-4, rtol 2e-3, as
``tests/test_golden.py``): the two differ only in summation order. bf16 is
held looser, with the bar stated at each comparison.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssd_tpu.config import Config as JaxConfig
from ssd_tpu.models.detector import Detector as JaxDetector
from ssd_tpu.models.fpn import FPN as JaxFPN
from ssd_tpu.models.fpn import RetinaHead as JaxRetinaHead
from ssd_tpu.models.layers import DepthwiseSeparable as JaxDS
from ssd_tpu.models.mobilenet import Dense4Stem as JaxDense4Stem
from ssd_tpu.ops.ingest import pack_s2d as jax_pack_s2d
from ssd_tpu_torch.config import Config
from ssd_tpu_torch.convert import convert_variables
from ssd_tpu_torch.models.detector import SSDModel
from ssd_tpu_torch.models.fpn import FPN, RetinaHead
from ssd_tpu_torch.models.layers import DepthwiseSeparable, same_pad
from ssd_tpu_torch.models.mobilenet import Dense4Stem

FLAGSHIP = "configs/coco_mobilenet_640_flagship.json"
GOLDEN_BARS = dict(atol=2e-4, rtol=2e-3)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def seeded_variables(abstract, seed: int, class_bias: float | None = None):
    """Fill a flax variable tree's shapes with seeded numpy f32 values:
    kernels normal with std 1/sqrt(fan_in), batch-norm scale and variance
    in [0.5, 1.5], biases and means normal with std 0.1."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = rng.normal(0.0, 1.0 / math.sqrt(np.prod(shape[:-1])), shape)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.normal(0.0, 0.1, shape)
        return v.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, abstract)
    if class_bias is not None:
        tree["params"]["head"]["class_net"]["predict"]["bias"][:] = class_bias
    return tree


def _module_variables(module, *args, seed=0, **kwargs):
    abstract = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    return seeded_variables(abstract, seed)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return _np(t.permute(0, 2, 3, 1))


def _close(got, want, dtype: str, bf16_atol: float, bf16_rtol: float):
    if dtype == "float32":
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   **GOLDEN_BARS)
    else:
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=bf16_atol, rtol=bf16_rtol)


# ------------------------------------------------------------------ weights

def _flagship_variables():
    cfg = JaxConfig.load(FLAGSHIP)
    abstract = jax.eval_shape(
        lambda: JaxDetector(cfg).init(jax.random.PRNGKey(0)))
    return seeded_variables(abstract, seed=3)


def test_convert_accounts_for_every_flagship_leaf():
    variables = _flagship_variables()
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    cfg = Config.load(FLAGSHIP)
    state = convert_variables(variables, cfg)
    assert n_leaves == len(state) == 151
    assert sum(v.numel() for v in state.values()) == 7_323_636
    model = SSDModel(cfg)
    model.load_state_dict(state, strict=True)
    k = variables["params"]["backbone"]["ds5"]["depthwise"]["conv"]["kernel"]
    np.testing.assert_array_equal(
        model.backbone.ds5.depthwise.conv.weight.detach().numpy(),
        k.transpose(3, 2, 0, 1))  # (3, 3, 1, C) -> (C, 1, 3, 3)
    np.testing.assert_array_equal(
        model.backbone.stem.bn.running_var.numpy(),
        variables["batch_stats"]["backbone"]["stem"]["bn"]["var"])


@pytest.mark.parametrize("change", ["extra", "missing", "shape"])
def test_convert_rejects_mismatched_trees(change):
    variables = _flagship_variables()
    head = variables["params"]["head"]["box_net"]
    if change == "extra":
        head["conv9"] = {"kernel": np.zeros((3, 3, 128, 128), np.float32)}
    elif change == "missing":
        del head["conv3"]
    else:
        head["conv3"]["bias"] = np.zeros((64,), np.float32)
    with pytest.raises(ValueError, match="does not match"):
        convert_variables(variables, Config.load(FLAGSHIP))


def test_same_pad_matches_xla_split():
    assert same_pad(10, 3, 2) == (0, 1)  # even input, stride 2
    assert same_pad(9, 3, 2) == (1, 1)   # odd input, stride 2
    assert same_pad(1, 3, 2) == (1, 1)
    assert same_pad(7, 3, 1) == (1, 1)
    assert same_pad(8, 1, 1) == (0, 0)


# ------------------------------------------------------------------ modules

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(32, 48), (16, 16)])  # probe / full border map
@pytest.mark.parametrize("feed", ["raw", "packed"])
def test_dense4_stem_matches(rng, dtype, hw, feed):
    jmod = JaxDense4Stem(32, compute_dtype=dtype, fold_normalize=True)
    images = rng.integers(0, 256, (2, *hw, 3)).astype(np.uint8)
    x = images if feed == "raw" else jax_pack_s2d(images)
    variables = _module_variables(jmod, x)
    want = jmod.apply(variables, x)
    tmod = Dense4Stem(32, fold_normalize=True).eval()  # JAX applies in eval mode
    tmod.load_state_dict(convert_variables(variables, tmod), strict=True)
    got = _nhwc(tmod(torch.from_numpy(x), DTYPES[dtype]))
    # bf16: the output (ReLU6, <= 6) is one bf16 rounding of an f32 value
    # both compute the same way up to summation order, so the two may land
    # on neighbouring bf16 values: 2^-5 apart near 6.
    _close(got, want, dtype, bf16_atol=2 ** -5, bf16_rtol=0)


def test_dense4_stem_unfolded_matches(rng):
    """fold_normalize=False: the stem takes an already normalized image."""
    jmod = JaxDense4Stem(16, compute_dtype="float32")
    x = rng.normal(0.0, 1.0, (2, 24, 20, 3)).astype(np.float32)
    variables = _module_variables(jmod, x)
    tmod = Dense4Stem(16, fold_normalize=False).eval()  # JAX applies in eval mode
    tmod.load_state_dict(convert_variables(variables, tmod), strict=True)
    got = _nhwc(tmod(torch.from_numpy(x), torch.float32))
    _close(got, jmod.apply(variables, x), "float32", 0, 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(10, 14), (9, 11)])  # SAME 0/1 and 1/1
def test_depthwise_separable_stride2_matches(rng, dtype, hw):
    jmod = JaxDS(24, strides=2, compute_dtype=dtype)
    x = rng.uniform(0.0, 6.0, (2, *hw, 16)).astype(np.float32)
    xj = jnp.asarray(x, jnp.dtype(dtype))
    variables = _module_variables(jmod, xj)
    want = jmod.apply(variables, xj)
    tmod = DepthwiseSeparable(16, 24, 2).eval()  # JAX applies in eval mode
    tmod.load_state_dict(convert_variables(variables, tmod), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(DTYPES[dtype])
    got = _nhwc(tmod(xt))
    assert got.shape == want.shape
    # bf16: two convs, each rounded to bf16 before its batch norm; one
    # rounding apart before the pointwise conv moves its output by a few
    # bf16 steps (2^-5 near 6).
    _close(got, want, dtype, bf16_atol=2 ** -3, bf16_rtol=0)


def _pyramid_inputs(rng, sizes, channels):
    return [rng.uniform(0.0, 6.0, (2, h, w, c)).astype(np.float32)
            for (h, w), c in zip(sizes, channels)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sizes", [[(8, 8), (4, 4), (2, 2)],
                                   [(7, 9), (4, 5), (2, 3)]])  # not exactly 2x
def test_fpn_matches(rng, dtype, sizes):
    channels = (24, 32, 48)
    c3, c4, c5 = _pyramid_inputs(rng, sizes, channels)
    jdt = jnp.dtype(dtype)
    feats = {"c3": jnp.asarray(c3, jdt), "c4": jnp.asarray(c4, jdt),
             "c5": jnp.asarray(c5, jdt)}
    jmod = JaxFPN(16, compute_dtype=dtype)
    variables = _module_variables(jmod, feats)
    want = jmod.apply(variables, feats)
    tmod = FPN(channels, 16)
    tmod.load_state_dict(convert_variables(variables, tmod), strict=True)
    to_t = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).to(DTYPES[dtype])  # noqa: E731
    got = tmod({"c3": to_t(c3), "c4": to_t(c4), "c5": to_t(c5)})
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        # bf16: sums of up to 9*48 bf16 products rounded once per conv
        # (values of a few units): 2^-4 absolute and 2% relative.
        _close(_nhwc(g), w, dtype, bf16_atol=2 ** -4, bf16_rtol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_retina_head_matches(rng, dtype):
    sizes = [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]
    pyramid = [rng.normal(0.0, 1.0, (2, h, w, 16)).astype(np.float32)
               for h, w in sizes]
    jdt = jnp.dtype(dtype)
    jpyr = [jnp.asarray(p, jdt) for p in pyramid]
    jmod = JaxRetinaHead(num_classes=3, anchors_per_cell=9, depth=2,
                         channels=16, compute_dtype=dtype)
    variables = _module_variables(jmod, jpyr, flatten=False)
    want = jmod.apply(variables, jpyr, flatten=False)
    tmod = RetinaHead(16, 3, 9, depth=2, channels=16)
    tmod.load_state_dict(convert_variables(variables, tmod), strict=True)
    got = tmod([torch.from_numpy(p).permute(0, 3, 1, 2).to(DTYPES[dtype])
                for p in pyramid])
    for (gc, gb), (wc, wb) in zip(got, want):
        assert tuple(gc.shape) == wc.shape and tuple(gb.shape) == wb.shape
        # bf16: three convs deep, each output rounded to bf16.
        _close(_np(gc), wc, dtype, bf16_atol=2 ** -4,
               bf16_rtol=2e-2)
        _close(_np(gb), wb, dtype, bf16_atol=2 ** -4,
               bf16_rtol=2e-2)
