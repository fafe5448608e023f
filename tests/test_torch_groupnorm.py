"""Group norm, channel shuffle, the SAME max-pool, large SAME kernels and
the space-to-depth stem of the port against the JAX package's, on the CPU.

* ``GroupNorm`` against ``flax.linen.GroupNorm`` as the JAX package builds
  it (``_num_groups(C)`` groups, eps 1e-3, f32 statistics with the fast
  variance): on saturated inputs (mean 6, spread 0.05, where a two-pass
  variance differs), at 116 channels (29 groups), 24 (24) and 128 (32), in
  f32 and bf16;
* ``channel_shuffle`` and ``max_pool_same`` against ``channel_shuffle`` and
  ``nn.max_pool(..., "SAME")``, exactly;
* the 7x7/2 conv and the 5x5/2 depthwise conv, whose SAME padding is
  asymmetric on an even input, against flax's ``nn.Conv``;
* MobileNet-v1 0.25 with ``norm="group"`` on both stem schedules, and
  MobileNet-v2 0.25 with ``stem_space_to_depth``, in the whole detector at
  the bars of ``tests/test_torch_backbones.py``.
"""

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tpu.models.layers import _num_groups
from ssd_tpu.models.layers import channel_shuffle as jax_channel_shuffle
from ssd_tpu_torch.models.layers import (Conv, GroupNorm, channel_shuffle,
                                         max_pool_same, num_groups)
from tests.test_torch_backbones import (Case, check_bf16, check_f32,
                                        check_loss_and_grads,
                                        torch_threads)  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
VARIANTS = {
    "mobilenet_group_reference": dict(backbone="mobilenet",
                                      width_multiplier=0.25, norm="group",
                                      stem_schedule="reference"),
    "mobilenet_group_dense4": dict(backbone="mobilenet",
                                   width_multiplier=0.25, norm="group",
                                   stem_schedule="dense4"),
    "mobilenet_v2_space_to_depth": dict(backbone="mobilenet_v2",
                                        width_multiplier=0.25,
                                        stem_space_to_depth=True),
}


def _nchw(x: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))
                            ).to(dtype)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("channels", [116, 24, 128])
def test_num_groups_matches(channels):
    assert num_groups(channels) == _num_groups(channels)
    assert GroupNorm(channels).groups == _num_groups(channels)


def _group_norms(x: np.ndarray, dtype: str, seed: int):
    """(port, flax, float64 truth, torch.group_norm) of ``x`` NHWC."""
    channels = x.shape[-1]
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.5, 1.5, channels).astype(np.float32)
    bias = rng.normal(0, 0.1, channels).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    g = _num_groups(channels)
    jmod = fnn.GroupNorm(num_groups=g, epsilon=1e-3, dtype=jdt,
                         param_dtype=jnp.float32)
    want = np.asarray(jmod.apply({"params": {"scale": scale, "bias": bias}},
                                 jnp.asarray(x, jdt)), np.float32)
    gn = GroupNorm(channels)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(bias))
        got = _nhwc(gn(_nchw(x, tdt)))
        two_pass = _nhwc(torch.nn.functional.group_norm(
            _nchw(x, torch.float32), g, gn.weight, gn.bias, 1e-3))
    xd = x.astype(np.float64).reshape(*x.shape[:-1], g, channels // g)
    mean = xd.mean(axis=(1, 2, 4), keepdims=True)
    var = np.square(xd).mean(axis=(1, 2, 4), keepdims=True) - mean ** 2
    truth = ((xd - mean) / np.sqrt(var + 1e-3)).reshape(x.shape)
    return got, want, truth * scale + bias, two_pass


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels", [116, 24, 128])
def test_group_norm_matches_flax(dtype, channels):
    """On well-conditioned inputs: f32 within 1e-5 (statistics summed in
    another order), bf16 within one bf16 step of the output (2^-7
    relative)."""
    rng = np.random.default_rng(channels)
    x = rng.normal(0.5, 2.0, (2, 6, 10, channels))
    x = np.asarray(jnp.asarray(x, DTYPES[dtype][0]).astype(jnp.float32))
    got, want, _, _ = _group_norms(x, dtype, channels)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=2 ** -7, rtol=2 ** -7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels", [116, 24, 128])
def test_group_norm_fast_variance_on_saturated_inputs(dtype, channels):
    """Mean 6, spread 0.05: flax's fast variance ``E[x^2] - E[x]^2`` in f32
    cancels, so each framework's output is off the float64 truth by the
    rounding of its own sums (measured in f32: JAX 0.011-0.026, the port
    0.004-0.007; torch's two-pass ``group_norm`` 2e-5). The port computes
    flax's function: it is off the truth by more than the two-pass variance
    is, and by no more than JAX is (plus, in bf16, one output step)."""
    rng = np.random.default_rng(channels)
    x = rng.normal(6.0, 0.05, (2, 6, 10, channels))
    x = np.asarray(jnp.asarray(x, DTYPES[dtype][0]).astype(jnp.float32))
    got, want, truth, two_pass = _group_norms(x, dtype, channels)
    err = {"port": np.abs(got - truth).max(),
           "jax": np.abs(want - truth).max(),
           "two_pass": np.abs(two_pass - truth).max()}
    step = 0.0 if dtype == "float32" else 2 ** -7 * np.abs(truth).max()
    assert err["port"] <= err["jax"] + step, err
    assert err["port"] > 10 * err["two_pass"], err


def test_group_norm_has_no_running_statistics():
    gn = GroupNorm(32)
    x = torch.randn(2, 32, 4, 4)
    assert not list(gn.buffers())
    assert torch.equal(gn.train()(x), gn.eval()(x))


@pytest.mark.parametrize("channels", [48, 116, 12])
def test_channel_shuffle_matches(channels):
    x = np.random.default_rng(0).normal(size=(2, 3, 5, channels)).astype(
        np.float32)
    want = np.asarray(jax_channel_shuffle(jnp.asarray(x), 2))
    got = _nhwc(channel_shuffle(_nchw(x, torch.float32), 2))
    np.testing.assert_array_equal(got, want)
    j, i = 3, 1  # output channel j * 2 + i is input channel i * C/2 + j
    np.testing.assert_array_equal(got[..., j * 2 + i],
                                  x[..., i * (channels // 2) + j])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(16, 16), (15, 9), (2, 2), (1, 3)])
def test_max_pool_same_matches(dtype, hw):
    x = np.random.default_rng(1).normal(size=(2, *hw, 5)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    want = np.asarray(fnn.max_pool(jnp.asarray(x, jdt), (3, 3), (2, 2),
                                   "SAME"), np.float32)
    got = _nhwc(max_pool_same(_nchw(x, tdt)))
    np.testing.assert_array_equal(got, want)


def test_max_pool_same_is_not_symmetric_padding():
    """On an even input the SAME pool pads 0 before and 1 after; torch's
    ``padding=1`` pads both sides and shifts every window."""
    y = -torch.arange(16.0).reshape(1, 1, 4, 4)
    same = max_pool_same(y)[0, 0]
    assert same.tolist() == [[0.0, -2.0], [-8.0, -10.0]]
    assert not torch.equal(same, torch.nn.functional.max_pool2d(
        y, 3, 2, 1)[0, 0])


@pytest.mark.parametrize("kernel,groups,hw", [(7, 1, (20, 20)),
                                              (5, 8, (16, 14)),
                                              (7, 1, (13, 10))])
def test_large_same_kernels_match_flax(kernel, groups, hw):
    """ResNet-50's 7x7/2 stem and EfficientNet's 5x5/2 depthwise conv pad
    (2, 3) and (1, 2) on an even input: XLA's SAME split per axis."""
    rng = np.random.default_rng(kernel)
    cin, cout = 8, 8 if groups > 1 else 16
    x = rng.normal(size=(2, *hw, cin)).astype(np.float32)
    k = rng.normal(size=(kernel, kernel, cin // groups, cout)).astype(
        np.float32)
    jconv = fnn.Conv(cout, (kernel, kernel), strides=(2, 2), padding="SAME",
                     feature_group_count=groups, use_bias=False)
    want = np.asarray(jconv.apply({"params": {"kernel": k}}, jnp.asarray(x)))
    conv = Conv(cin, cout, kernel, 2, groups, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
        got = _nhwc(conv(_nchw(x, torch.float32)))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def variants():
    return {}


def _variant(variants: dict, name: str) -> Case:
    if name not in variants:
        variants[name] = Case(VARIANTS[name])
    return variants[name]


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_raw_maps_f32(variants, name):
    check_f32(_variant(variants, name), False)
    if "group" not in name:
        check_f32(_variant(variants, name), True)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_raw_maps_bf16_within_jax_bf16_noise(variants, name):
    check_bf16(_variant(variants, name), False)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_loss_and_gradients_f32(variants, name):
    check_loss_and_grads(_variant(variants, name))


def test_group_norm_model_has_no_batch_stats(variants):
    case = _variant(variants, "mobilenet_group_dense4")
    assert "batch_stats" not in case.variables
    det = case.port()
    assert not any("running" in k for k in det.model.state_dict())
    assert det.model.backbone.stem.gn is not None
    assert det.model.backbone.stem.bn is None
