"""The port's fused ds1+ds2 (K3) against the JAX package's, on the CPU.

* ``fold_convbn`` equals the JAX package's bit for bit at every block.
* The port's plain ``fused_ds1_ds2`` is within one bf16 ulp of the JAX
  package's Pallas kernel run in interpret mode (both compute in f32 and
  round once; only the pointwise sums' order differs), and within the JAX
  kernel test's bars of the flax ds1+ds2 blocks (atol 0.08, rtol 0.05, the
  first and last rows on their own).
* The edge shapes the kernel must take: one image, 16 x 16, H != W, C1 of 8
  and 16, inputs that saturate relu6.
* The wrapper's checks, on both devices.
* A ``cuda`` test holds the kernel to the plain version on the card (it
  skips here, where there is no card).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssd_tpu.constants import BATCH_NORM_EPSILON
from ssd_tpu.ops import fused_early as jax_fused_early
import chip_smoke
from ssd_tpu_torch.convert import convert_variables
from ssd_tpu_torch.models.mobilenet import MobileNetV1, _width
from ssd_tpu_torch.ops import fused_early, fused_early_cuda
from ssd_tpu_torch.tools import bench_fused_early
from tests.test_fused_early import (_randomized_backbone_vars,
                                    _reference_ds1_ds2)

BARS = dict(atol=0.08, rtol=0.05)  # tests/test_fused_early.py's


def _backbones(width: float, seed: int = 0, gain: float = 1.0):
    """JAX's backbone (params, stats) with randomized ds1/ds2 batch norm,
    and the port's reference-schedule backbone holding the same values.
    ``gain`` multiplies the pointwise batch-norm scales of both blocks."""
    params, stats = _randomized_backbone_vars(np.random.default_rng(seed),
                                              width=width)
    for ds in ("ds1", "ds2"):
        params[ds]["pointwise"]["bn"]["scale"] *= np.float32(gain)
    port = MobileNetV1(width, "reference").eval()
    port.load_state_dict(convert_variables(
        {"params": params, "batch_stats": stats}, port), strict=True)
    return params, stats, port


@pytest.fixture(scope="module")
def half_width():
    return _backbones(0.5)


def _x(rng, n, h, w, c1, scale=1.5) -> np.ndarray:
    """NHWC f32 values already on the bf16 grid."""
    x = rng.normal(0.0, scale, (n, h, w, c1)).astype(np.float32)
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _port_x(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> the port's (N, C, H, W) bf16 in channels_last."""
    return torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


def bf16_ulps(got: np.ndarray, want: np.ndarray) -> float:
    """``chip_smoke.bf16_ulps``, the card's measure, on numpy arrays."""
    return chip_smoke.bf16_ulps(torch.from_numpy(got), torch.from_numpy(want))


def _assert_bars(got: np.ndarray, want: np.ndarray):
    np.testing.assert_allclose(got, want, **BARS)
    np.testing.assert_allclose(got[:, 0], want[:, 0], **BARS)
    np.testing.assert_allclose(got[:, -1], want[:, -1], **BARS)
    np.testing.assert_allclose(got[:, :, 0], want[:, :, 0], **BARS)
    np.testing.assert_allclose(got[:, :, -1], want[:, :, -1], **BARS)


# ------------------------------------------------------------------ the fold

def test_fold_convbn_bit_equal_to_jax(half_width):
    params, stats, port = half_width
    got = fused_early.fold_early_params(port)
    for ds, n in (("ds1", 1), ("ds2", 2)):
        for part, tag in (("depthwise", "dw"), ("pointwise", "pw")):
            k, b = jax_fused_early.fold_convbn(
                {"conv": params[ds][part]["conv"],
                 "bn": {**params[ds][part]["bn"], **stats[ds][part]["bn"]}},
                BATCH_NORM_EPSILON)
            if tag == "dw":
                k = k[:, :, 0, :].transpose(2, 0, 1)  # (3, 3, 1, C) -> (C, 3, 3)
            else:
                k = k[0, 0]  # (1, 1, C_in, C_out) -> (C_in, C_out)
            np.testing.assert_array_equal(got[f"{tag}{n}_k"].numpy(), k)
            np.testing.assert_array_equal(got[f"{tag}{n}_b"].numpy(), b)
            assert got[f"{tag}{n}_k"].dtype == torch.float32


def test_fold_takes_a_state_dict(half_width):
    _, _, port = half_width
    a = fused_early.fold_early_params(port)
    b = fused_early.fold_early_params(port.state_dict())
    assert set(a) == set(b) == set(fused_early.FOLDED_KEYS)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ------------------------------------------------------------------ the function

def test_plain_within_one_ulp_of_jax_interpret_kernel(half_width):
    """At width 0.5 (C1 16, C2 32, C3 64), 2 x 32 x 32: two of the TPU
    kernel's row blocks, so its block edges and both image edges are in."""
    params, stats, port = half_width
    x = _x(np.random.default_rng(1), 2, 32, 32, 16)
    folded = jax_fused_early.fold_early_params(
        {"params": {"backbone": params}, "batch_stats": {"backbone": stats}},
        BATCH_NORM_EPSILON, w_img=32)
    want = np.asarray(jax_fused_early.fused_ds1_ds2(
        jnp.asarray(x, jnp.bfloat16), folded, interpret=True), np.float32)
    got = _nhwc(fused_early_cuda.fused_ds1_ds2(
        _port_x(x), fused_early.fold_early_params(port)))
    assert got.shape == want.shape == (2, 16, 16, 64)
    assert (got > 0).mean() > 0.3  # live
    assert bf16_ulps(got, want) <= 1.0


@pytest.mark.parametrize("width", [1.0, 0.5])
def test_plain_matches_flax_blocks(width, half_width):
    params, stats, port = half_width if width == 0.5 else _backbones(width)
    c1 = _width(32, width)
    x = _x(np.random.default_rng(0), 2, 32, 32, c1)
    want = np.asarray(_reference_ds1_ds2(params, stats, jnp.asarray(x), width))
    got = _nhwc(fused_early_cuda.fused_ds1_ds2(
        _port_x(x), fused_early.fold_early_params(port)))
    assert got.shape == want.shape == (2, 16, 16, _width(128, width))
    _assert_bars(got, want)


@pytest.mark.parametrize("case", ["n1", "16x16", "48x80", "c1_8", "c1_16",
                                  "saturated"])
def test_edge_shapes_match_flax_blocks(case):
    width = {"c1_8": 0.25, "c1_16": 0.5}.get(case, 0.25)
    n, h, w = {"n1": (1, 32, 32), "16x16": (2, 16, 16),
               "48x80": (2, 48, 80)}.get(case, (2, 24, 40))
    scale, gain = (100.0, 8.0) if case == "saturated" else (1.5, 1.0)
    params, stats, port = _backbones(width, seed=3, gain=gain)
    x = _x(np.random.default_rng(4), n, h, w, _width(32, width), scale)
    want = np.asarray(_reference_ds1_ds2(params, stats, jnp.asarray(x), width))
    got = _nhwc(fused_early_cuda.fused_ds1_ds2(
        _port_x(x), fused_early.fold_early_params(port)))
    assert got.shape == want.shape == (n, h // 2, w // 2, _width(128, width))
    _assert_bars(got, want)
    if case == "saturated":  # relu6 clamps at both ends of the output
        assert (got == 6).mean() > 0.05 and (got == 0).mean() > 0.05


def test_plain_rounds_once_from_f32_ops(half_width):
    """The plain version is its documented op order: a float64 evaluation
    of the same function lands within one bf16 ulp."""
    _, _, port = half_width
    folded = fused_early.fold_early_params(port)
    x = _port_x(_x(np.random.default_rng(5), 1, 10, 12, 16))
    f64 = {k: v.double() for k, v in folded.items()}
    y = fused_early._depthwise(x.double(), f64["dw1_k"], f64["dw1_b"],
                               (1, 1, 1, 1), 1)
    y = torch.clamp(torch.einsum("nchw,co->nohw", y, f64["pw1_k"])
                    + f64["pw1_b"].view(1, -1, 1, 1), 0, 6)
    z = fused_early._depthwise(y, f64["dw2_k"], f64["dw2_b"], (0, 1, 0, 1), 2)
    z = torch.clamp(torch.einsum("nchw,co->nohw", z, f64["pw2_k"])
                    + f64["pw2_b"].view(1, -1, 1, 1), 0, 6)
    got = fused_early.fused_ds1_ds2_plain(x, folded)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert bf16_ulps(_nhwc(got), _nhwc(z.float())) <= 1.0


# ------------------------------------------------------------------ the wrapper

def test_wrapper_rejects_what_the_kernel_does_not_take(half_width):
    _, _, port = half_width
    folded = fused_early.fold_early_params(port)
    x = _port_x(np.zeros((1, 8, 8, 16), np.float32))
    fused_early_cuda.fused_ds1_ds2(x, folded)  # the valid call
    with pytest.raises(TypeError, match="bfloat16"):
        fused_early_cuda.fused_ds1_ds2(x.float(), folded)
    with pytest.raises(ValueError, match="channels_last"):
        fused_early_cuda.fused_ds1_ds2(x.contiguous(), folded)
    with pytest.raises(ValueError, match="even"):
        fused_early_cuda.fused_ds1_ds2(x[:, :, :7], folded)
    with pytest.raises(ValueError, match="dw1_k"):
        fused_early_cuda.fused_ds1_ds2(
            _port_x(np.zeros((1, 8, 8, 8), np.float32)), folded)
    with pytest.raises(TypeError, match="pw2_k"):
        fused_early_cuda.fused_ds1_ds2(
            x, {**folded, "pw2_k": folded["pw2_k"].double()})


def test_bench_tool_runs_its_path_on_cpu():
    """The entry point's pieces at a small size on the CPU (its timing
    needs the card)."""
    backbone = bench_fused_early.reference_backbone(0.25, seed=0, device="cpu")
    x = bench_fused_early.make_input(2, 16, 8, seed=0, device="cpu")
    assert x.dtype == torch.bfloat16 and x.shape == (2, 8, 16, 16)
    assert x.is_contiguous(memory_format=torch.channels_last)
    row = bench_fused_early.run(backbone, x, iters=0)
    assert row["shape_out"] == [2, 32, 8, 8]
    assert row["max_abs_diff"] < 0.25  # bf16 modules, each conv rounded
    with pytest.raises(RuntimeError, match="card"):
        bench_fused_early.run(backbone, x, iters=1)


# ------------------------------------------------------------------ on the card

@pytest.mark.cuda
def test_kernel_equals_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    rng = np.random.default_rng(0)
    for width, (n, h, w) in ((1.0, (2, 64, 64)), (0.5, (1, 16, 16)),
                             (0.25, (2, 48, 80))):
        backbone = bench_fused_early.reference_backbone(width, seed=1)
        folded = fused_early.fold_early_params(backbone)
        x = _port_x(_x(rng, n, h, w, _width(32, width), 4.0)).cuda()
        got = fused_early_cuda.fused_ds1_ds2_cuda(x, folded)
        want = fused_early.fused_ds1_ds2_plain(x, folded)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (width, n, h, w)
