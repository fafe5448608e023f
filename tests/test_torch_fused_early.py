"""The port's fused ds1+ds2 (K3) against the JAX package's, on the CPU.

* ``fold_convbn`` equals the JAX package's bit for bit at every block.
* The port's plain ``fused_ds1_ds2`` rounds both pointwise activations to
  bf16 and carries each pointwise weight as two bf16 terms (hi + lo), with
  f32 sums (``ops/fused_early.py`` says why not one term). It is held
  within the JAX kernel test's bars (atol 0.08, rtol 0.05, the first and
  last rows and columns on their own) of the JAX package's Pallas kernel
  run in interpret mode (which computes those products in f32) and of the
  flax ds1+ds2 blocks, and to a float64 evaluation with the same rounding
  points within one bf16 ulp.
* The edge shapes the kernel must take: one image, 16 x 16, H != W, C1 of 8
  and 16, inputs that saturate relu6; C1 = 8 padded to the tensor cores'
  K of 16 adds exact zeros.
* The wrapper's checks, on both devices, and ``tools/bench_kernels.py``'s
  K3 inputs.
* A ``cuda`` test holds the kernel to the plain version on the card at the
  card's bars (it skips here, where there is no card).
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
from ssd_tpu_torch.tools import bench_fused_early, bench_kernels
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
    kernel's row blocks, so its block edges and both image edges are in.
    Interpret mode computes the pointwise products in f32, where the port
    rounds their activations to bf16, so the two agree at the JAX bars,
    not to one ulp; the name is kept from when both were all f32."""
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
    _assert_bars(got, want)
    # measured: 230 bf16 ulps at most (on a value near 0), mean |diff|
    # 4.33e-4, 81.0% bit-equal; the bars are twice that
    assert bf16_ulps(got, want) <= 460
    assert np.abs(got - want).mean() <= 8.7e-4


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
    """The plain version is its documented function: a float64 evaluation
    with bf16 rounding at the same points (both pointwise A operands, and
    the weights as hi + lo) lands within one bf16 ulp."""
    _, _, port = half_width
    folded = fused_early.fold_early_params(port)
    x = _port_x(_x(np.random.default_rng(5), 1, 10, 12, 16))
    f64 = {k: v.double() for k, v in folded.items()}

    def bf16(t):
        return t.to(torch.bfloat16).double()

    def hi_lo(k):  # the two bf16 terms, added exactly in f64
        hi = bf16(k)
        return hi + bf16(k - hi)

    y = fused_early._depthwise(x.double(), f64["dw1_k"], f64["dw1_b"],
                               (1, 1, 1, 1), 1)
    y = torch.clamp(torch.einsum("nchw,co->nohw", bf16(y), hi_lo(f64["pw1_k"]))
                    + f64["pw1_b"].view(1, -1, 1, 1), 0, 6)
    z = fused_early._depthwise(y, f64["dw2_k"], f64["dw2_b"], (0, 1, 0, 1), 2)
    z = torch.clamp(torch.einsum("nchw,co->nohw", bf16(z), hi_lo(f64["pw2_k"]))
                    + f64["pw2_b"].view(1, -1, 1, 1), 0, 6)
    got = fused_early.fused_ds1_ds2_plain(x, folded)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert bf16_ulps(_nhwc(got), _nhwc(z.float())) <= 1.0


def test_plain_rounds_at_the_pointwise_operands(half_width):
    """The rounding points matter, and are exactly these: the plain version
    differs from the all-f32 function, and equals the same ops spelled with
    ``.bfloat16().float()`` at pw1's and pw2's inputs, each weight as the
    sum of its two bf16 terms, product by product."""
    _, _, port = half_width
    folded = fused_early.fold_early_params(port)
    x = _port_x(_x(np.random.default_rng(6), 2, 16, 20, 16))

    def pointwise(a, k, b, rounded):
        if not rounded:
            return torch.clamp(torch.einsum("nchw,co->nohw", a, k)
                               + b.view(1, -1, 1, 1), 0, 6)
        a = a.bfloat16().float()
        hi = k.bfloat16().float()
        lo = (k - hi).bfloat16().float()
        acc = a[:, 0:1] * hi[0].view(1, -1, 1, 1)
        acc = acc + a[:, 0:1] * lo[0].view(1, -1, 1, 1)
        for c in range(1, k.shape[0]):
            acc = acc + a[:, c:c + 1] * hi[c].view(1, -1, 1, 1)
            acc = acc + a[:, c:c + 1] * lo[c].view(1, -1, 1, 1)
        return torch.clamp(acc + b.view(1, -1, 1, 1), 0, 6)

    def spelled(rounded: bool) -> torch.Tensor:
        y = fused_early._depthwise(x.float(), folded["dw1_k"], folded["dw1_b"],
                                   (1, 1, 1, 1), 1)
        y = pointwise(y, folded["pw1_k"], folded["pw1_b"], rounded)
        z = fused_early._depthwise(y, folded["dw2_k"], folded["dw2_b"],
                                   (0, 1, 0, 1), 2)
        z = pointwise(z, folded["pw2_k"], folded["pw2_b"], rounded)
        return z.to(torch.bfloat16)

    got = fused_early.fused_ds1_ds2_plain(x, folded)
    assert torch.equal(got, spelled(True))
    all_f32 = spelled(False)
    assert (got != all_f32).float().mean() > 0.05
    assert torch.allclose(got.float(), all_f32.float(), **BARS)


def test_k_padding_at_c1_8_adds_exact_zeros():
    """The kernel pads K = C1 = 8 to the tensor cores' 16 with zero
    channels: C1 = 8 passes the wrapper's checks, and the same function
    with 8 zero channels appended to x, the taps, the biases and pw1's rows
    gives the same output bit for bit. A width that is not a multiple of 8
    is refused."""
    port = bench_fused_early.reference_backbone(0.25, seed=2, device="cpu")
    bench_fused_early.randomize_early_bn(port, seed=7)
    folded = fused_early.fold_early_params(port)
    assert folded["pw1_k"].shape == (8, 16)
    x = _port_x(_x(np.random.default_rng(8), 2, 12, 18, 8))
    assert fused_early_cuda.check_inputs(x, folded) == (8, 16, 32)
    got = fused_early_cuda.fused_ds1_ds2(x, folded)

    def pad(t):  # the channel axis of every C1-sized operand to 16
        return torch.cat([t, torch.zeros_like(t)], dim=0).contiguous()

    padded = {**folded, "dw1_k": pad(folded["dw1_k"]),
              "dw1_b": pad(folded["dw1_b"]), "pw1_k": pad(folded["pw1_k"])}
    x16 = torch.cat([x, torch.zeros_like(x)], dim=1).contiguous(
        memory_format=torch.channels_last)
    assert torch.equal(fused_early_cuda.fused_ds1_ds2(x16, padded), got)

    odd = {**folded, "pw2_k": folded["pw2_k"][:, :20].contiguous(),
           "pw2_b": folded["pw2_b"][:20].contiguous()}
    with pytest.raises(ValueError, match="multiple of 8"):
        fused_early_cuda.check_inputs(x, odd)


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

def test_bench_kernels_k3_inputs_and_lib_checks():
    """``tools/bench_kernels.py``'s K3 inputs at a small size on the CPU,
    and the kernel wrapper's ``lib`` argument, which only CUDA tensors
    take."""
    backbone, x, folded = bench_kernels.early_inputs(
        "cpu", batch=2, size=16, width=0.25)
    assert x.shape == (2, 8, 16, 16) and x.dtype == torch.bfloat16
    assert x.is_contiguous(memory_format=torch.channels_last)
    assert set(folded) == set(fused_early.FOLDED_KEYS)
    # batch norm is randomized as chip_smoke draws it, so the fold is not
    # the identity
    bn = backbone.ds1.pointwise.bn
    assert not torch.allclose(bn.running_var, torch.ones_like(bn.running_var))
    out = fused_early_cuda.fused_ds1_ds2(x, folded)
    assert out.shape == (2, 32, 8, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_early_cuda.fused_ds1_ds2_cuda(x, folded, lib=object())


# ------------------------------------------------------------------ on the card

@pytest.mark.cuda
def test_kernel_equals_plain_on_the_card():
    """At the card's bars (``chip_smoke.check_early_case``): the JAX bars
    overall and on the first and last rows and columns, and at least 95%
    of the elements bit-equal there."""
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
        chip_smoke.hold_to_plain(got, want, (width, n, h, w))
