"""The lean train-mode norms and ``model.remat_early`` on the CPU.

* ``BatchNorm`` in train mode keeps only its input for the backward and
  recomputes its f32 arithmetic there (``models/layers._Recomputed``). Its
  output, its input, weight and bias gradients and its running statistics
  are bit-equal to the norm it replaced (``plain_batch_norm`` below, the
  op sequence as it was), in bf16 and f32 and on saturated inputs; the
  same for ``GroupNorm``. JAX's bars hold through the existing parity
  tests, since the arithmetic is the same.
* The bytes that ``tools/train_memory.py`` counts as saved by the norms
  fall by the factor the dtypes give: from two f32 copies (8 bytes an
  element) to the input as it arrives (2 in bf16, 4 in f32).
* ``remat_early`` "blocks" and "stack" (MobileNet-v1, both stem
  schedules) give the loss, every gradient and every running statistic of
  "none" bit for bit, and save fewer bytes; the JAX package's remat'd
  model gives the same loss as the port's (its own remat is a lowering,
  too).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ssd_tpu.config import Config as JaxConfig
from ssd_tpu.models.detector import Detector as JaxDetector
from ssd_tpu_torch.config import Config
from ssd_tpu_torch.convert import convert_variables
from ssd_tpu_torch.models.detector import Detector
from ssd_tpu_torch.models.layers import BatchNorm, GroupNorm
from ssd_tpu_torch.tools import train_memory
from ssd_tpu_torch.tools.bench_train import synthetic_batch
from tests.test_torch_model import seeded_variables

TORCH_THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)


def plain_batch_norm(bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """The train-mode batch norm as it was, every f32 intermediate kept by
    autograd (the same ops, in the same order)."""
    shape = (1, -1, 1, 1)
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    var = torch.maximum(xf.square().mean(dim=(0, 2, 3)) - mean.square(),
                        mean.new_zeros(()))
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.copy_(bn.running_mean * m + mean * (1 - m))
        bn.running_var.copy_(bn.running_var * m + var * (1 - m))
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean.view(shape)) * mul.view(shape)
    return (y + bn.bias.view(shape)).to(x.dtype)


def plain_group_norm(gn: GroupNorm, x: torch.Tensor) -> torch.Tensor:
    n, c = x.shape[:2]
    xf = x.float()
    xg = xf.reshape(n, gn.groups, -1)
    mean = xg.mean(dim=-1)
    var = torch.maximum(xg.square().mean(dim=-1) - mean.square(),
                        mean.new_zeros(()))
    size = c // gn.groups
    mean = mean.repeat_interleave(size, dim=1)
    var = var.repeat_interleave(size, dim=1)
    mul = torch.rsqrt(var + gn.eps) * gn.weight
    y = (xf - mean[..., None, None]) * mul[..., None, None]
    return (y + gn.bias.view(1, -1, 1, 1)).to(x.dtype)


# (dtype, input mean, input spread): saturated = ReLU6's ceiling, where the
# fast variance cancels
NORM_CASES = {
    "bf16": (torch.bfloat16, 0.3, 1.5),
    "f32": (torch.float32, -0.2, 2.0),
    "bf16_saturated": (torch.bfloat16, 6.0, 0.05),
    "f32_saturated": (torch.float32, 6.0, 0.05),
}


def _norm_inputs(case: str, channels: int):
    dtype, mean, spread = NORM_CASES[case]
    rng = np.random.default_rng(sorted(NORM_CASES).index(case))
    x = rng.normal(mean, spread, (4, channels, 6, 5)).astype(np.float32)
    gy = rng.normal(0.0, 1.0, x.shape).astype(np.float32)
    w = rng.uniform(0.5, 1.5, channels).astype(np.float32)
    b = rng.normal(0.0, 0.1, channels).astype(np.float32)
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(gy).to(dtype),
            torch.from_numpy(w), torch.from_numpy(b))


def _run(norm, fn, x, gy):
    x = x.clone().requires_grad_(True)
    norm.zero_grad(set_to_none=True)
    y = fn(x)
    y.backward(gy)
    return y.detach(), x.grad, norm.weight.grad, norm.bias.grad


@pytest.mark.parametrize("case", sorted(NORM_CASES))
@pytest.mark.parametrize("kind", ["batch", "group"])
def test_lean_norm_bit_equal_to_plain(kind, case):
    channels = 24
    x, gy, w, b = _norm_inputs(case, channels)
    if kind == "batch":
        make = lambda: BatchNorm(channels, momentum=0.9).train()  # noqa
        plain = plain_batch_norm
    else:
        make = lambda: GroupNorm(channels)  # noqa: E731
        plain = plain_group_norm
    lean, ref = make(), make()
    for m in (lean, ref):
        with torch.no_grad():
            m.weight.copy_(w)
            m.bias.copy_(b)
    got = _run(lean, lean, x, gy)
    want = _run(ref, lambda t: plain(ref, t), x, gy)
    for name, g, e in zip(("y", "x.grad", "weight.grad", "bias.grad"), got,
                          want):
        assert g.dtype == e.dtype, name
        assert torch.equal(g, e), (name, float((g.float() - e.float()).abs()
                                               .max()))
    if kind == "batch":
        assert torch.equal(lean.running_mean, ref.running_mean)
        assert torch.equal(lean.running_var, ref.running_var)
        assert not torch.equal(lean.running_var, torch.ones(channels))


def test_running_stats_update_once_without_grad():
    """A train-mode forward without gradients still updates the running
    statistics once, and leaves nothing for a backward."""
    x, _, _, _ = _norm_inputs("f32", 8)
    lean, ref = BatchNorm(8).train(), BatchNorm(8).train()
    with torch.no_grad():
        y = lean(x)
        want = plain_batch_norm(ref, x)
    assert torch.equal(y, want) and y.grad_fn is None
    assert torch.equal(lean.running_mean, ref.running_mean)


def _cfg(backbone: str, dtype: str, size: int, **model) -> Config:
    return Config.from_dict(dict(
        image_size=size, num_classes=4,
        model=dict(backbone=backbone, width_multiplier=0.25, fpn_channels=16,
                   head_depth=1, compute_dtype=dtype, **model)))


def _step(det: Detector, batch: dict, tally: bool = False):
    det.model.zero_grad(set_to_none=True)
    if tally:
        with train_memory.SavedTally(det.model) as t:
            total, _ = det.loss(batch)
    else:
        t = None
        total, _ = det.loss(batch)
    total.backward()
    grads = {k: p.grad.clone() for k, p in det.model.named_parameters()
             if p.grad is not None}
    stats = {k: v.clone() for k, v in det.model.state_dict().items()
             if "running_" in k}
    return float(total.detach()), grads, stats, t


def _norm_bytes(tally) -> int:
    return sum(v for k, v in tally.bytes.items()
               if k.startswith("BatchNorm/"))


# (backbone, compute dtype, image size, factor by which the batch norms'
# saved bytes fall: 8 bytes an element before, the input's after)
SAVED_CASES = {
    "mobilenet_v2_bf16": ("mobilenet_v2", "bfloat16", 128, 4.0),
    "resnet50_f32": ("resnet50", "float32", 64, 2.0),
}


@pytest.mark.parametrize("case", sorted(SAVED_CASES))
def test_norm_saved_bytes_fall(case, monkeypatch):
    backbone, dtype, size, factor = SAVED_CASES[case]
    cfg = _cfg(backbone, dtype, size)
    batch = synthetic_batch(cfg, 2)
    det = Detector(cfg, device="cpu")
    state = {k: v.clone() for k, v in det.model.state_dict().items()}
    lean = _step(det, batch, tally=True)
    det.model.load_state_dict(state)
    monkeypatch.setattr(BatchNorm, "forward", lambda self, x: (
        plain_batch_norm(self, x) if self.training
        else self._affine(x, x.float(), self.running_mean, self.running_var,
                          self.weight, self.bias)))
    plain = _step(det, batch, tally=True)
    assert lean[0] == plain[0]
    assert all(torch.equal(lean[1][k], plain[1][k]) for k in plain[1])
    assert all(torch.equal(lean[2][k], plain[2][k]) for k in plain[2])
    before, after = _norm_bytes(plain[3]), _norm_bytes(lean[3])
    print(f"{case}: batch norm saved {before} -> {after} bytes "
          f"({before / after:.3f}x)")
    # the plain norm kept per-channel vectors besides (its statistics and
    # multiplier): 3% more at ResNet-50's 2x2 c5 maps at 64 px
    assert factor <= before / after <= factor * 1.05


# (stem schedule, compute dtype, image size). bf16 trains on the CPU at
# >= 128 px (ROADMAP.md: the CPU's bf16 1x1 stride-2 weight gradient)
REMAT_CASES = {
    "dense4_f32": ("dense4", "float32", 64),
    "reference_f32": ("reference", "float32", 64),
    "dense4_bf16": ("dense4", "bfloat16", 128),
}


@pytest.mark.parametrize("case", sorted(REMAT_CASES))
def test_remat_early_bit_equal_and_saves_less(case):
    schedule, dtype, size = REMAT_CASES[case]
    base = _cfg("mobilenet", dtype, size, stem_schedule=schedule)
    batch = synthetic_batch(base, 2, seed=3)
    state = Detector(base, device="cpu").model.state_dict()
    runs = {}
    for mode in ("none", "blocks", "stack"):
        cfg = dataclasses.replace(base, model=dataclasses.replace(
            base.model, remat_early=mode))
        det = Detector(cfg, state={k: v.clone() for k, v in state.items()},
                       device="cpu")
        runs[mode] = _step(det, batch, tally=True)
    loss, grads, stats, tally = runs["none"]
    saved = sum(tally.bytes.values())
    for mode in ("blocks", "stack"):
        got = runs[mode]
        assert got[0] == loss, mode
        assert set(got[1]) == set(grads)
        for k in grads:
            assert torch.equal(got[1][k], grads[k]), (mode, k)
        for k in stats:
            assert torch.equal(got[2][k], stats[k]), (mode, k)
        print(f"{case} {mode}: saved {sum(got[3].bytes.values())} of "
              f"{saved} bytes")
        assert sum(got[3].bytes.values()) < saved
    # stack keeps less than blocks: only the image and c3
    assert (sum(runs["stack"][3].bytes.values())
            < sum(runs["blocks"][3].bytes.values()))


def test_remat_early_matches_jax_loss():
    """JAX's ``remat_early="stack"`` model and the port's on the same
    weights and batch: the same f32 loss at the training parity bar."""
    jcfg = JaxConfig.from_dict(dict(num_classes=4, image_size=64, model=dict(
        backbone="mobilenet", width_multiplier=0.25, fpn_channels=16,
        head_depth=1, compute_dtype="float32", stem_schedule="dense4",
        remat_early="stack")))
    jdet = JaxDetector(jcfg)
    abstract = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0)))
    variables = seeded_variables(abstract, 5)
    cfg = Config.from_json(jcfg.to_json())
    batch = synthetic_batch(cfg, 2, seed=4)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p: jdet.loss({"params": p,
                             "batch_stats": variables["batch_stats"]},
                            batch)[0]))
    want, _ = grad_fn(variables["params"])
    det = Detector(cfg, convert_variables(variables, cfg), device="cpu")
    got = det.loss(batch)[0].detach()
    assert abs(float(got) / float(want) - 1) <= 1e-4, (float(got),
                                                       float(want))
