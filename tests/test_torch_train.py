"""The port's training path against the JAX package's, on the CPU.

Small sizes throughout (64 px, MobileNet x0.25, FPN 16, head depth 1, 8
classes, batch 4), inputs from numpy seeds, JAX's initial state converted
into the port (``convert.py``). Held here:

* every loss and its gradient, including logits at exactly 0 and touching
  boxes (where the two frameworks' derivatives differ unless ported with
  care);
* train-mode batch norm and its running statistics;
* the learning-rate schedules, against optax;
* one f32 train step leaf for leaf (loss terms, gradients, BN statistics),
  then three steps each of momentum and adam (accumulation 2, EMA, freeze,
  clipping) against JAX's ``make_train_step``, and a bf16 step at a looser
  bar;
* the card's reference, ``ssd_tpu_torch/assets/train_ref_v1.npz``: JAX's
  ten f32 steps of the sanity task, which ``chip_smoke.py`` holds the card
  to. A test checks it is current; rewrite it with

      python tests/test_torch_train.py regen

* the loop: an interrupted ``train()`` resumed from its checkpoint equals
  the uninterrupted run bit for bit, SIGTERM writes a final checkpoint, and
  the exported ``.npz`` serves; the port's scenes equal the JAX package's.
"""

import dataclasses
import os
import signal
import sys

import numpy as np
import pytest
import torch

if __name__ == "__main__":  # regen: JAX on the CPU, as tests/conftest.py sets
    os.environ["JAX_PLATFORMS"] = "cpu"

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # for ``python tests/test_torch_train.py regen``
    sys.path.insert(0, ROOT)

from ssd_tpu.config import Config as JaxConfig  # noqa: E402
from ssd_tpu.eval import sanity as jax_sanity  # noqa: E402
from ssd_tpu.models.detector import Detector as JaxDetector  # noqa: E402
from ssd_tpu.ops import losses as jax_losses  # noqa: E402
from ssd_tpu.ops import targets as jax_targets  # noqa: E402
from ssd_tpu.parallel.train_step import (  # noqa: E402
    create_train_state as jax_create_train_state)
from ssd_tpu.parallel.train_step import (  # noqa: E402
    make_lr_schedule as jax_make_lr_schedule)
from ssd_tpu.parallel.train_step import (  # noqa: E402
    make_optimizer as jax_make_optimizer)
from ssd_tpu.parallel.train_step import (  # noqa: E402
    make_train_step as jax_make_train_step)
from ssd_tpu_torch.config import (Config, DataConfig, LossConfig,  # noqa: E402
                                  ModelConfig, TrainConfig)
from ssd_tpu_torch.convert import (convert_params,  # noqa: E402
                                   convert_variables, load_npz_artifact,
                                   save_npz_artifact)
from ssd_tpu_torch.data import synthetic  # noqa: E402
from ssd_tpu_torch.models.detector import Detector  # noqa: E402
from ssd_tpu_torch.models.layers import BatchNorm  # noqa: E402
from ssd_tpu_torch.ops import losses  # noqa: E402
from ssd_tpu_torch.ops.targets import Targets  # noqa: E402
from ssd_tpu_torch.predictor import Predictor  # noqa: E402
from ssd_tpu_torch.export import load_inference_artifact  # noqa: E402
from ssd_tpu_torch.train import EXPORT_NAME, train  # noqa: E402
from ssd_tpu_torch.train_step import (Optimizer,  # noqa: E402
                                      create_train_state, make_lr_schedule,
                                      make_train_step)
from ssd_tpu_torch.utils.checkpoint import TrainCheckpointer  # noqa: E402

ASSET = os.path.join(ROOT, "ssd_tpu_torch", "assets", "train_ref_v1.npz")
REF_STEPS = 10
REF_METRICS = ("loss", "classification_loss", "localization_loss",
               "num_positives", "grad_norm")


def small_cfg(dtype: str = "float32", image_size: int = 64,
              **train_kw) -> Config:
    train = dict(batch_size=4, optimizer="momentum", learning_rate=0.01,
                 warmup_steps=0, num_steps=100, gradient_clip_norm=10.0)
    train.update(train_kw)
    return Config(
        num_classes=8, image_size=image_size,
        model=ModelConfig(width_multiplier=0.25, fpn_channels=16,
                          head_depth=1, stem_schedule="dense4",
                          compute_dtype=dtype, bn_momentum=0.9),
        losses=LossConfig(box_loss="giou"),
        train=TrainConfig(**train),
        data=DataConfig(max_gt_boxes=12))


def small_batch(index: int, n: int = 4, size: int = 64) -> dict:
    rng = np.random.default_rng([5, index])
    return synthetic.pad_batch(
        [synthetic.crowded_example(rng, 8, size, 3, 12) for _ in range(n)],
        12)


def jax_cfg(cfg: Config) -> JaxConfig:
    return JaxConfig.from_json(cfg.to_json())


def jax_state(cfg: Config):
    jcfg = jax_cfg(cfg)
    det = JaxDetector(jcfg)
    tx = jax_make_optimizer(jcfg)
    state = jax_create_train_state(det, jax.random.PRNGKey(0), tx,
                                   jcfg.train.ema_decay)
    return det, tx, state


def port_from_jax(cfg: Config, jstate) -> tuple:
    """(detector, optimizer, state) on the CPU from JAX's initial state."""
    variables = jax.device_get({"params": jstate.params,
                                "batch_stats": jstate.batch_stats})
    det = Detector(cfg, convert_variables(variables, cfg), device="cpu")
    opt = Optimizer(cfg)
    return det, opt, create_train_state(det, opt, cfg.train.ema_decay)


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got: dict, want: dict, rtol: float, atol: float, what: str):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=rtol,
                                   atol=atol, err_msg=f"{what} {k}")


# ------------------------------------------------------------------ losses

def _loss_inputs(seed=0, n=2, a=60, c=5):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (n, a, c)).astype(np.float32)
    logits[:, :7] = 0.0  # the abs/max ties
    deltas = rng.normal(0, 0.5, (n, a, 4)).astype(np.float32)
    lo = rng.uniform(0, 0.6, (a, 2))
    anchors = np.concatenate([lo, lo + rng.uniform(0.05, 0.4, (a, 2))],
                             -1).astype(np.float32)
    matches = rng.integers(-2, 4, (n, a)).astype(np.int32)
    positive = matches >= 0
    reg = rng.normal(0, 1, (n, a, 4)).astype(np.float32) * positive[..., None]
    reg[:, :5] = deltas[:, :5] * positive[:, :5, None]  # exact: diff 0
    labels = rng.integers(0, c, (n, a))
    onehot = (np.eye(c, dtype=np.float32)[labels] * positive[..., None])
    return dict(logits=logits, deltas=deltas, anchors=anchors,
                reg_targets=reg, cls_targets=onehot,
                cls_weights=(matches != -2).astype(np.float32),
                reg_weights=positive.astype(np.float32), matches=matches,
                matched_labels=(labels * positive).astype(np.float32))


def _targets(d: dict, lib):
    cls = Targets if lib is torch else jax_targets.Targets
    conv = torch.from_numpy if lib is torch else jnp.asarray
    return cls(conv(d["reg_targets"]), conv(d["cls_targets"]),
               conv(d["cls_weights"]), conv(d["reg_weights"]),
               conv(d["matches"]), conv(d["matched_labels"]))


def _grads_both(jfn, tfn, *arrays, jit=False):
    """Value and gradient with respect to every array, JAX and port. JAX
    runs op by op unless ``jit``: compiled, XLA may round the two decodes
    of one box differently and so break a tie the port keeps."""
    vg = jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))))
    jval, jgrads = (jax.jit(vg) if jit else vg)(*map(jnp.asarray, arrays))
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    tval = tfn(*ts)
    tval.backward()
    return (float(jval), [np.asarray(g) for g in jgrads],
            float(tval.detach()),
            [np.zeros_like(a) if t.grad is None else t.grad.numpy()
             for a, t in zip(arrays, ts)])


def _assert_value_and_grads(jfn, tfn, *arrays, jit=False):
    jv, jg, tv, tg = _grads_both(jfn, tfn, *arrays, jit=jit)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    for g, w in zip(tg, jg):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


def test_focal_and_smooth_l1_match_at_ties():
    d = _loss_inputs()
    t = d["cls_targets"]
    _assert_value_and_grads(
        lambda x: jax_losses.sigmoid_focal_loss(x, jnp.asarray(t), 0.25,
                                                2.0).sum(),
        lambda x: losses.sigmoid_focal_loss(x, torch.from_numpy(t), 0.25,
                                            2.0).sum(), d["logits"])
    _assert_value_and_grads(
        lambda p, q: jax_losses.smooth_l1_loss(p, q, 1.0).sum(),
        lambda p, q: losses.smooth_l1_loss(p, q, 1.0).sum(),
        d["deltas"], d["reg_targets"])
    # the tie the port must spell with JAX's derivative: logit exactly 0
    x = torch.zeros(3, requires_grad=True)
    losses.sigmoid_focal_loss(x, torch.tensor([1.0, 0.0, 0.0]), 0.25,
                              2.0).sum().backward()
    jx = jax.grad(lambda v: jax_losses.sigmoid_focal_loss(
        v, jnp.asarray([1.0, 0.0, 0.0]), 0.25, 2.0).sum())(jnp.zeros(3))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jx), rtol=1e-6)


@pytest.mark.parametrize("kind", ["giou", "diou", "ciou"])
def test_iou_box_losses_match(kind):
    rng = np.random.default_rng(1)
    lo = rng.uniform(0, 0.5, (40, 2))
    pred = np.concatenate([lo, lo + rng.uniform(0.05, 0.4, (40, 2))], -1)
    tgt = pred + rng.normal(0, 0.05, (40, 4))
    tgt[:8] = pred[:8]  # identical boxes
    tgt[8:12, 0] = pred[8:12, 2]  # touching: target starts where pred ends
    tgt[8:12, 2] = pred[8:12, 2] + 0.1
    _assert_value_and_grads(
        lambda p, q: jax_losses.iou_box_loss(p, q, kind).sum(),
        lambda p, q: losses.iou_box_loss(p, q, kind).sum(),
        pred.astype(np.float32), tgt.astype(np.float32))


@pytest.mark.parametrize("box_loss,ohem", [("smooth_l1", False),
                                           ("giou", False),
                                           ("smooth_l1", True)])
def test_flat_detection_loss_matches(box_loss, ohem):
    d = _loss_inputs(seed=2)
    cfg = LossConfig(box_loss=box_loss, use_ohem=ohem, ohem_min_negatives=4)
    jcfg = jax_cfg(Config(losses=cfg)).losses
    anchors = d["anchors"]
    for part in ("total", "classification", "localization"):
        _assert_value_and_grads(
            lambda x, b: getattr(jax_losses.detection_loss(
                x, b, _targets(d, jnp), jcfg, jnp.asarray(anchors)), part),
            lambda x, b: getattr(losses.detection_loss(
                x, b, _targets(d, torch), cfg, torch.from_numpy(anchors)),
                part), d["logits"], d["deltas"])


@pytest.mark.parametrize("box_loss", ["smooth_l1", "giou"])
def test_per_level_detection_loss_matches(box_loss):
    """Two levels (4x4 and 2x2 cells, 3 anchors per cell, 5 classes) of raw
    NHWC maps: value and gradients with respect to both maps."""
    k, c, n = 3, 5, 2
    a = (16 + 4) * k
    d = _loss_inputs(seed=3, n=n, a=a, c=c)
    rng = np.random.default_rng(4)
    maps = [rng.normal(0, 2, (n, s, s, k * c)).astype(np.float32)
            for s in (4, 2)]
    maps[0][:, 0] = 0.0
    boxes = [rng.normal(0, 0.5, (n, s, s, k * 4)).astype(np.float32)
             for s in (4, 2)]
    cfg = LossConfig(box_loss=box_loss)
    jcfg = jax_cfg(Config(losses=cfg)).losses
    anchors = d["anchors"]
    d["cls_targets"] = None

    def jfn(c0, c1, b0, b1):
        t = jax_targets.Targets(*[jnp.asarray(d[f]) if d[f] is not None
                                  else None for f in Targets._fields])
        return jax_losses.detection_loss_levels(
            [(c0, b0), (c1, b1)], t, c, jcfg, jnp.asarray(anchors)).total

    def tfn(c0, c1, b0, b1):
        t = Targets(*[torch.from_numpy(d[f]) if d[f] is not None else None
                      for f in Targets._fields])
        return losses.detection_loss_levels(
            [(c0, b0), (c1, b1)], t, c, cfg, torch.from_numpy(anchors)).total

    _assert_value_and_grads(jfn, tfn, *maps, *boxes, jit=True)


def test_l2_regularization_matches():
    rng = np.random.default_rng(6)
    tree = {"a": {"kernel": rng.normal(size=(3, 3, 4, 5)).astype(np.float32),
                  "bias": rng.normal(size=(5,)).astype(np.float32)},
            "b": {"scale": rng.normal(size=(5,)).astype(np.float32),
                  "kernel": rng.normal(size=(4, 5)).astype(np.float32)}}
    want = float(jax_losses.l2_regularization(
        jax.tree_util.tree_map(jnp.asarray, tree), 1e-4))
    got = losses.l2_regularization(
        [torch.from_numpy(v) for m in tree.values() for v in m.values()],
        1e-4)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


# ------------------------------------------------------------------ BN

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_mode_batch_norm_matches_flax(dtype):
    rng = np.random.default_rng(7)
    x = (rng.normal(0.5, 2.0, (4, 6, 5, 8))).astype(np.float32)  # NHWC
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.normal(0, 0.1, 8).astype(np.float32)
    mean0 = rng.normal(0, 0.1, 8).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-3, dtype=jdt, param_dtype=jnp.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    jx = jnp.asarray(x).astype(jdt)
    want, new = bn.apply(variables, jx, mutable=["batch_stats"])

    port = BatchNorm(8, momentum=0.9).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.running_mean.copy_(torch.from_numpy(mean0))
        port.running_var.copy_(torch.from_numpy(var0))
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(tdt)
    got = port(tx.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == tdt
    # bf16: one bf16 rounding of the output (3 significant digits)
    tol = 1e-5 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(new["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(new["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ schedules

@pytest.mark.parametrize("schedule", ["cosine", "piecewise"])
@pytest.mark.parametrize("warmup", [0, 20])
def test_lr_schedule_matches_optax(schedule, warmup):
    cfg = small_cfg(lr_schedule=schedule, warmup_steps=warmup,
                    num_steps=200, learning_rate=0.08,
                    lr_boundaries=(60, 150), lr_rates=(1.0, 0.1, 0.01))
    got, want = make_lr_schedule(cfg), jax_make_lr_schedule(jax_cfg(cfg))
    for step in sorted({0, 1, warmup, warmup + 1, 60 + warmup,
                        61 + warmup, 150 + warmup, 199, 250}):
        np.testing.assert_allclose(float(got(step)),
                                   float(want(jnp.int32(step))),
                                   rtol=1e-6, atol=1e-9, err_msg=str(step))
    if warmup:
        assert float(got(0)) == 0.0  # the first update of a warm-up is 0


# ------------------------------------------------------------------ steps
#
# Two effects set the bars below, both measured on this CPU:
# * XLA's CPU f32 sum over a level's focal terms runs in one sequential
#   pass: on the small batch JAX's classification loss is 4.8e-5 off its
#   float64 value where the port's pairwise sum is 1e-7 off. Loss terms
#   are held to rtol 1e-4.
# * flax's fast variance E[x^2] - E[x]^2 cancels in channels that ReLU6
#   saturates (mean near 6, tiny spread), and its gradient amplifies the
#   f32 rounding of the two means: on such data JAX's BN input gradient is
#   2.4% off float64 and the port's 0.07%. Early-layer gradients of the two
#   frameworks therefore differ by up to 2% elementwise on the sanity task
#   (its grad_norm by 9.4e-4), and by 1e-4 on the small config.

@pytest.fixture(scope="module")
def jax_loss_grad():
    """JAX's loss, metrics, gradients and new BN stats at the f32 small
    config on batch 0: one jit, shared by the tests that read it."""
    cfg = small_cfg()
    det, _, state = jax_state(cfg)

    def loss_fn(params, batch):
        total, (metrics, new_state) = det.loss(
            {"params": params, "batch_stats": state.batch_stats}, batch)
        return total, (metrics, new_state)

    batch = small_batch(0)
    (_, (metrics, new_state)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(state.params, batch)
    return cfg, state, batch, jax.device_get((metrics, new_state, grads))


def test_f32_loss_gradients_and_bn_stats_match(jax_loss_grad):
    """One f32 forward/backward leaf for leaf. Loss terms rtol 1e-4 (see
    above); each gradient leaf within 2e-4 of its own largest entry (f32
    sums over thousands of terms in another order, and the BN variance's
    cancellation); BN statistics rtol 1e-5."""
    cfg, jstate, batch, (metrics, new_state, grads) = jax_loss_grad
    det, _, _ = port_from_jax(cfg, jstate)
    total, got = det.loss(batch)
    total.backward()
    assert float(metrics["num_positives"]) > 20
    _close(got, metrics, 1e-4, 1e-7, "metrics")
    want = convert_params(grads, cfg)
    for name, p in det.model.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=2e-4 * np.abs(w).max() + 1e-9,
                                   err_msg=name)
    stats = convert_variables({"params": jstate.params, **new_state}, cfg)
    for name, b in det.model.named_buffers():
        if name in stats:
            np.testing.assert_allclose(b.numpy(), stats[name].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


def _grad_cos(a: dict, b: dict, prefix: str) -> float:
    keys = [k for k in a if k.startswith(prefix)]
    x = torch.cat([a[k].flatten() for k in keys])
    y = torch.cat([b[k].flatten() for k in keys])
    return float(x @ y / (x.norm() * y.norm()))


def test_bf16_loss_and_gradients_within_bf16_bar():
    """bf16 compute: every conv rounds its output to bf16 (3 significant
    digits) in an order that differs between the frameworks, and the BN
    variance's cancellation turns that into noise in the backbone's
    gradients: measured here, each framework's bf16 backbone gradient has
    cosine 0.43-0.51 with its own f32 gradient. The bars: loss terms within
    1e-2 relative, num_positives equal; head and FPN gradients within
    cosine 0.95 of JAX's bf16 ones; and per part, the port's bf16 gradient
    no further from the f32 gradient (the port's, which has cosine 0.9988
    with JAX's here) than JAX's bf16 one is, less 0.05.
    At 128 px: PyTorch's CPU bf16 conv returns a wrong weight gradient for
    a 1x1 input at stride 2 (p7 at 64 px), which this size avoids."""
    batch = small_batch(1, size=128)
    cfg = small_cfg("bfloat16", image_size=128)
    jdet, _, jstate = jax_state(cfg)
    (_, (metrics, _)), jg = jax.jit(jax.value_and_grad(
        lambda p: jdet.loss({"params": p, "batch_stats": jstate.batch_stats},
                            batch), has_aux=True))(jstate.params)
    j16 = convert_params(jax.device_get(jg), cfg)
    grads = {}
    for dtype in ("float32", "bfloat16"):
        det, _, _ = port_from_jax(small_cfg(dtype, image_size=128), jstate)
        total, got = det.loss(batch)
        total.backward()
        grads[dtype] = {k: p.grad for k, p in det.model.named_parameters()}
    for k in ("loss", "classification_loss", "localization_loss"):
        np.testing.assert_allclose(float(got[k]), float(metrics[k]),
                                   rtol=1e-2, err_msg=k)
    assert float(got["num_positives"]) == float(metrics["num_positives"])
    p32, p16 = grads["float32"], grads["bfloat16"]
    for part in ("head.", "fpn."):
        assert _grad_cos(p16, j16, part) >= 0.95, part
    for part in ("backbone.", "fpn.", "head."):
        port, ref = _grad_cos(p16, p32, part), _grad_cos(j16, p32, part)
        assert port >= ref - 0.05, (part, port, ref)


STEP_VARIANTS = {
    "adam": dict(optimizer="adam", learning_rate=1e-3, ema_decay=0.9),
    "momentum": dict(optimizer="momentum", learning_rate=0.01,
                     warmup_steps=1, grad_accum_steps=2, freeze="backbone",
                     ema_decay=0.5, gradient_clip_norm=0.5),
}


def _load_jax_state(det, state, jstate, cfg) -> None:
    """Overwrite the port's state with JAX's: params, BN statistics, EMA
    and, for adam, the moments and the count."""
    jstate = jax.device_get(jstate)
    det.model.load_state_dict(convert_variables(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}, cfg))
    with torch.no_grad():
        for k, v in convert_params(jstate.ema_params, cfg).items():
            state.ema_params[k].copy_(v)
        adam = jstate.opt_state[-1][0]  # chain(clip, chain(adam, schedule))
        for key in ("mu", "nu"):
            for k, v in convert_params(getattr(adam, key), cfg).items():
                state.opt_state[key][k].copy_(v)
    state.opt_state["count"] = int(adam.count)


@pytest.mark.parametrize("variant", ["adam", "momentum"])
def test_three_train_steps_match_jax(variant):
    """Three steps against JAX's ``make_train_step``. Each step: loss terms
    rtol 3e-4 (the sum's 5e-5 plus the drift of weights updated from
    gradients that differ by up to 2e-4), grad_norm rtol 1e-3,
    num_positives equal. Then params, EMA and BN statistics.

    momentum (nesterov, a one-step warm-up whose first update has lr 0,
    accumulation over 2 strided microbatches, frozen backbone, EMA, a clip
    that triggers) runs free for three steps; its weights are held to 2e-5
    absolute. adam (no warm-up, EMA) divides each gradient by its own
    magnitude, so a weight whose gradient is at the noise level moves by
    +-lr on a sign: its free runs part after one step, by 2e-3 on 0.06-3%
    of a layer's weights and on half of them a step later, while gradients
    from one set of weights agree to 1e-4. So each adam step starts from
    JAX's state (weights, BN statistics, EMA, moments, count), and after it
    every weight is within 2 lr (2e-3) and 95% of each leaf's within 2e-5
    (measured: at most 3.1%, one weight of a 32-channel BN, moved more).
    """
    cfg = small_cfg(**STEP_VARIANTS[variant])
    jdet, tx, jstate = jax_state(cfg)
    jstep = jax.jit(jax_make_train_step(jdet, tx, cfg.train.ema_decay,
                                        cfg.train.grad_accum_steps))
    det, opt, state = port_from_jax(cfg, jstate)
    step = make_train_step(det, opt, cfg.train.ema_decay,
                           cfg.train.grad_accum_steps)
    frozen0 = {k: v.clone() for k, v in state.params.items()
               if k.startswith("backbone.")}
    for i in range(3):
        batch = small_batch(10 + i)
        if variant == "adam":
            _load_jax_state(det, state, jstate, cfg)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
        jm = jax.device_get(jm)
        assert float(m["num_positives"]) == float(jm["num_positives"])
        for k in ("loss", "classification_loss", "localization_loss",
                  "regularization_loss"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=3e-4,
                                       err_msg=f"step {i} {k}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
        if variant == "adam":
            _assert_adam_step(det, state, jstate, cfg)
    assert state.step == 3 and state.opt_state["count"] == 3
    if variant == "momentum":
        jstate = jax.device_get(jstate)
        want = convert_variables({"params": jstate.params,
                                  "batch_stats": jstate.batch_stats}, cfg)
        got = det.model.state_dict()
        _close({k: got[k] for k in want}, want, 1e-4, 2e-5, "state")
        _close(state.ema_params, convert_params(jstate.ema_params, cfg),
               1e-4, 2e-5, "ema")
        for k, v in frozen0.items():
            assert torch.equal(state.params[k], v), k


def _assert_adam_step(det, state, jstate, cfg) -> None:
    jstate = jax.device_get(jstate)
    lr = cfg.train.learning_rate
    want = convert_variables({"params": jstate.params,
                              "batch_stats": jstate.batch_stats}, cfg)
    got = det.model.state_dict()
    for k, w in want.items():
        diff = (got[k] - w).abs()
        if k.endswith(("running_mean", "running_var")):
            # batch means of order 1e-2 summed in another order
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-5,
                                       atol=5e-6, err_msg=k)
            continue
        assert float(diff.max()) <= 2 * lr * 1.001, k
        assert float((diff > 2e-5).float().mean()) <= 0.05, k
    ema = convert_params(jstate.ema_params, cfg)
    for k, w in ema.items():
        # EMA decay 0.9: a weight's flip of 2 lr moves its EMA by 0.2 lr
        assert float((state.ema_params[k] - w).abs().max()) <= 0.2 * lr * 1.01


# ------------------------------------------------------------------ the card's reference

def sanity_train_cfg() -> Config:
    """The sanity config in f32: the task ``chip_smoke.py`` trains on."""
    jcfg = jax_sanity.sanity_config()
    cfg = Config.from_json(jcfg.to_json())
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32"))


def train_ref_arrays() -> tuple[Config, dict, dict]:
    """-> (cfg, initial state dict, extra arrays) of ``train_ref_v1.npz``:
    JAX's ``REF_STEPS`` f32 steps from its seed-0 init on the sanity
    task's training batches."""
    cfg = sanity_train_cfg()
    det, tx, state = jax_state(cfg)
    init = convert_variables(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}), cfg)
    step = jax.jit(jax_make_train_step(det, tx))
    per_step = {k: [] for k in REF_METRICS}
    for i in range(REF_STEPS):
        images, boxes, labels, num, _ = next(jax_sanity.sanity_batches(
            cfg.train.batch_size, jax_sanity.SANITY_SEED_TRAIN + i,
            cfg.train.batch_size, cfg.data.max_gt_boxes))
        state, m = step(state, {"images": images, "boxes": boxes,
                                "labels": labels, "num_boxes": num})
        for k in REF_METRICS:
            per_step[k].append(float(m[k]))
    final = convert_variables(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}), cfg)
    extra = {f"jax_{k}": np.asarray(v, np.float32)
             for k, v in per_step.items()}
    extra.update({f"final/{k}": v.numpy() for k, v in final.items()})
    return cfg, init, extra


@pytest.fixture(scope="module")
def train_ref():
    return train_ref_arrays()


def test_committed_train_ref_matches_regen(train_ref):
    cfg, init, extra = train_ref
    got_cfg, got_init = load_npz_artifact(ASSET)
    assert got_cfg == cfg
    assert set(got_init) == set(init)
    for k, v in init.items():
        assert torch.equal(got_init[k], v), k
    with np.load(ASSET) as z:
        # JAX's CPU arithmetic may move in the last bits across CPUs
        for k in extra:
            np.testing.assert_allclose(z[k], extra[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_port_trains_like_the_reference_on_cpu():
    """The card's bars, here on the CPU: ``num_positives`` equal at every
    step, step 0's loss within 1e-4 and its grad_norm within 2e-3 (9.4e-4
    measured here: the BN variance's cancellation, see above), every loss
    within 1e-2, all relative."""
    cfg, init = load_npz_artifact(ASSET)
    det = Detector(cfg, init, device="cpu")
    opt = Optimizer(cfg)
    state = create_train_state(det, opt)
    step = make_train_step(det, opt)
    with np.load(ASSET) as z:
        ref = {k: z[f"jax_{k}"] for k in REF_METRICS}
    for i in range(REF_STEPS):
        state, m = step(state, synthetic.sanity_train_batch(
            i, cfg.train.batch_size, cfg.data.max_gt_boxes))
        assert float(m["num_positives"]) == ref["num_positives"][i], i
        bar = 1e-4 if i == 0 else 1e-2
        np.testing.assert_allclose(float(m["loss"]), ref["loss"][i],
                                   rtol=bar, err_msg=str(i))
        if i == 0:
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       ref["grad_norm"][0], rtol=2e-3)


# ------------------------------------------------------------------ the loop

def loop_cfg(**kw) -> Config:
    cfg = small_cfg(optimizer="adam", learning_rate=1e-3, warmup_steps=2,
                    ema_decay=0.9, checkpoint_every=100, log_every=2,
                    keep_checkpoints=2, **kw)
    return cfg


def loop_batches() -> synthetic.SceneBatches:
    return synthetic.SceneBatches(small_batch)


def _checkpoint_state(workdir: str, step: int) -> dict:
    return torch.load(os.path.join(workdir, "checkpoints",
                                   f"ckpt_{step:010d}.pt"), weights_only=True)


def test_resume_is_exact(tmp_path):
    """train() to 4 steps == train() to 2, then resumed to 4: every
    parameter, BN statistic, optimizer moment and EMA weight, bit for bit,
    and the batch stream's position."""
    cfg = loop_cfg()
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    train(cfg, full, loop_batches(), max_steps=4, device="cpu")
    train(cfg, part, loop_batches(), max_steps=2, device="cpu")
    assert TrainCheckpointer(os.path.join(part, "checkpoints")).all_steps() \
        == [2]
    train(cfg, part, loop_batches(), max_steps=4, device="cpu")
    a, b = _checkpoint_state(full, 4), _checkpoint_state(part, 4)
    assert a["iterator"] == b["iterator"] == {"position": 4}
    for key in ("params", "batch_stats", "ema_params"):
        for k in a[key]:
            assert torch.equal(a[key][k], b[key][k]), (key, k)
    for k in ("mu", "nu"):
        for name in a["opt_state"][k]:
            assert torch.equal(a["opt_state"][k][name],
                               b["opt_state"][k][name]), (k, name)
    assert a["opt_state"]["count"] == b["opt_state"]["count"] == 4
    # the export serves, from the EMA weights
    pred = Predictor.from_checkpoint(os.path.join(full, EXPORT_NAME),
                                     device="cpu")
    out = pred.predict(small_batch(0)["images"])
    assert out["boxes"].shape == (4, cfg.nms.max_boxes, 4)
    assert np.isfinite(out["scores"]).all()
    _, state = load_inference_artifact(os.path.join(full, EXPORT_NAME))
    for k, v in a["ema_params"].items():
        assert torch.equal(state[k], v), k


def test_sigterm_writes_a_final_checkpoint(tmp_path):
    """SIGTERM during step 2's batch: the loop finishes that step, writes
    its checkpoint, stops and writes no export."""
    cfg = loop_cfg()

    def make(i):
        if i == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return small_batch(i)

    workdir = str(tmp_path / "run")
    previous = signal.getsignal(signal.SIGTERM)
    train(cfg, workdir, synthetic.SceneBatches(make), max_steps=10,
          device="cpu")
    assert signal.getsignal(signal.SIGTERM) == previous
    assert TrainCheckpointer(os.path.join(workdir, "checkpoints")) \
        .all_steps() == [2]
    assert not os.path.exists(os.path.join(workdir, EXPORT_NAME))


def test_crash_writes_a_checkpoint(tmp_path):
    cfg = loop_cfg()

    def make(i):
        if i == 3:
            raise RuntimeError("input failed")
        return small_batch(i)

    workdir = str(tmp_path / "run")
    with pytest.raises(RuntimeError, match="input failed"):
        train(cfg, workdir, synthetic.SceneBatches(make), max_steps=10,
              device="cpu")
    assert TrainCheckpointer(os.path.join(workdir, "checkpoints")) \
        .all_steps() == [3]


def test_ema_toggle_is_tolerated(tmp_path):
    """A checkpoint written without EMA resumes into a run with EMA (the EMA
    re-seeded from the params), and one with EMA into a run without."""
    workdir = str(tmp_path / "run")
    no_ema = dataclasses.replace(loop_cfg(), train=dataclasses.replace(
        loop_cfg().train, ema_decay=0.0))
    train(no_ema, workdir, loop_batches(), max_steps=1, device="cpu")
    train(loop_cfg(), workdir, loop_batches(), max_steps=2, device="cpu")
    train(no_ema, workdir, loop_batches(), max_steps=3, device="cpu")
    ckpt = _checkpoint_state(workdir, 3)
    assert ckpt["ema_params"] is None and ckpt["iterator"]["position"] == 3


# ------------------------------------------------------------------ scenes

def test_sanity_scenes_equal_jax():
    got = list(synthetic.sanity_batches(20, 3, batch=8, max_gt=32))
    want = list(jax_sanity.sanity_batches(20, 3, batch=8, max_gt=32))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    b = synthetic.sanity_train_batch(2)
    w = next(jax_sanity.sanity_batches(16, jax_sanity.SANITY_SEED_TRAIN + 2,
                                       16, 32))
    for k, v in zip(("images", "boxes", "labels", "num_boxes"), w):
        np.testing.assert_array_equal(b[k], v)


def test_scene_batches_resume():
    s = loop_batches()
    next(s), next(s)
    t = loop_batches()
    t.restore(s.state())
    np.testing.assert_array_equal(next(s)["boxes"], next(t)["boxes"])


if __name__ == "__main__":
    if sys.argv[1:] == ["regen"]:
        os.makedirs(os.path.dirname(ASSET), exist_ok=True)
        cfg, init, extra = train_ref_arrays()
        save_npz_artifact(ASSET, cfg, init, **extra)
        print(f"wrote {ASSET} ({os.path.getsize(ASSET)} bytes)")
    else:
        sys.exit("usage: python tests/test_torch_train.py regen")
