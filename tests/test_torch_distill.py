"""Knowledge distillation in the port against the JAX package, on the CPU.

``ops/distill.py``'s ``distillation_loss`` on the per-level and the flat
layouts, its value and its gradient within 1e-5 of JAX's (ties included),
and its shape checks; then three f32 train steps with a teacher against
JAX's ``make_train_step(..., teacher=)`` at ``test_torch_train.py``'s bars
(64 px, MobileNet x0.25, FPN 16, head depth 1, 8 classes, batch 4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tpu.ops import distill as jax_distill
from ssd_tpu.parallel.train_step import (
    create_train_state as jax_create_train_state)
from ssd_tpu.parallel.train_step import (
    make_optimizer as jax_make_optimizer)
from ssd_tpu.parallel.train_step import (
    make_train_step as jax_make_train_step)
from ssd_tpu.models.detector import Detector as JaxDetector
from ssd_tpu_torch.convert import convert_variables
from ssd_tpu_torch.models.detector import Detector
from ssd_tpu_torch.ops import distill
from ssd_tpu_torch.train_step import make_train_step
from test_torch_train import (STEP_VARIANTS, jax_cfg, port_from_jax,
                              small_batch, small_cfg)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32))


# ------------------------------------------------------------------ the loss

def _raw(seed: int, levels=((8, 8), (4, 4)), n: int = 2, k: int = 3,
         c: int = 5, scale: float = 3.0) -> list:
    rng = np.random.default_rng(seed)
    return [(rng.normal(0, scale, (n, h, w, k * c)).astype(np.float32),
             rng.normal(0, 1.0, (n, h, w, k * 4)).astype(np.float32))
            for h, w in levels]


def _flat(raw: list, c: int) -> tuple:
    n = raw[0][0].shape[0]
    return (np.concatenate([a.reshape(n, -1, c) for a, _ in raw], 1),
            np.concatenate([b.reshape(n, -1, 4) for _, b in raw], 1))


@pytest.mark.parametrize("layout", ["levels", "flat"])
@pytest.mark.parametrize("kw", [{}, dict(temperature=4.0, box_weight=0.5,
                                         weight_floor=0.1)])
def test_distillation_loss_equals_jax(layout, kw):
    c = 5
    student, teacher = _raw(0), _raw(1)
    # a tie in every term: student equal to the teacher on one anchor
    student[0][0][0, 0, 0, :c] = teacher[0][0][0, 0, 0, :c]
    student[0][1][0, 0, 0, :4] = teacher[0][1][0, 0, 0, :4]
    if layout == "flat":
        student, teacher = [_flat(student, c)], [_flat(teacher, c)]
    unpack = (lambda r: r) if layout == "levels" else (lambda r: r[0])

    def jax_total(s):
        dd = jax_distill.distillation_loss(
            unpack([(jnp.asarray(a), jnp.asarray(b)) for a, b in s]),
            unpack([(jnp.asarray(a), jnp.asarray(b)) for a, b in teacher]),
            c, **kw)
        return dd.total, dd

    (want, want_dd), want_grad = jax.value_and_grad(
        jax_total, has_aux=True)(student)
    s_t = [(_t(a).requires_grad_(), _t(b).requires_grad_())
           for a, b in student]
    dd = distill.distillation_loss(
        unpack(s_t), unpack([(_t(a), _t(b)) for a, b in teacher]), c, **kw)
    dd.total.backward()
    for got, ref in zip(dd, want_dd):
        np.testing.assert_allclose(float(got.detach()), float(ref),
                                   rtol=1e-5)
    for (ga, gb), (wa, wb) in zip(s_t, want_grad):
        np.testing.assert_allclose(ga.grad.numpy(), np.asarray(wa),
                                   rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(gb.grad.numpy(), np.asarray(wb),
                                   rtol=1e-5, atol=1e-8)
    same = distill.distillation_loss(unpack(s_t), unpack(s_t), c)
    assert abs(float(same.total.detach())) < 1e-5


def test_distillation_loss_refuses_other_geometries():
    raw = [(_t(a), _t(b)) for a, b in _raw(0)]
    with pytest.raises(ValueError, match="levels"):
        distill.distillation_loss(raw, raw[:1], 5)
    other = [(_t(a), _t(b)) for a, b in _raw(0, k=2)]
    with pytest.raises(ValueError, match="shapes differ"):
        distill.distillation_loss(raw, other, 5)


# ------------------------------------------------------------------ the step

def _perturbed(variables: dict, seed: int) -> dict:
    """A teacher of the student's shape: its parameters moved by seeded
    noise (the batch statistics kept)."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.05, x.shape).astype(
            np.float32), jax.device_get(variables["params"]))
    return {"params": params,
            "batch_stats": jax.device_get(variables["batch_stats"])}


def test_three_teacher_steps_match_jax():
    """Three steps of ``test_torch_train.py``'s momentum variant (a warm-up
    whose first update has lr 0, accumulation over 2 strided microbatches,
    frozen backbone, EMA, a clip that triggers) with a teacher, against
    JAX's, at that file's bars (the teacher: the student's model with
    perturbed weights): num_positives equal, every loss term and
    ``distill_loss`` within rtol 1e-4 at the first step and 3e-4 after,
    grad_norm within 1e-3, then the weights within 2e-5; the teacher's
    weights never change."""
    cfg = small_cfg(**STEP_VARIANTS["momentum"], distill_weight=0.7,
                    distill_temperature=3.0)
    jcfg = jax_cfg(cfg)
    jdet, tx = JaxDetector(jcfg), jax_make_optimizer(jcfg)
    jstate = jax.jit(lambda key: jax_create_train_state(
        jdet, key, tx, jcfg.train.ema_decay))(jax.random.PRNGKey(0))
    tvars = _perturbed({"params": jstate.params,
                        "batch_stats": jstate.batch_stats}, 1)
    jstep = jax.jit(jax_make_train_step(
        jdet, tx, cfg.train.ema_decay, cfg.train.grad_accum_steps,
        teacher=(jdet.model, tvars)))
    det, opt, state = port_from_jax(cfg, jstate)
    teacher = Detector(cfg, convert_variables(tvars, cfg), device="cpu")
    step = make_train_step(det, opt, cfg.train.ema_decay,
                           cfg.train.grad_accum_steps, teacher=teacher)
    t_before = {k: v.clone() for k, v in teacher.model.state_dict().items()}
    for i in range(3):
        batch = small_batch(20 + i)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
        jm = jax.device_get(jm)
        assert set(m) == set(jm) and "distill_loss" in m
        assert float(m["num_positives"]) == float(jm["num_positives"])
        bar = 1e-4 if i == 0 else 3e-4
        for k in ("loss", "classification_loss", "localization_loss",
                  "regularization_loss", "distill_loss"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=bar,
                                       err_msg=f"step {i} {k}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
    jstate = jax.device_get(jstate)
    want = convert_variables({"params": jstate.params,
                              "batch_stats": jstate.batch_stats}, cfg)
    got = det.model.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=2e-5, err_msg=k)
    for k, v in teacher.model.state_dict().items():
        assert torch.equal(v, t_before[k]), k  # the teacher never trains
