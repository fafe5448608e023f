"""The training step: loss, backward, clip, optimizer update, EMA.

Counterpart of ``ssd_tpu/parallel/train_step.py`` on one device, eager.
The state lives in the model: ``TrainState.params`` and ``batch_stats`` are
the model's own parameter and buffer tensors by name, and a step updates
them, the optimizer state and the EMA in place (JAX builds a new state
each step; in place here, nothing is held twice).

The optimizer is optax's chain written out, so that its arithmetic is
optax's and not ``torch.optim``'s:

* ``freeze``: gradients of the frozen top-level modules are zeroed first;
* ``clip_by_global_norm``: ``g`` if ``norm < max`` else ``g / norm * max``;
* ``sgd(momentum, nesterov=True)``: ``t = g + mu t``, ``u = g + mu t``;
* ``adam``: ``m = (1 - b1) g + b1 m``, ``v = (1 - b2) g^2 + b2 v``, then
  ``m_hat / (sqrt(v_hat) + 1e-8)`` with the bias corrected by ``count + 1``;
* the update is ``-lr(count) * u`` with ``count`` the number of updates
  before this one, so the first update of a warm-up has lr 0.

Schedules are evaluated in f32 in optax's op order (``make_lr_schedule``).

Under a mesh (``make_train_step(mesh=)``, one rank a device) the step is
the one-device step at the global batch, as GSPMD makes of JAX's: batch
norm takes the global statistics and the loss normalizers are global
(``parallel.mesh.data_parallel``), the gradients are summed over the ranks
(each rank's loss is its own rows' sum over the global count), L2's
gradient is added once to the sum, and the metrics are the global ones,
the same on every rank, as is every update. The state is replicated, or
sharded by FSDP (``parallel.mesh.fsdp_sharded``) before
``create_train_state``, so that the optimizer state and the EMA are
``DTensor`` shards beside their parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.models.detector import Detector
from ssd_tpu_torch.ops.losses import l2_regularization
from ssd_tpu_torch.parallel import mesh as mesh_lib

_F32 = np.float32
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class TrainState:
    """``params`` and ``batch_stats`` are the model's tensors by name;
    ``opt_state`` holds ``count`` and the optimizer's moments (``trace`` for
    momentum, ``mu`` and ``nu`` for adam); ``ema_params`` is None unless
    ``train.ema_decay > 0``."""

    step: int
    params: dict
    batch_stats: dict
    opt_state: dict
    ema_params: dict | None = None


def make_lr_schedule(cfg: Config) -> Callable[[int], np.float32]:
    """``count -> lr`` as optax evaluates it in f32: linear warm-up from 0
    over ``warmup_steps``, then cosine decay to 0 over the remaining steps,
    or piecewise-constant scaling at ``lr_boundaries``."""
    t = cfg.train
    lr = _F32(t.learning_rate)
    if t.lr_schedule == "cosine":
        decay_steps = _F32(max(t.num_steps - t.warmup_steps, 1))

        def main(count: int) -> np.float32:
            c = min(_F32(count), decay_steps)
            cosine = _F32(0.5) * (_F32(1) + np.cos(_F32(np.pi) * c
                                                   / decay_steps))
            return lr * cosine
    elif t.lr_schedule == "piecewise":
        scales = {b: t.lr_rates[i + 1] / t.lr_rates[i]
                  for i, b in enumerate(t.lr_boundaries)}

        def main(count: int) -> np.float32:
            v = lr
            for threshold, scale in sorted(scales.items()):
                ind = _F32(max(0, int(np.sign(threshold - count))))
                v = v * ind + (_F32(1) - ind) * _F32(scale) * v
            return v
    else:
        raise ValueError(f"unknown lr_schedule: {t.lr_schedule}")
    if t.warmup_steps <= 0:
        return main
    ws = t.warmup_steps

    def schedule(count: int) -> np.float32:
        if count >= ws:
            return main(count - ws)
        frac = _F32(1) - _F32(min(max(count, 0), ws)) / _F32(ws)
        return -lr * frac + lr

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every tensor, in f32."""
    total = None
    for g in tensors:
        sq = g.float().square().sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


class Optimizer:
    """optax's ``[masked zero ->] [clip ->] sgd | adam`` for one config
    (see the module docstring). ``init(params)`` makes the state;
    ``update`` applies one step to the params and the state in place."""

    def __init__(self, cfg: Config):
        t = cfg.train
        if t.optimizer not in ("momentum", "adam"):
            raise ValueError(f"unknown optimizer: {t.optimizer}")
        self.kind = t.optimizer
        self.momentum = t.momentum
        self.clip = t.gradient_clip_norm
        self.lr = make_lr_schedule(cfg)
        self.frozen = {m.strip() for m in t.freeze.split(",") if m.strip()}

    def init(self, params: dict) -> dict:
        zeros = lambda: {k: torch.zeros_like(p)  # noqa: E731
                         for k, p in params.items()}
        if self.kind == "momentum":
            return {"count": 0, "trace": zeros()}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update(self, grads: dict, opt_state: dict, params: dict) -> None:
        if self.frozen:
            grads = {k: (torch.zeros_like(g) if k.split(".")[0] in self.frozen
                         else g) for k, g in grads.items()}
        if self.clip > 0:
            norm = global_norm(grads.values())
            keep = norm < self.clip
            grads = {k: torch.where(keep, g, g / norm * self.clip)
                     for k, g in grads.items()}
        count = opt_state["count"]
        step_size = float(-self.lr(count))
        if self.kind == "momentum":
            mu = self.momentum
            for k, g in grads.items():
                t = opt_state["trace"][k]
                t.copy_(g + t * mu)
                params[k].copy_(params[k] + (g + t * mu) * step_size)
        else:
            b1, b2 = _ADAM_B1, _ADAM_B2
            c1 = float(_F32(1) - _F32(b1) ** _F32(count + 1))
            c2 = float(_F32(1) - _F32(b2) ** _F32(count + 1))
            for k, g in grads.items():
                m, v = opt_state["mu"][k], opt_state["nu"][k]
                m.copy_(g * (1 - b1) + m * b1)
                v.copy_(g * g * (1 - b2) + v * b2)
                u = (m / c1) / (torch.sqrt(v / c2) + _ADAM_EPS)
                params[k].copy_(params[k] + u * step_size)
        opt_state["count"] = count + 1


def create_train_state(detector: Detector, optimizer: Optimizer,
                       ema_decay: float = 0.0,
                       seed: int | None = None) -> TrainState:
    """A state over ``detector.model``'s tensors; ``seed`` re-initialises
    the weights first (``SSDModel.reset_parameters``), ``None`` keeps the
    model's current ones."""
    model = detector.model
    if seed is not None:
        model.reset_parameters(seed)
    params = dict(model.named_parameters())
    batch_stats = {k: b for k, b in model.named_buffers()
                   if k.endswith(("running_mean", "running_var"))}
    ema = ({k: p.detach().clone() for k, p in params.items()}
           if ema_decay > 0 else None)
    return TrainState(0, params, batch_stats, optimizer.init(params), ema)


def inference_variables(state: TrainState) -> dict:
    """The state dict to serve: the EMA weights when tracked, and the BN
    running statistics; whole tensors of an FSDP state (a collective:
    every rank calls it)."""
    params = state.ema_params if state.ema_params is not None else state.params
    out = {k: mesh_lib.full_tensor(v.detach()) for k, v in params.items()}
    out.update({k: v.detach() for k, v in state.batch_stats.items()})
    return out


# metrics that are a rank's share of the global value (summed over ranks)
_SUMMED = ("loss", "classification_loss", "localization_loss",
           "distill_loss")


def make_train_step(detector: Detector, optimizer: Optimizer,
                    ema_decay: float = 0.0, grad_accum_steps: int = 1,
                    teacher: Detector | None = None,
                    mesh: "mesh_lib.Mesh | None" = None):
    """Returns ``step(state, batch) -> (state, metrics)``, which updates the
    state in place.

    ``teacher``: a trained ``Detector`` at this detector's resolution, for
    knowledge distillation (``Detector.loss``); its weights never change.

    ``grad_accum_steps > 1`` splits the batch into that many strided
    microbatches (``batch[i::n]``, as the JAX package does), each with its
    own loss normaliser and BN batch statistics; the gradients and metrics
    are summed in order and averaged, and one update is applied. BN running
    statistics update once per microbatch. L2 is added once, after the
    backward (``_add_l2``). ``metrics["grad_norm"]`` is the global norm of
    the averaged gradients with L2's, before freeze and clip.

    ``mesh``: a data-parallel step over the mesh's ranks (see the module
    docstring): ``batch`` is this rank's rows (equal counts on every
    rank), tensors on its device or a host batch, which goes there through
    the pinned staging (``parallel.mesh.shard_batch``); microbatches
    stride each rank's rows, which equals JAX's stride over the global
    batch when the rank's rows divide by ``grad_accum_steps``. The
    replicated gradients are all-reduced (one flat buffer), an FSDP
    state's (``DTensor`` parameters) arrive reduce-scattered; L2 is added
    to the sum.
    """
    n = max(grad_accum_steps, 1)
    decay = _F32(ema_decay)
    keep = float(_F32(1) - decay)
    decay = float(decay)
    group = None if mesh is None else mesh.group
    weight_decay = detector.cfg.losses.weight_decay

    def step(state: TrainState, batch: dict):
        if group is not None and not isinstance(batch["images"],
                                                torch.Tensor):
            batch = mesh_lib.shard_batch(mesh, batch)
        params = state.params
        for p in params.values():
            p.grad = None
        msum = None
        with mesh_lib.data_parallel(group):
            for i in range(n):
                micro = (batch if n == 1
                         else {k: v[i::n] for k, v in batch.items()})
                total, metrics = detector.loss(micro, teacher, l2=False)
                total.backward()
                msum = metrics if msum is None else {
                    k: msum[k] + metrics[k] for k in msum}
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        if group is not None:
            _reduce(grads, msum, group)
        if n > 1:
            inv = 1.0 / n
            grads = {k: g * inv for k, g in grads.items()}
            msum = {k: v * inv for k, v in msum.items()}
        _add_l2(grads, params, msum, weight_decay)
        msum["grad_norm"] = mesh_lib.full_tensor(
            global_norm(grads.values()).detach())
        optimizer.update(grads, state.opt_state, params)
        for p in params.values():
            p.grad = None
        if state.ema_params is not None:
            with torch.no_grad():
                for k, e in state.ema_params.items():
                    e.copy_(e * decay + params[k] * keep)
        state.step += 1
        return state, msum

    return step


def _reduce(grads: dict, metrics: dict, group) -> None:
    """Sums the replicated gradients and each rank's share of the metrics
    over the ranks, in place (FSDP's sharded gradients are already
    summed). ``num_positives`` is global already."""
    plain = [g for g in grads.values() if not mesh_lib.is_sharded(g)]
    shares = [k for k in _SUMMED if k in metrics]
    summed = torch.stack([metrics[k] for k in shares])
    mesh_lib.all_reduce_(plain + [summed], group)
    metrics.update(zip(shares, summed.unbind(0)))


def _add_l2(grads: dict, params: dict, metrics: dict,
            weight_decay: float) -> None:
    """The step's L2, once, after the backward (and a data-parallel
    step's sum over the ranks): its gradient ``weight_decay * w`` on each
    kernel (``losses.l2_regularization``'s leaves; an FSDP state's
    shard), its value (a collective under FSDP) in the loss and the
    metrics. One path for every step, so that a step at world size 1 is
    the one-device step bit for bit: through autograd the L2 term would
    join a head weight's gradient among its pyramid levels' terms, in
    another order than after them."""
    with torch.no_grad():
        for k, p in params.items():
            if p.dim() >= 2:
                grads[k] = grads[k] + p * weight_decay
        reg = mesh_lib.full_tensor(
            l2_regularization(params.values(), weight_decay))
    metrics["loss"] = metrics["loss"] + reg
    metrics["regularization_loss"] = reg
