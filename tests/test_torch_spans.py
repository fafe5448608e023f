"""The program's spans inside a predict and a training step.

A ``torch.profiler`` window on the CPU records the ``record_function``
ranges: ``Detector.predict``'s ``predict.model``, ``predict.select`` and
``predict.nms`` inside the predictor's ``predict.launch``, and the step's
``train.feed`` (``DeviceFeed``), ``train.step`` and its phases, with a
microbatch's phases once a microbatch and the update once a step.
"""

import numpy as np
import pytest
import torch

from ssd_tpu_torch.config import (Config, DataConfig, LossConfig,
                                  ModelConfig, TrainConfig)
from ssd_tpu_torch.data import synthetic
from ssd_tpu_torch.models.detector import Detector
from ssd_tpu_torch.predictor import Predictor
from ssd_tpu_torch.train import DeviceFeed
from ssd_tpu_torch.train_step import (Optimizer, create_train_state,
                                      make_train_step)

PHASES = ("train.forward", "train.targets", "train.loss", "train.backward")


def tiny_cfg(**train_kw) -> Config:
    train = dict(batch_size=4, optimizer="momentum", learning_rate=0.01,
                 warmup_steps=0, num_steps=10, gradient_clip_norm=10.0,
                 ema_decay=0.9)
    train.update(train_kw)
    return Config(
        num_classes=4, image_size=64,
        model=ModelConfig(width_multiplier=0.25, fpn_channels=16,
                          head_depth=1, stem_schedule="reference",
                          compute_dtype="float32"),
        losses=LossConfig(box_loss="giou"),
        train=TrainConfig(**train), data=DataConfig(max_gt_boxes=6))


def spans(prof, prefixes: tuple) -> list:
    """``(name, the innermost enclosing span's name or None)`` of each
    span whose name starts with one of ``prefixes``, in start order (the
    profiler's events as recorded, ``kineto_results``)."""
    ranges = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.name().startswith(prefixes)),
                    key=lambda r: (r[1], -r[2]))
    out = []
    for i, (name, start, end) in enumerate(ranges):
        outer = [r for j, r in enumerate(ranges)
                 if j != i and r[1] <= start and end <= r[2]]
        out.append((name, min(outer, key=lambda r: r[2] - r[1])[0]
                    if outer else None))
    return out


def profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def test_predict_splits_its_launch_into_model_select_and_nms():
    torch.manual_seed(0)
    pred = Predictor(tiny_cfg(), None, device="cpu")
    images = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    pred.predict(images)  # warm
    got = spans(profiled(lambda: pred.predict(images)), ("predict.",))
    inner = [s for s in got if s[0] in ("predict.model", "predict.select",
                                        "predict.nms")]
    assert inner == [("predict.model", "predict.launch"),
                     ("predict.select", "predict.launch"),
                     ("predict.nms", "predict.launch")]
    assert [n for n, _ in got if n not in dict(inner)] == [
        "predict.feed", "predict.copy", "predict.launch", "predict.launch",
        "predict.readback"]


@pytest.mark.parametrize("accum", [1, 2])
def test_step_opens_feed_step_and_each_phase(accum):
    cfg = tiny_cfg(grad_accum_steps=accum)
    det = Detector(cfg, device="cpu")
    opt = Optimizer(cfg)
    state = create_train_state(det, opt, cfg.train.ema_decay)
    step = make_train_step(det, opt, cfg.train.ema_decay, accum)
    feed = DeviceFeed(torch.device("cpu"))
    rng = np.random.default_rng(1)
    batch = synthetic.pad_batch(
        [synthetic.crowded_example(rng, cfg.num_classes, 64, 3, 6)
         for _ in range(4)], 6)
    got = spans(profiled(lambda: step(state, feed(batch))), ("train.",))
    assert got[:2] == [("train.feed", None), ("train.step", None)]
    assert got[2:] == ([(p, "train.step") for p in PHASES] * accum
                       + [("train.update", "train.step")])
    assert state.step == 1
