"""The reference agrees with the port's plain CPU path at a tiny size, in
float32: the two models' raw maps, the postprocess's detections, and a
training step's loss, gradient and update. Where the port rounds the
normalized image to bf16 before a float32 model (either stem's input,
as the JAX package does), the reference's input is rounded the same way
here, so that what is compared is the arithmetic after it."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from conftest import ROOT

from bench_port.reference import detect
from bench_port.reference.model import Model, param_shapes
from bench_port.reference.train import Trainer
from bench_port.weights import seeded_state

MOBILENET = "bench_port/configs/ssd_mnv1_fpn_640.json"
RESNET = "bench_port/configs/retinanet_r50_fpn_640.json"


def config(path: str, size: int = 128) -> dict:
    """A configuration as its cells run it, at ``size`` and in float32."""
    with open(os.path.join(ROOT, path)) as f:
        d = json.load(f)["config"]
    d["image_size"] = size
    d["model"]["compute_dtype"] = "float32"
    return d


class RoundedInput(Model):
    """The reference with the port's bf16 rounding of the normalized
    image (either stem's input)."""

    def normalized(self, images):
        return super().normalized(images).to(torch.bfloat16).float()


@pytest.mark.parametrize("path", [MOBILENET, RESNET])
def test_shapes_are_the_ports(path):
    from ssd_tpu_torch.config import Config
    from ssd_tpu_torch.models.detector import SSDModel
    d = config(path)
    port = {k: tuple(v.shape)
            for k, v in SSDModel(Config.from_dict(d)).state_dict().items()}
    assert port == param_shapes(d)


@pytest.mark.parametrize("path", [MOBILENET, RESNET])
def test_forward_and_detections_match_the_port(path):
    from ssd_tpu_torch.config import Config
    from ssd_tpu_torch.models.detector import Detector
    d = config(path)
    state = seeded_state(param_shapes(d), 11, torch.device("cpu"), -2.5)
    det = Detector(Config.from_dict(d), state, device="cpu")
    images = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 128, 128, 3), dtype=np.uint8))
    with torch.no_grad():
        raw = det.model.eval()(images)
        ref = RoundedInput(d, state)(images)
    for (a, b), (c, e) in zip(raw, ref):
        scale = float(c.abs().max())
        assert float((a - c).abs().max()) <= 1e-5 * max(scale, 1.0)
        assert float((b - e).abs().max()) <= 1e-5 * max(
            float(e.abs().max()), 1.0)
    out = det.predict(images)
    anchors = torch.from_numpy(detect.anchors(128, d["anchors"]))
    want = detect.hard_nms(*detect.select_cells(
        ref, anchors, d["num_classes"], d["nms"]), d["nms"])
    assert torch.equal(out.num_boxes, want["num_boxes"])
    assert torch.equal(out.labels, want["labels"].to(out.labels.dtype))
    assert float((out.scores - want["scores"]).abs().max()) <= 1e-5
    assert float((out.boxes - want["boxes"]).abs().max()) <= 1e-5


def test_anchors_are_the_ports():
    from ssd_tpu_torch.config import Config
    from ssd_tpu_torch.ops.anchors import generate_anchors
    d = config(MOBILENET, 640)
    np.testing.assert_array_equal(
        detect.anchors(640, d["anchors"]),
        generate_anchors(640, Config.from_dict(d).anchors))


@pytest.mark.parametrize("box_loss", ["giou", "smooth_l1"])
def test_training_loss_matches_the_ports(box_loss):
    """The MobileNet-v1 configuration's loss (its giou box loss, and
    smooth-L1), with its ReLU6 blocks; its gradients are not compared at this size: flax's
    fast variance, E[x^2] - E[x]^2, cancels in float32 on channels that
    ReLU6 saturates, and two summation orders then part by 1e-4."""
    from ssd_tpu_torch.config import Config
    from ssd_tpu_torch.models.detector import Detector

    from bench_port import generator
    d = config(MOBILENET, 128)
    d["losses"]["box_loss"] = box_loss
    state = seeded_state(param_shapes(d), 5, torch.device("cpu"), -4.59512,
                         0.01)
    init = {k: v.clone() for k, v in state.items()}
    det = Detector(Config.from_dict(d), state, device="cpu")
    b = generator.scene_batch(9, 0, 4, (128, 128), 80, {"sides": [8, 64]},
                            torch.device("cpu"))
    b = {k: torch.from_numpy(v) for k, v in b.items()}
    total, _ = det.loss(b, l2=False)
    ref = Trainer(d, init)
    ref.model = RoundedInput(d, ref.params)
    ref.model.training = True
    want = float(ref.loss(b).detach())
    assert abs(float(total) - want) <= 1e-5 * abs(want)


def test_training_steps_match_the_ports():
    """ResNet-50 (the train cell's model): three steps' losses, the first
    gradient as the optimizer takes it and the weights' change."""
    path = RESNET
    from ssd_tpu_torch.config import Config
    from ssd_tpu_torch.models.detector import Detector
    from ssd_tpu_torch.train_step import (Optimizer, create_train_state,
                                          make_train_step)

    from bench_port import generator, judge
    size = 128
    d = config(path, size)
    # the second step moves the weights, by little: at 128 px the deepest
    # batch norms see a few values each, and a large step amplifies the
    # float32 rounding of two summation orders
    d["train"]["warmup_steps"] = 2
    d["train"]["learning_rate"] = 0.004
    state = seeded_state(param_shapes(d), 5, torch.device("cpu"), -4.59512,
                         0.01)
    init = {k: v.clone() for k, v in state.items()}
    det = Detector(Config.from_dict(d), state, device="cpu")
    opt = Optimizer(Config.from_dict(d))
    ts = create_train_state(det, opt)
    step = make_train_step(det, opt)
    scenes = {"sides": [8, 64]}
    batches = [generator.scene_batch(9, i, 4, (size, size), 80, scenes,
                                   torch.device("cpu")) for i in range(3)]
    losses = []
    for i, b in enumerate(batches):
        _, m = step(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        if i == 0:
            grad = {k: v.clone() for k, v in ts.opt_state["trace"].items()}
    ref = Trainer(d, init)
    ref.model = RoundedInput(d, ref.params)
    ref.model.training = True
    ref_losses = []
    for i, b in enumerate(batches):
        ref_losses.append(ref.step({k: torch.from_numpy(v)
                                    for k, v in b.items()})["loss"])
        if i == 0:
            ref_grad = {k: v.clone() for k, v in ref.trace.items()}
    change = {k: ts.params[k].detach() - init[k] for k in ref.params}
    ref_change = {k: ref.params[k].detach() - init[k] for k in ref.params}
    gaps = judge.train_gaps(losses, ref_losses, grad, ref_grad, change,
                            ref_change)
    assert gaps["loss_gap"] < 1e-5, gaps
    assert gaps["grad_gap"] < 1e-5, gaps
    assert gaps["update_gap"] < 1e-3, gaps


DP_RANK = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from bench_port import generator
from bench_port.reference.model import param_shapes
from bench_port.reference.train import Trainer
from bench_port.weights import seeded_state

a = json.loads(sys.argv[1])
torch.set_num_threads(2)
dist.init_process_group("gloo", init_method=a["init"], world_size=2,
                        rank=a["rank"])
d = a["cfg"]
state = seeded_state(param_shapes(d), 5, torch.device("cpu"), -4.59512, 0.01)
ref = Trainer(d, state, group=dist.group.WORLD)
rows = slice(2 * a["rank"], 2 * a["rank"] + 2)
losses = []
for i in range(3):
    b = generator.scene_batch(9, i, 4, (128, 128), 80, {"sides": [8, 64]},
                              torch.device("cpu"))
    losses.append(ref.step({k: torch.from_numpy(v[rows])
                            for k, v in b.items()})["loss"])
    if i == 0:
        grad = {k: v.clone() for k, v in ref.trace.items()}
if a["rank"] == 0:
    np.savez(a["out"], losses=np.array(losses),
             **{"g." + k: v.numpy() for k, v in grad.items()},
             **{"p." + k: v.detach().numpy() for k, v in ref.params.items()})
dist.destroy_process_group()
"""


def test_the_data_parallel_reference_is_the_global_batch_step(tmp_path):
    """The reference's data-parallel step, two gloo ranks of 2 rows each,
    is its one-process step on the 4 rows (global batch norm, positive
    count, summed gradients), in float32 up to the order of the sums. The
    learning rate is a tenth of the port's test's: at 128 px a step of
    that one moves the third loss by half, and the two orders' rounding
    with it."""
    import socket
    import subprocess
    import sys

    from bench_port import generator, judge
    d = config(RESNET)
    d["train"]["warmup_steps"] = 2
    d["train"]["learning_rate"] = 0.0004
    with socket.socket() as s:
        s.bind(("localhost", 0))
        init = f"tcp://localhost:{s.getsockname()[1]}"
    out = tmp_path / "rank0.npz"
    procs = [subprocess.Popen(
        [sys.executable, "-c", DP_RANK, json.dumps(
            {"init": init, "rank": r, "cfg": d, "out": str(out)})], cwd=ROOT)
        for r in (0, 1)]
    state = seeded_state(param_shapes(d), 5, torch.device("cpu"), -4.59512,
                         0.01)
    init_params = {k: v.clone() for k, v in state.items()}
    ref = Trainer(d, state)
    losses = []
    for i in range(3):
        b = generator.scene_batch(9, i, 4, (128, 128), 80, {"sides": [8, 64]},
                                  torch.device("cpu"))
        losses.append(ref.step({k: torch.from_numpy(v)
                                for k, v in b.items()})["loss"])
        if i == 0:
            grad = {k: v.clone() for k, v in ref.trace.items()}
    for p in procs:
        assert p.wait(timeout=600) == 0
    dp = np.load(out)
    dp_grad = {k: torch.from_numpy(dp["g." + k]) for k in grad}
    change = {k: ref.params[k].detach() - init_params[k] for k in grad}
    dp_change = {k: torch.from_numpy(dp["p." + k]) - init_params[k]
                 for k in grad}
    gaps = judge.train_gaps(list(dp["losses"]), losses, dp_grad, grad,
                            dp_change, change)
    # the median leaf: at 128 px the deepest norms see 2 x 2 x 4 values,
    # gradients before the clip reach 1e4 and the two orders of the means'
    # sums part a few leaves by up to 0.5% (the means of the ranks' rows
    # left unsummed part the losses by a tenth)
    assert gaps["loss_gap"] < 1e-5, gaps
    assert gaps["grad_gap"] < 1e-3, gaps
    assert gaps["update_gap"] < 1e-3, gaps
