"""``ssd_tpu_torch/tools/train_memory.py`` on the CPU: tallying the saved
tensors leaves the step's loss and gradients as they were, and counts each
saved storage once, by the module that saved it."""

import json

import numpy as np
import torch

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.models.detector import Detector
from ssd_tpu_torch.tools import train_memory
from ssd_tpu_torch.tools.bench_train import synthetic_batch

SMALL = dict(image_size=64, num_classes=8,
             model=dict(backbone="resnet50", fpn_channels=32, head_depth=1,
                        compute_dtype="float32"))


def grads(det: Detector, batch: dict, tally: bool) -> tuple:
    det.model.zero_grad(set_to_none=True)
    if tally:
        with train_memory.SavedTally(det.model) as t:
            total, _ = det.loss(batch)
    else:
        t = None
        total, _ = det.loss(batch)
    total.backward()
    return (float(total.detach()),
            [p.grad.clone() for p in det.model.parameters()], t)


def test_tally_changes_nothing_and_counts_by_module():
    cfg = Config.from_dict(SMALL)
    det = Detector(cfg, device="cpu")
    batch = synthetic_batch(cfg, 2)
    state = {k: v.clone() for k, v in det.model.state_dict().items()}
    loss, want, _ = grads(det, batch, tally=False)
    det.model.load_state_dict(state)  # the BN running statistics
    got_loss, got, tally = grads(det, batch, tally=True)
    assert got_loss == loss
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    saved = dict(tally.bytes)
    assert {k.split("/")[0] for k in saved} >= {"BatchNorm", "Bottleneck",
                                                 "loss"}
    assert saved["BatchNorm/float32"] > 0
    grads(det, batch, tally=False)  # the hooks are gone after the context
    assert dict(tally.bytes) == saved and not tally.stack


def test_cli_prints_one_line_a_batch(capsys):
    rows = train_memory.main([
        "--config", "configs/coco_retinanet_resnet50_640.json",
        "--batch", "1", "--batch", "2", "--set", "image_size=64",
        "--set", "num_classes=8", "--set", "model.fpn_channels=32",
        "--set", "model.head_depth=1", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(x)["batch"] for x in lines] == [1, 2]
    assert [r["oom"] for r in rows] == [None, None]
    one, two = (r["saved_gib"] for r in rows)
    assert np.isclose(sum(rows[1]["saved"].values()), two)
    assert one < two <= 2 * one
