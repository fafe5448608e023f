"""Each cell driven through the harness on the CPU at a tiny size, past
its look for a card: sound, it comes out correct; with its timed path
broken underneath, in each way the cell can break, it does not. (The
dry run of every driver before a chip call is the sound case.)"""

from __future__ import annotations

import pytest

from conftest import run_tiny

from bench_port import faults

SERVE = ["ssd_mnv1_fpn_640.serve_int8_b32", "ssd_mnv1_fpn_640.serve_bf16_b32"]
TRAIN = "retinanet_r50_fpn_640.train_b64"


@pytest.mark.parametrize("workload", SERVE + [TRAIN])
def test_sound_runs_are_correct(workload):
    for trace in (0, 1):
        line = run_tiny(workload, trace=trace)
        assert line["correct"], line["checks"]
        assert line["metrics"]
        assert list(line)[-1] == "checks"


@pytest.mark.parametrize("workload", SERVE)
@pytest.mark.parametrize("fault", faults.SERVING)
def test_serving_faults_come_out_not_correct(workload, fault):
    with faults.planted(fault):
        line = run_tiny(workload)
    assert not line["correct"], line["checks"]


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    from ssd_tpu_torch.train_step import Optimizer

    def update(self, grads, opt_state, params):
        opt_state["count"] += 1
    monkeypatch.setattr(Optimizer, "update", update)
    assert not run_tiny(TRAIN)["correct"]


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    from ssd_tpu_torch.train import DeviceFeed
    real = DeviceFeed.__call__

    def feed(self, batch):
        half = len(batch["images"]) // 2
        return real(self, {k: v[:half] for k, v in batch.items()})
    monkeypatch.setattr(DeviceFeed, "__call__", feed)
    assert not run_tiny(TRAIN)["correct"]
