"""The readers of the program's phase spans: a predict's model, selection
and NMS, and a step's feed, whole step and update, each in ms a unit."""

from __future__ import annotations

import os

import pytest

from conftest import ROOT

READS = {"model_launch_ms.serve": "predict.model",
         "select_launch_ms.serve": "predict.select",
         "nms_launch_ms.serve": "predict.nms",
         "feed_ms.train": "train.feed",
         "step_launch_ms.train": "train.step",
         "update_launch_ms.train": "train.update"}


def reader(name: str):
    from bench_port import harness
    return harness.load_module(os.path.join(ROOT, "bench_port", "metrics",
                                            name + ".py"))


@pytest.mark.parametrize("name", sorted(READS))
def test_a_phase_span_reads_as_ms_a_unit(name):
    # two units, the span opened three times (one unit twice): summed
    summary = {"units": 2, "spans": {READS[name]: [0.010, 0.004, 0.006],
                                     "predict.launch": [1.0]}}
    assert reader(name).read(summary) == pytest.approx(10.0)
    assert reader(name).read({}) is None
    assert reader(name).read({"units": 2, "spans": {}}) is None
