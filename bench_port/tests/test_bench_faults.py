"""Each cell driven through the harness on the CPU at a tiny size, past
its look for a card: sound, it comes out correct; with its timed path
broken underneath, in each way the cell can break, it does not. (The
dry run of every driver before a chip call is the sound case.) The
data-parallel cell runs two gloo ranks, the second a process of its own,
with each fault planted in both."""

from __future__ import annotations

import copy
import json
import os

import pytest
import torch

from conftest import ROOT, SEED, manifest, run_tiny, tiny

from bench_port import controls, faults, harness

SERVE = ["ssd_mnv1_fpn_640.serve_int8_b32", "ssd_mnv1_fpn_640.serve_bf16_b32"]
TRAIN = "retinanet_r50_fpn_640.train_b64"
DP = "retinanet_r50_fpn_640.train_dp4_b256"
EMA = "ssd_mnv1_fpn_640.train_b64"  # MobileNet-v1, GIoU, the shipped EMA


@pytest.mark.parametrize("workload", SERVE + [TRAIN, DP, EMA])
def test_sound_runs_are_correct(workload):
    for trace in (0, 1):
        line = run_tiny(workload, trace=trace)
        assert line["correct"], line["checks"]
        assert line["metrics"]
        assert list(line)[-1] == "checks"
        if workload == DP:
            assert line["device"]["count"] == 2


@pytest.mark.parametrize("workload", SERVE)
@pytest.mark.parametrize("fault", faults.SERVING)
def test_serving_faults_come_out_not_correct(workload, fault):
    with faults.planted(fault):
        line = run_tiny(workload)
    assert not line["correct"], line["checks"]


def test_a_step_that_leaves_the_state_unchanged_is_not_correct():
    with faults.planted("unchanged_state"):
        assert not run_tiny(TRAIN)["correct"]


def test_half_the_batch_left_out_is_not_correct():
    with faults.planted("half_batch"):
        assert not run_tiny(TRAIN)["correct"]


@pytest.mark.parametrize("fault", ("unchanged_state", "half_batch")
                         + faults.EMA)
def test_the_ema_cells_faults_come_out_not_correct(fault):
    with faults.planted(fault):
        line = run_tiny(EMA)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("variant", faults.SOUND)
def test_the_ema_cells_sound_variants_come_out_correct(variant):
    """At the cell's own learning rate and warm-up, which the tiny cell
    keeps: the EMA as a lerp, more exact than the port's formula."""
    with faults.planted(variant):
        line = run_tiny(EMA)
    assert line["correct"], line["checks"]
    assert line["checks"]["ema_gap"]["value"] < 1e-3, line["checks"]


def test_the_ema_is_compared_only_where_the_configuration_keeps_one():
    """``ema_gap`` is read and held to its limit in the cell whose
    configuration keeps an EMA; the ResNet-50 cells (``ema_decay`` 0)
    read none, so their checks are what they were."""
    for workload, kept in ((EMA, True), (TRAIN, False)):
        cell = harness.Cell(manifest(), workload, SEED, 1.0, False,
                            torch.device("cpu"), 0.0, tiny(workload))
        readings = controls.train_readings(cell, "program")
        assert ("ema_gap" in readings) == kept, (workload, readings)
        assert ("ema_gap" in cell.checks(readings)) == kept


@pytest.mark.parametrize("fault", faults.TRAINING)
def test_data_parallel_faults_come_out_not_correct(fault):
    line = run_tiny(DP, traffic={"fault": fault})
    assert not line["correct"], line["checks"]


def test_a_rank_that_loads_jax_gives_no_result(tmp_path, monkeypatch,
                                               capfd):
    """Rank 1, a process of its own, starts with a module named ``jax``
    loaded (a ``sitecustomize`` on its path plants one): rank 0 prints no
    result and exits with 3, naming the rank and the module."""
    (tmp_path / "sitecustomize.py").write_text(
        "import sys, types\n"
        "sys.modules.setdefault('jax', types.ModuleType('jax'))\n")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (str(tmp_path), os.environ.get("PYTHONPATH")) if p))
    with pytest.raises(SystemExit) as exit_:
        run_tiny(DP)
    assert exit_.value.code == 3
    assert "{1: ['jax']}" in capfd.readouterr().err


def test_naming_the_default_reference_runs_the_same(tmp_path):
    """A configuration whose ``reference`` key names ``model`` gives the
    same sound run as the one without the key."""
    bench = manifest()
    conf_entry = next(c for c in bench["configs"]
                      if c["name"] == "retinanet_r50_fpn_640")
    with open(os.path.join(ROOT, conf_entry["file"])) as f:
        conf = json.load(f)
    assert "reference" not in conf
    path = tmp_path / "named.json"
    path.write_text(json.dumps(dict(conf, reference="model")))
    named = copy.deepcopy(bench)
    next(c for c in named["configs"]
         if c["name"] == "retinanet_r50_fpn_640")["file"] = str(path)
    # training's checks come from the set-up's steps: the same each run
    plain, same = run_tiny(TRAIN), run_tiny(TRAIN, bench=named)
    assert plain["correct"] and same["correct"]
    assert same["checks"] == plain["checks"]
