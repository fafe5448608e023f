"""The control, the next precision down put in the program's place, comes
out not correct: here at a size a test run holds, on the CPU, and on the
card at the cell's own size (marked ``cuda``; it skips without a card).
The limits it is held to are the cell's (``limits/<cell>.json``; the
train cell at 128 px takes that size's own, ``conftest.tiny``)."""

from __future__ import annotations

import json
import os

import pytest
import torch

from conftest import ROOT, SEED, manifest, tiny

from bench_port import controls, harness

CELLS = ["ssd_mnv1_fpn_640.serve_int8_b32", "ssd_mnv1_fpn_640.serve_bf16_b32",
         "retinanet_r50_fpn_640.train_b64",
         "retinanet_r50_fpn_640.train_dp4_b256"]
MANIFEST = manifest()


def fails(cell, readings: dict) -> bool:
    return any(readings[k] > limit for k, (_, limit)
               in cell.checks(readings).items())


def read(workload: str, device, seed: int, overrides=None) -> tuple:
    cell = harness.Cell(MANIFEST, workload, seed, 1.0, False, device, 0.0,
                        overrides)
    if cell.traffic["driver"] == "train_dp":
        if device.type == "cuda" and \
                torch.cuda.device_count() < cell.traffic["ranks"]:
            pytest.skip(f"the cell's own size runs on "
                        f"{cell.traffic['ranks']} cards")
        return cell, controls.dp_readings(cell, [seed], ["control"])[1][0]
    fn = (controls.train_readings if "train" in workload
          else controls.serve_readings)
    return cell, fn(cell, "control")


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct_at_a_small_size(workload):
    over = tiny(workload)
    cell, readings = read(workload, torch.device("cpu"), SEED, over)
    assert fails(cell, readings), readings


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("the cell's own size runs on the card")
    for seed in (SEED, SEED + 1, SEED + 2):
        cell, readings = read(workload, torch.device("cuda", 0), seed)
        assert fails(cell, readings), (seed, readings)


def test_limits_name_only_numbers_the_judge_reads():
    from bench_port import judge
    serve = set(judge.GAPS)
    train = {"loss_gap", "grad_gap", "update_gap", "replica_mismatch"}
    for w in MANIFEST["workloads"]:
        with open(os.path.join(ROOT, "bench_port", "limits",
                               w["name"] + ".json")) as f:
            names = set(json.load(f))
        assert names and names <= (train if "train" in w["name"]
                                   else serve), (w["name"], names)
