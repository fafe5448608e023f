"""The control, the next precision down put in the program's place, comes
out not correct: here at a size a test run holds, on the CPU, and on the
card at the cell's own size (marked ``cuda``; it skips without a card).
The limits it is held to, and which control they were set against, are
the cell's (``limits/<cell>.json``; the train cell at 128 px takes that
size's own limits, ``conftest.tiny``)."""

from __future__ import annotations

import json
import os

import pytest
import torch

from conftest import ROOT, SEED, manifest, tiny

from bench_port import controls, harness

CELLS = ["ssd_mnv1_fpn_640.serve_int8_b32", "ssd_mnv1_fpn_640.serve_bf16_b32",
         "retinanet_r50_fpn_640.train_b64",
         "retinanet_r50_fpn_640.train_dp4_b256",
         "ssd_mnv1_fpn_640.train_b64"]
BF16 = "ssd_mnv1_fpn_640.serve_bf16_b32"
MANIFEST = manifest()


def fails(cell, readings: dict) -> bool:
    return any(readings[k] > limit for k, (_, limit)
               in cell.checks(readings).items())


def read(workload: str, device, seed: int, overrides=None,
         kind: str | None = None) -> tuple:
    cell = harness.Cell(MANIFEST, workload, seed, 1.0, False, device, 0.0,
                        overrides)
    kind = kind or cell.control
    if cell.traffic["driver"] == "train_dp":
        if device.type == "cuda" and \
                torch.cuda.device_count() < cell.traffic["ranks"]:
            pytest.skip(f"the cell's own size runs on "
                        f"{cell.traffic['ranks']} cards")
        return cell, controls.dp_readings(cell, [seed], ["control"])[1][0]
    fn = (controls.train_readings if "train" in workload
          else controls.serve_readings)
    return cell, fn(cell, kind)


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


def test_the_reference_int8_control_reads_above_a_sound_run():
    """The reference's 8-bit emulation in the program's place, which
    needs no int8 path of the program, is not correct on the bf16 cell,
    and reads farther than the program on every anchor's outputs."""
    over = tiny(BF16)
    cell, sound = read(BF16, torch.device("cpu"), SEED, over, "program")
    _, ctl = read(BF16, torch.device("cpu"), SEED, over, "reference_int8")
    assert not fails(cell, sound), sound
    assert fails(cell, ctl), ctl
    assert ctl["raw_off_share"] > sound["raw_off_share"]
    assert ctl["raw_gap"] > sound["raw_gap"]


def test_reference_int8_is_no_control_of_an_int8_cell():
    with pytest.raises(ValueError, match="bf16"):
        read("ssd_mnv1_fpn_640.serve_int8_b32", torch.device("cpu"), SEED,
             tiny("ssd_mnv1_fpn_640.serve_int8_b32"), "reference_int8")


@pytest.mark.cuda
def test_the_reference_int8_control_is_not_correct_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("the cell's own size runs on the card")
    for seed in (SEED, SEED + 1, SEED + 2):
        cell, readings = read(BF16, torch.device("cuda", 0), seed,
                              kind="reference_int8")
        assert fails(cell, readings), (seed, readings)


def test_limits_name_only_numbers_the_judge_reads():
    """Besides its limits, a cell's limits file names the control kind
    they were set against (``control`` by default) and may keep notes."""
    from bench_port import judge
    serve = set(judge.GAPS)
    train = {"loss_gap", "grad_gap", "update_gap", "ema_gap",
             "replica_mismatch"}
    for w in MANIFEST["workloads"]:
        with open(os.path.join(ROOT, "bench_port", "limits",
                               w["name"] + ".json")) as f:
            raw = json.load(f)
        cell = harness.Cell(MANIFEST, w["name"], SEED, 1.0, False,
                            torch.device("cpu"), 0.0)
        names = set(cell.limits)
        assert names and names <= (train if "train" in w["name"]
                                   else serve), (w["name"], names)
        assert all(isinstance(v, (int, float))
                   for v in cell.limits.values())
        assert set(raw) == names | set(cell.notes) | (
            {"control"} if "control" in raw else set())
        kinds = (("control", "int8_step") if "train" in w["name"]
                 else ("control", "reference_int8"))
        assert cell.control in kinds, (w["name"], cell.control)
