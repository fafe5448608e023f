"""Shared by the benchmark's CPU tests: cells cut to a size a test run
holds (128 px, batches of 4, two pool batches; a data-parallel cell two
gloo ranks of 2 rows each), run through the harness on the CPU as the
chip would run them, past its look for a card."""

from __future__ import annotations

import argparse
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SEED = 2 ** 31 + 1234  # past 32 signed bits: seeds may be that large


def tiny(workload: str) -> dict:
    """The cell at 128 px; training's model in float32 (the CPU's bf16
    convs take minutes at any useful size)."""
    cfg = {"image_size": 128, "train": {"batch_size": 4}}
    if "train" in workload:
        cfg["model"] = {"compute_dtype": "float32"}
    out = {"config": cfg,
           "traffic": {"batch": 4, "pool_batches": 2}}
    if "_dp" in workload:  # the same global batch of 4, over two ranks
        out["traffic"].update(ranks=2, rows=2)
    # this size's own limits (the cells' hold their full-size runs): at
    # 128 px training's deepest batch norms see 4-16 values, and the
    # port's bf16 rounding of the normalized image alone moves sound runs'
    # loss by 0.003-0.009 and the median leaf by 0.006-0.013 (seeds 5 and
    # 6, 128 and 256 px); serving's controls read less over 3 069
    # anchors and 8 images than over 76 725 anchors and 256: int8's int4
    # 4.6, the int8 path's off share 0.01-0.10 (seeds SEED to SEED + 2),
    # where its widest gap, 0.24-0.37, stands clear of the program's
    # 0.065-0.076 (the limit adds to the cell's); MobileNet-v1's train
    # cell adds the EMA's, as the cell's (sound 0-1e-6 over seeds SEED to
    # SEED + 5, the EMA as a lerp 8e-5-1e-4, its EMA left unchanged 1):
    # the last key that matches holds
    for key, limits in TINY_LIMITS.items():
        if key in workload:
            out["limits"] = limits
    return out


TINY_LIMITS = {"train": {"loss_gap": 0.03, "grad_gap": 0.05,
                         "update_gap": 0.04},
               "int8": {"logit_gap": 1.0},
               "bf16": {"logit_gap_max": 0.15},
               "ssd_mnv1_fpn_640.train": {"loss_gap": 0.03, "grad_gap": 0.05,
                                          "update_gap": 0.04,
                                          "ema_gap": 0.01}}


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def run_tiny(workload: str, trace: int = 0, seconds: float = 1.0,
             seed: int = SEED, traffic: dict | None = None,
             bench: dict | None = None) -> dict:
    """``traffic``: more keys over the tiny mix (a ``fault``); ``bench``:
    a manifest in place of ``BENCHMARK.json``."""
    from bench_port import run
    args = argparse.Namespace(workload=workload, seed=seed,
                              seconds=seconds, trace=trace)
    over = tiny(workload)
    over["traffic"].update(traffic or {})
    return run.run(args, torch.device("cpu"), over, bench or manifest())


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(prev)
