"""The FLOPs an image that ``mfu`` divides by, as each configuration's
file holds them, equal FlopCounterMode's count over the reference at the
cell's shapes (the meta device: shapes only)."""

from __future__ import annotations

import json
import os

import pytest

from conftest import ROOT

from bench_port import flops

CONFIGS = sorted(os.listdir(os.path.join(ROOT, "bench_port", "configs")))


@pytest.mark.parametrize("name", CONFIGS)
def test_flop_constants_are_the_references_count(name):
    with open(os.path.join(ROOT, "bench_port", "configs", name)) as f:
        conf = json.load(f)
    assert conf["flops_per_image"] == {
        "serve": flops.per_image(conf["config"]),
        "train": flops.per_image(conf["config"], train=True)}


def test_the_depthwise_weight_gradient_is_counted_once():
    with open(os.path.join(ROOT, "bench_port", "configs",
                           "ssd_mnv1_fpn_640.json")) as f:
        cfg = json.load(f)["config"]
    params = flops._params(cfg, True)
    # ds3's depthwise weight gradient: 2 * N * 160 * 160 * 128 * 9 each way
    assert flops._depthwise_wgrad_excess(params, cfg, 1) > 0
