"""The FLOPs an image that ``mfu`` divides by, as each configuration's
file holds them, equal FlopCounterMode's count over the configuration's
own reference (``reference.for_config``) at the cell's shapes (the meta
device: shapes only)."""

from __future__ import annotations

import json
import os

import pytest

from conftest import ROOT

from bench_port import flops
from bench_port.reference import for_config, model

CONFIGS = sorted(os.listdir(os.path.join(ROOT, "bench_port", "configs")))


def load(name: str) -> dict:
    with open(os.path.join(ROOT, "bench_port", "configs", name)) as f:
        return json.load(f)


@pytest.mark.parametrize("name", CONFIGS)
def test_flop_constants_are_the_references_count(name):
    conf = load(name)
    assert conf["flops_per_image"] == {
        "serve": flops.per_image(conf),
        "train": flops.per_image(conf, train=True)}


def test_the_depthwise_weight_gradient_is_counted_once():
    cfg = load("ssd_mnv1_fpn_640.json")["config"]
    params = flops._params(model, cfg, True)
    # ds3's depthwise weight gradient: 2 * N * 160 * 160 * 128 * 9 each way
    assert model.wgrad_excess(params, cfg, 1) > 0


def test_naming_the_default_reference_counts_the_same():
    conf = load("ssd_mnv1_fpn_640.json")
    named = dict(conf, reference="model")
    assert for_config(named) is for_config(conf) is model
    assert flops.per_image(named, train=True) == \
        conf["flops_per_image"]["train"]


@pytest.mark.parametrize("name", ["no_such_module", "detect", "__init__",
                                  "../flops", 3])
def test_a_reference_that_is_no_module_fails_naming_the_key(name):
    conf = dict(load("retinanet_r50_fpn_640.json"), reference=name)
    with pytest.raises(ValueError, match="'reference' key"):
        for_config(conf)
    with pytest.raises(ValueError, match="'reference' key"):
        flops.per_image(conf)
