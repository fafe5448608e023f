"""``BENCHMARK.json`` against the contract's shape rules, and every name in
it against the files the harness finds by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
HERE = os.path.join(ROOT, "bench_port")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["bench_port"]
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [m["name"] for m in METRICS]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    for group in ("configs", "workloads"):
        seen = [e["name"] for e in BENCH[group]]
        assert len(seen) == len(set(seen))
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for text in ([c["why"] for c in BENCH["configs"]]
                 + [w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + [c["source"] for c in BENCH["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text \
            and "\t" not in text


def test_every_cell_reports_what_its_metrics_need():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in BENCH["end_to_end"]}
    assert all(e2e["setup_s"] >= cells for _ in [0])
    for cell in cells:
        assert any(cell in w for k, w in e2e.items() if k != "setup_s")
        assert any(cell in m.get("workloads", cells)
                   for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]], (m["name"], cell)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"]
                if m["name"] == "setup_s")["bound"] <= 0.25


def test_layers_of_a_name_agree():
    names = {}
    for m in BENCH["per_layer"]:
        names.setdefault(m["layer"], []).append(m["name"])
    assert all(1 <= len(layer) <= 200 for layer in names)


@pytest.mark.parametrize("cell", BENCH["workloads"],
                         ids=[w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    conf = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert conf["file"].startswith("bench_port/")
    with open(os.path.join(ROOT, conf["file"])) as f:
        assert json.load(f)["name"] == conf["name"]
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        driver = json.load(f)["driver"]
    assert os.path.exists(os.path.join(HERE, "drivers", driver + ".py"))
    assert os.path.exists(os.path.join(HERE, "limits",
                                       cell["name"] + ".json"))
    assert cell["chips"] in (1, 4)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        ranks = json.load(f).get("ranks", 1)
    assert ranks == cell["chips"]  # a rank a card, as many as it asks for


def test_four_card_cells_are_at_most_a_quarter_or_one():
    four = [w["name"] for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4), four


def test_every_per_layer_metric_has_a_reader():
    from bench_port import harness
    for m in BENCH["per_layer"]:
        reader = harness.load_module(os.path.join(HERE, "metrics",
                                                  m["name"] + ".py"))
        assert reader.read({}) is None  # nothing to read: no number


def test_configuration_files_hold_the_repo_configs():
    """Each configuration is its repo config as shipped but for the keys
    it names under ``departs_from_repo_config``; ``reduced`` is the
    manifest's, and names no group that holds a width (``model``)."""
    for c in BENCH["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        with open(os.path.join(ROOT, conf["repo_config"])) as f:
            repo = json.load(f)
        for key in conf.get("departs_from_repo_config", {}):
            group, name = key.split(".")
            assert repo[group][name] != conf["config"][group][name]
            repo[group][name] = conf["config"][group][name]
        assert conf["config"] == repo
        assert conf["reduced"] == c["reduced"]
        assert "model" not in c["reduced"]
