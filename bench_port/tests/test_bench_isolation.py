"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: top-level module names compared
whole (``ssd_tpu_torch`` begins with ``ssd_tpu``)."""

from __future__ import annotations

import ast
import glob
import os

from conftest import ROOT

BENCH = os.path.join(ROOT, "bench_port")
FORBIDDEN = {"jax", "jaxlib", "flax", "ssd_tpu"}


def imported_tops(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def sources(*parts) -> list[str]:
    return sorted(glob.glob(os.path.join(BENCH, *parts, "**", "*.py"),
                            recursive=True))


def test_no_module_imports_jax_or_the_jax_package():
    found = {p: imported_tops(p) & FORBIDDEN for p in sources()}
    assert not {p: t for p, t in found.items() if t}


def test_the_port_is_not_taken_for_the_jax_package():
    assert "ssd_tpu_torch" not in FORBIDDEN
    assert "ssd_tpu_torch".split(".")[0] != "ssd_tpu"


def test_reference_imports_nothing_of_the_program():
    found = {p: imported_tops(p) & {"ssd_tpu_torch", "ssd_tpu"}
             for p in sources("reference")}
    assert not {p: t for p, t in found.items() if t}
    assert sources("reference")


def test_harness_checks_loaded_modules_by_whole_name(monkeypatch):
    import sys

    from bench_port import harness
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ssd_tpu_torch_probe", sys)
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "ssd_tpu.probe", sys)
    assert "ssd_tpu" in harness.forbidden_modules()
