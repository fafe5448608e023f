"""Runs one cell of the port's benchmark once and prints its result.

    python3 -m bench_port.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout (where ``BENCHMARK.json`` is). It measures
``ssd_tpu_torch`` on the card and refuses to run without one: a number
from the CPU is no measurement of the card. With ``--trace 0`` the
result's metrics are the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics (read from a traced window) and a ``breakdown``.
The last lines on standard error, and the result's last key ``checks``,
give each number the comparison that decides ``correct`` took, beside
its limit. The last line on standard output is the result, one JSON
object.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def _cache_env() -> None:
    """Build and kernel caches inside the checkout, at fixed paths, so that
    only a checkout's first run of a cell builds (the port's nvcc builds go
    to ``ssd_tpu_torch/_kernels/``, fixed in its code)."""
    from bench_port.harness import CACHE
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(cell, out: dict) -> dict:
    """The contract's object, ``checks`` last."""
    import torch
    checks = out["checks"]
    correct = all(v <= limit for v, limit in checks.values())
    dev = cell.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": out.get("devices", 1),
              "memory_peak_bytes": out["memory_peak_bytes"]}
    if cell.trace:
        device["busy_s"] = cell.summary["busy_s"] if cell.summary else 0.0
        device["window_s"] = cell.window_s
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": device}
    if cell.trace and cell.summary:
        from bench_port import tracing
        line["breakdown"] = tracing.breakdown(cell.summary)
    line["checks"] = {k: {"value": v, "limit": limit}
                      for k, (v, limit) in checks.items()}
    return line


def run(args, device, overrides=None, manifest=None) -> dict:
    """One run on ``device`` -> the result line (a dict). ``manifest``: in
    place of ``BENCHMARK.json`` (tests drive a cell it does not hold)."""
    from bench_port import harness
    if manifest is None:
        manifest = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cell = harness.Cell(manifest, args.workload, args.seed, args.seconds,
                        bool(args.trace), device, T0, overrides)
    driver = harness.load_module(os.path.join(
        harness.HERE, "drivers", cell.traffic["driver"] + ".py"))
    out = driver.run(cell)
    if not args.trace:
        out["metrics"]["setup_s"] = {"value": cell.setup_s, "unit": "s"}
    return result_line(cell, out)


def main(argv=None) -> int:
    args = parse(argv)
    _cache_env()
    import torch
    from bench_port import harness
    manifest = harness.load_json(harness.ROOT, "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in manifest["workloads"]}.get(
        args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}: no measurement",
              file=sys.stderr)
        return 2
    line = run(args, torch.device("cuda", 0))
    found = harness.forbidden_modules()
    if found:
        print(f"bench_port: the run loaded {found}, which the port's "
              "benchmark must not: no result", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
