"""The harness: finds a cell's files by name, runs its driver once and
prints the result line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) joins a
configuration, ``bench_port/configs/<config>.json``, to a traffic mix,
``bench_port/traffic/<traffic>.json``; the configuration names its plain
reference, ``bench_port/reference/<reference>.py`` (``model`` where it
names none: ``reference.for_config``); the mix names its driver,
``bench_port/drivers/<driver>.py``; the limits of the comparison that
decides ``correct`` are ``bench_port/limits/<workload>.json``; each
per-layer metric is read by ``bench_port/metrics/<metric>.py``. Adding a
cell, a configuration, a mix or a metric adds files and entries.

A driver's ``run(cell)`` builds the system under test from the seed,
calls ``cell.setup_done()`` when every shape it will use is warm, runs
its measured window inside ``cell.window()``, then compares what the
window produced with the reference and returns ``{"attempted",
"failed", "checks", "metrics", "memory_peak_bytes"}`` and, where it
ran on more than one device, ``devices``; ``checks`` maps a short name to
``(value, limit)``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time

from bench_port.reference import for_config

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "ssd_tpu")
TRACE_SECONDS = 4.0  # a traced window's length at the most


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str):
    """A module from its file (metric files carry dots in their names)."""
    name = "bench_port._loaded." + os.path.relpath(path, HERE).replace(
        os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``ssd_tpu_torch`` is not ``ssd_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class Cell:
    """One run of one cell: its files, the arguments, the clocks."""

    def __init__(self, manifest: dict, workload: str, seed: int,
                 seconds: float, trace: bool, device, t0: float,
                 overrides: dict | None = None):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; known: "
                             f"{sorted(cells)}")
        self.entry = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in manifest["configs"]}
        conf = configs[self.entry["config"]]
        self.config = load_json(ROOT, conf["file"])
        self.reference = for_config(self.config)  # fails here, named
        self.traffic = load_json(HERE, "traffic",
                                 self.entry["traffic"] + ".json")
        limits = os.path.join(HERE, "limits", workload + ".json")
        self.limits = load_json(limits) if os.path.exists(limits) else {}
        for key, value in (overrides or {}).items():  # tests shrink cells
            _merge({"config": self.config["config"], "traffic": self.traffic,
                    "limits": self.limits}[key], value)
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t0 = t0
        self.setup_s = None
        self.summary = None
        self.per_layer = [m for m in manifest["per_layer"]
                          if workload in m.get("workloads", [workload])]

    @property
    def window_seconds(self) -> float:
        """The window's length to aim at: ``TRACE_SECONDS`` at the most
        when traced."""
        return min(self.seconds, TRACE_SECONDS) if self.trace \
            else self.seconds

    @property
    def repo_config(self) -> dict:
        """The repo config as the cell runs it: the configuration's
        ``config`` with the mix's ``model`` keys over it."""
        cfg = json.loads(json.dumps(self.config["config"]))
        cfg["model"].update(self.traffic.get("model", {}))
        return cfg

    def checks(self, readings: dict) -> dict:
        """``name -> (reading, limit)`` for each number the cell's limits
        file names (every reading, unlimited, where it has none yet)."""
        if not self.limits:
            return {k: (v, float("inf")) for k, v in readings.items()
                    if isinstance(v, float)}
        return {k: (readings[k], float(v)) for k, v in self.limits.items()}

    def setup_done(self) -> None:
        self.sync()
        self.setup_s = time.perf_counter() - self.t0

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def window(self):
        """The measured window. Traced (``--trace 1``), it runs under the
        profiler and is cut to ``TRACE_SECONDS``; ``w.seconds`` is its
        length to aim at. The driver calls ``w.close(units, images)``
        where the window ends (after its last unit is complete)."""
        w = _Window(self.window_seconds)
        prof = None
        if self.trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts, experimental_config=_all_threads())
            prof.__enter__()
        self.sync()
        w.start = time.perf_counter()
        w.start_ns = time.time_ns()
        try:
            yield w
        finally:
            if w.end is None:
                w.close(0, 0)
            if prof is not None:
                prof.__exit__(None, None, None)
                from bench_port import tracing
                # kineto stamps events in Unix nanoseconds, as time_ns
                self.summary = tracing.summarize(
                    prof.profiler.kineto_results.events(), w.start_ns,
                    w.end_ns)
        self.window_s = w.end - w.start
        self.units, self.images = w.units, w.images


def _all_threads():
    """The profiler's option to record every thread's spans, not the
    main thread's alone; ``None`` where this torch lacks it."""
    from torch._C._profiler import _ExperimentalConfig
    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


class _Window:
    def __init__(self, seconds: float):
        self.seconds = seconds
        self.start = self.end = None
        self.units = self.images = 0

    def close(self, units: int, images: int) -> None:
        self.end = time.perf_counter()
        self.end_ns = time.time_ns()
        self.units, self.images = units, images


def _merge(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v


def per_layer_metrics(cell: Cell, extra: dict) -> dict:
    """Each per-layer metric of the cell, read from the traced window's
    summary (with the driver's ``extra`` counts); a reader that finds
    nothing returns ``None`` and the metric is left out."""
    out = {}
    summary = dict(cell.summary or {}, **extra, units=cell.units,
                   images=cell.images)
    for m in cell.per_layer:
        reader = load_module(os.path.join(HERE, "metrics",
                                          m["name"] + ".py"))
        value = reader.read(summary)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
