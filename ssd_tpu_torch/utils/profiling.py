"""Trace capture, and what a ``torch.profiler`` window shows: host spans,
CUDA runtime calls, waits for the card, copies and device time.

Capture (the port's ``ssd_tpu/utils/profiling.py``): ``start_trace(log_dir)``
and ``stop_trace()``, or the context manager ``trace(log_dir)``, record a
``torch.profiler`` window (CPU activity, and CUDA activity where a card is
present) and write its chrome trace to ``log_dir/trace.json``, which
``utils/trace_tools.py`` reads (as it reads ``train --profile N``'s
``workdir/profile/trace.json`` and ``bench_train --profile DIR``'s).
``annotate(name)`` is a named span in that trace (``record_function``).

The program's spans: a predict's ``predict.feed``, ``predict.copy``,
``predict.launch`` and ``predict.readback`` (``Predictor``), with
``predict.model``, ``predict.select`` and ``predict.nms`` inside the
launch (``Detector.predict``); a training step's ``train.feed``
(``DeviceFeed``, or a mesh step's upload), ``train.step`` and inside it
``train.forward``, ``train.targets``, ``train.loss``, ``train.backward``,
``train.reduce`` (under a mesh) and ``train.update``
(``train_step.make_train_step``), and the loop's ``train.log``; a pinned
staging buffer's wait ``staging.wait``; ``streaming.push`` and
``spatial.strip``.

``summarize`` reads the events of a finished ``torch.profiler.profile``
whose code marked its phases with ``record_function(prefix + name)``, such
as the ``train.*`` spans above. A wait for the card is a
``cudaStreamSynchronize``, ``cudaDeviceSynchronize`` or
``cudaEventSynchronize``; each is listed with the ops it ran under, so that
a caller can tell the metrics readback from a sync inside a step
(``chip_smoke.py`` reads a predict's ``predict.*`` spans the same way), and
a pinned staging buffer's wait for its last upload (``device.STAGING_WAIT``)
from both. Copies are counted by their kind on
the device: a host-to-device copy from pageable memory waits for the
stream before it starts.
"""

from __future__ import annotations

import collections
import contextlib
import os

import torch
from torch.profiler import record_function

from ssd_tpu_torch.device import STAGING_WAIT

TRACE_FILE = "trace.json"
_active: dict = {}  # the window start_trace opened: profiler, log_dir


def start_trace(log_dir: str) -> None:
    """Begins recording a window (see :func:`stop_trace`)."""
    if _active:
        raise RuntimeError("a trace is already being recorded")
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()  # the window starts with an idle card
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        *([torch.profiler.ProfilerActivity.CUDA] if cuda else [])])
    prof.__enter__()
    _active.update(prof=prof, log_dir=log_dir, cuda=cuda)


def stop_trace() -> str:
    """Ends the window (after the card's queued work) and writes its chrome
    trace; returns the file's path."""
    if not _active:
        raise RuntimeError("no trace is being recorded")
    prof, log_dir, cuda = _active.pop("prof"), _active.pop(
        "log_dir"), _active.pop("cuda")
    if cuda:
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str):
    """Records the enclosed steps into ``log_dir/trace.json``."""
    start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace()


def annotate(name: str):
    """A named span in the trace (host side; mirrored on the device
    timeline as an annotation)."""
    return record_function(name)

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def summarize(prof: torch.profiler.profile, prefix: str) -> dict:
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    spans = collections.Counter()
    span_calls = collections.Counter()
    runtime = collections.Counter()
    calls = collections.Counter()
    copies = collections.Counter()
    syncs = []
    device_ms = 0.0
    device_ops = 0
    for e in prof.events():
        ms = (e.time_range.end - e.time_range.start) / 1e3
        # a span is mirrored on the device timeline as an annotation: only
        # the host's event is its time
        if e.device_type == cpu and e.name.startswith(prefix):
            spans[e.name] += ms
            span_calls[e.name] += 1
        elif e.device_type == cpu and e.name.startswith("cuda"):
            runtime[e.name] += ms
            calls[e.name] += 1
            if e.name in SYNC_CALLS:
                chain, parent = [], e.cpu_parent
                while parent is not None and len(chain) < 12:
                    chain.append(parent.name)
                    parent = parent.cpu_parent
                syncs.append({"call": e.name, "ms": ms, "thread": e.thread,
                              "under": chain})
        elif e.device_type == cuda and not e.is_user_annotation:
            device_ms += ms
            device_ops += 1
            if e.name.startswith("Memcpy"):
                copies[e.name] += 1
    return {"host_ms": dict(spans), "span_calls": dict(span_calls),
            "cuda_runtime_ms": dict(runtime),
            "cuda_runtime_calls": dict(calls),
            "syncs": syncs, "copies": dict(copies),
            "device_busy_ms": device_ms, "device_ops": device_ops}


def syncs_under(summary: dict, spans: tuple[str, ...]) -> list[dict]:
    """The waits for the card that ran under any of ``spans``, other than
    the staging buffers' (``staging_waits``)."""
    return [s for s in summary["syncs"]
            if STAGING_WAIT not in s["under"]
            and any(name in s["under"] for name in spans)]


def staging_waits(summary: dict) -> list[dict]:
    """The pinned staging buffers' waits for their last upload."""
    return [s for s in summary["syncs"] if STAGING_WAIT in s["under"]]


def pageable_uploads(summary: dict) -> int:
    """Host-to-device copies from pageable memory in the window."""
    return sum(n for k, n in summary["copies"].items()
               if "HtoD" in k and "Pageable" in k)
