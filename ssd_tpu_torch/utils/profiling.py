"""What a ``torch.profiler`` window shows: host spans, CUDA runtime calls,
waits for the card, copies and device time.

``summarize`` reads the events of a finished ``torch.profiler.profile``
whose code marked its phases with ``record_function(prefix + name)`` (the
training loop's ``train.feed``, ``train.step``, ``train.log``). A wait for
the card is a ``cudaStreamSynchronize``, ``cudaDeviceSynchronize`` or
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

import torch

from ssd_tpu_torch.device import STAGING_WAIT

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
