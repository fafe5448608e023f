"""Measure the streaming path (the port's ``ssd_tpu/tools/bench_streaming.py``;
the shipped ``configs/streaming_1024.json``).

    python -m ssd_tpu_torch.tools.bench_streaming \\
        [--config configs/streaming_1024.json] [--frames 300] [--depth 2] \\
        [--int8] [--set key=val ...] [--device cpu]

Feeds seeded uint8 frames (a pool of 8) through ``StreamingDetector`` with
weights seeded from 0, and prints one JSON line: the sustained fps and the
p50/p95 latency from push to fetch, from the detector's own accounting
(``stats``); then ``p50_device_ms`` and ``device_fps`` from a
``torch.profiler`` trace of 10 more pushes: the card's busy time
(``utils/profiling.summarize``) over the 10 frames. Like the JAX tool's
number of that name it is a mean per frame, not a median. On the CPU there
is no card and both are null. ``--int8`` serves with ``int8_neck``,
calibrated on two noise frames (``quant.calibrate``).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.quant import calibrate, int8_config
from ssd_tpu_torch.streaming import StreamingDetector
from ssd_tpu_torch.tools.bench_serve import apply_overrides
from ssd_tpu_torch.utils import profiling

PROFILED_PUSHES = 10


def profile_pushes(stream: StreamingDetector, pool: list,
                   pushes: int = PROFILED_PUSHES) -> dict:
    """``pushes`` frames of ``pool`` and the flush under ``torch.profiler``
    (the card's activity too, where the stream runs there): the
    ``profiling.summarize`` of the window (its spans the ``streaming.*``
    ones; each wait for the card lists the spans it ran under), with the
    results as ``"results"`` and the window's host-clock length, from the
    first push to the end of the flush, as ``"wall_ms"``."""
    cuda = stream.device.type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(stream.device)
    results = []
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(pushes):
            results.extend(stream.push(pool[i % len(pool)]))
        results.extend(stream.flush())
        wall_ms = (time.perf_counter() - t0) * 1e3
    summary = profiling.summarize(prof, "streaming.")
    if cuda and summary["device_busy_ms"] <= 0.0:
        raise RuntimeError("the profiler saw no device time on the card")
    summary["results"] = results
    summary["wall_ms"] = wall_ms
    return summary


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", default="configs/streaming_1024.json")
    p.add_argument("--frames", type=int, default=300)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--int8", action="store_true",
                   help="quantize the neck (calibrates on noise; scale "
                        "values do not affect speed)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                   help="config overrides, e.g. model.stem_schedule=dense4")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)

    with open(args.config) as f:
        cfg = Config.from_dict(apply_overrides(json.load(f), args.set))
    if args.int8:
        cfg = int8_config(cfg)
    s = StreamingDetector(cfg, None, depth=args.depth, device=args.device)
    ih, iw = cfg.image_hw()
    rng = np.random.default_rng(0)
    if args.int8:
        noise = rng.integers(0, 255, (2, ih, iw, 3)).astype(np.uint8)
        calibrate(s.detector, [noise])
    s.warmup()

    # a small pool of seeded frames, each push a fresh host array's worth
    pool = [rng.integers(0, 255, (ih, iw, 3)).astype(np.uint8)
            for _ in range(8)]
    fetched = 0
    for i in range(args.frames):
        for _ in s.push(pool[i % len(pool)]):
            fetched += 1
    for _ in s.flush():
        fetched += 1
    if fetched != args.frames:
        raise RuntimeError(f"fetched {fetched} of {args.frames} frames")

    st = s.stats()
    out = {"resolution": f"{ih}x{iw}", "depth": args.depth,
           "frames": args.frames, "fps": st.get("fps", 0.0),
           "p50_latency_ms": st["p50_latency_s"] * 1e3,
           "p95_latency_ms": st["p95_latency_s"] * 1e3,
           "compute_dtype": cfg.model.compute_dtype,
           "device": (torch.cuda.get_device_name(s.device)
                      if s.device.type == "cuda" else "cpu")}
    summary = profile_pushes(s, pool)
    if s.device.type == "cuda":
        dev_ms = summary["device_busy_ms"] / PROFILED_PUSHES
        out["p50_device_ms"] = dev_ms
        out["device_fps"] = 1e3 / dev_ms
    else:  # no card: no device time
        out["p50_device_ms"] = out["device_fps"] = None
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
