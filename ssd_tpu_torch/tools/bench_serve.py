"""Serving benchmark for a config: pipelined images/s on one device (the
port's ``ssd_tpu/tools/bench_serve.py``).

Builds a ``Predictor`` from a config with seeded weights, queues ``--iters``
seeded uint8 batches through ``predict_dispatch`` (the whole host path:
the native pack, the pinned staging copy, the model, postprocess with the
NMS kernel, the asynchronous readback), collects once, and reports the
sustained images/s and the p50/p90/p99 of the per-batch times. On the card
a batch's time is the interval between the events that end two
consecutive batches' readbacks (the first from an event before the
window); on the CPU, where dispatch runs the batch, the host time of each
dispatch. ``--dtype int8`` serves the config in int8 with ``int8_neck``,
calibrated (absmax) on one seeded batch of 8.

    python -m ssd_tpu_torch.tools.bench_serve \\
        --config configs/coco_mobilenet_640_flagship.json [--batch 32] \\
        [--iters 50] [--warmup 3] [--set nms.pre_nms_top_k=64 ...] \\
        [--dtype int8] [--profile DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.predictor import Predictor
from ssd_tpu_torch.quant import calibrate, int8_config

CALIBRATION_SEED = 8
IMAGE_SEED = 1


def apply_overrides(d: dict, overrides: list[str]) -> dict:
    """``KEY.PATH=VALUE`` overrides into a config dict (values parsed as
    JSON where they parse)."""
    for ov in overrides:
        key, _, val = ov.partition("=")
        node = d
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        try:
            node[parts[-1]] = json.loads(val)
        except json.JSONDecodeError:
            node[parts[-1]] = val
    return d


def calibrate_seeded(pred: Predictor) -> float:
    """Calibrates an int8 predictor (absmax) on one seeded uint8 batch of 8
    at its image size; returns the seconds it took."""
    h, w = pred.cfg.image_hw()
    batch = np.random.default_rng(CALIBRATION_SEED).integers(
        0, 256, (8, h, w, 3), dtype=np.uint8)
    sync(pred.device)
    t0 = time.perf_counter()
    calibrate(pred.detector, [batch])
    sync(pred.device)
    return time.perf_counter() - t0


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def percentiles(values: list[float]) -> dict:
    v = np.asarray(values, np.float64)
    return {f"p{q}": float(np.percentile(v, q)) for q in (50, 90, 99)}


def seeded_batches(cfg: Config, batch: int, count: int = 3) -> list:
    rng = np.random.default_rng(IMAGE_SEED)
    return [rng.integers(0, 256, (batch, *cfg.image_hw(), 3), dtype=np.uint8)
            for _ in range(count)]


def run(pred: Predictor, batches: list, iters: int, warmup: int = 3,
        profile: str = "") -> dict:
    """The protocol: ``warmup`` predicts, then ``iters`` batches (cycling
    through ``batches``) queued through ``predict_dispatch`` and collected
    once. ``profile``: a directory for a ``torch.profiler`` trace of the
    timed window."""
    cuda = pred.device.type == "cuda"
    for i in range(warmup):
        pred.predict(batches[i % len(batches)])
    sync(pred.device)
    prof = None
    if profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    marks, handles, host_ms = [], [], []
    if cuda:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[0].record()
    t0 = time.perf_counter()
    for i in range(iters):
        t = time.perf_counter()
        handles.append(pred.predict_dispatch(batches[i % len(batches)]))
        host_ms.append((time.perf_counter() - t) * 1e3)
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
    outs = [pred.predict_collect(h) for h in handles]
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
        os.makedirs(profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile, "trace.json"))
    n = len(batches[0])
    if any(len(o["num_boxes"]) != n for o in outs):
        raise AssertionError("a collected batch lost rows")
    batch_ms = ([a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
                if cuda else host_ms)
    return {"batch": n, "iters": iters, "wall_s": wall,
            "img_per_s": n * iters / wall,
            "batch_ms": percentiles(batch_ms),
            "batch_ms_mean": float(np.mean(batch_ms)),
            "batch_ms_timing": "interval between readback events" if cuda
            else "host time of each dispatch",
            "dispatch_host_ms": percentiles(host_ms),
            "device": (torch.cuda.get_device_name(pred.device) if cuda
                       else "cpu"),
            **({"profile": os.path.join(profile, "trace.json")}
               if profile else {})}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", default="configs/coco_mobilenet_640.json")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    p.add_argument("--dtype", default=None,
                   choices=("bfloat16", "float32", "int8"),
                   help="compute dtype (default: the config's); int8 serves "
                        "with int8_neck, calibrated on a seeded batch")
    p.add_argument("--profile", default="", metavar="DIR",
                   help="write a torch.profiler trace of the timed window")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)

    with open(args.config) as f:
        cfg = Config.from_dict(apply_overrides(json.load(f), args.set),
                               strict=False)
    if args.dtype == "int8":
        cfg = int8_config(cfg)
    elif args.dtype:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype=args.dtype))
    t0 = time.perf_counter()
    pred = Predictor(cfg, None, device=args.device)  # weights seeded from 0
    calibration_s = calibrate_seeded(pred) if args.dtype == "int8" else None
    setup_s = time.perf_counter() - t0
    result = run(pred, seeded_batches(cfg, args.batch), args.iters,
                 args.warmup, args.profile)
    result = {"config": args.config, "image_size": cfg.image_size,
              "dtype": cfg.model.compute_dtype,
              "feed": "packed s8" if pred._packed else "raw uint8",
              "setup_s": setup_s, "calibration_s": calibration_s, **result}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
