"""Pipelined batch serving through ``Predictor.predict_dispatch`` and
``predict_collect`` (the protocol of ``ssd_tpu_torch/tools/bench_serve``).

Set-up: the configuration with the mix's ``model`` keys (int8 with
``int8_neck`` or the config's bf16), seeded weights, and for int8 an
absmax calibration on one seeded batch (``ssd_tpu_torch.quant.calibrate``);
a pool of ``pool_batches`` seeded uint8 batches of ``batch`` scenes, each
its own content; two warm predicts of the one bucket the window uses.

Window: ``depth`` batches in flight, the pool cycled; a batch counts when
its detections have been collected, and the window closes at the first
collection after ``seconds``. ``serve_img_per_s`` is the images
collected over the window.

Check: every batch collected in the window, against the reference of its
pool batch (``judge.serve_gaps`` and ``judge.stage_gaps``): the reference
model in float32 for a bf16 cell, its 8-bit emulation on scales
calibrated anew from the same calibration batch for an int8 cell; and,
stage by stage, the reference's selection, NMS and class merge on the
program's own raw maps of the pool batch, which the window's detector
gives once more after the window.
"""

from __future__ import annotations

import collections
import gc
import hashlib
import time

import numpy as np
import torch

from bench_port import generator, judge, peaks
from bench_port.harness import per_layer_metrics
from bench_port.reference import detect
from bench_port.reference.model import Quant, flatten_levels, precise
from bench_port.weights import seeded_state

CALIBRATION_INDEX = 1 << 20  # the calibration batch's index in the seed


def build(cell, cfg_dict: dict):
    """The predictor of ``cfg_dict`` with the seeded weights, calibrated
    for int8; -> (predictor, state, calibration batch)."""
    from ssd_tpu_torch.config import Config
    from ssd_tpu_torch.predictor import Predictor
    from ssd_tpu_torch.quant import calibrate

    t = cell.traffic
    cfg = Config.from_dict(cfg_dict)
    state = seeded_state(cell.reference.param_shapes(cfg_dict), cell.seed,
                         cell.device, t["class_bias"])
    pred = Predictor(cfg, state, device=cell.device)
    calib = None
    if cfg.model.compute_dtype == "int8":
        calib = generator.scene_batch(cell.seed, CALIBRATION_INDEX,
                                    t.get("batch", 32), cfg.image_hw(),
                                    cfg.num_classes, t["scenes"],
                                    cell.device)["images"]
        calibrate(pred.detector, [calib])
    if "depth" in t:
        pred.staging.depth = max(pred.staging.depth, t["depth"] + 1)
    return pred, state, calib


def pool(cell, cfg_dict: dict) -> list:
    t = cell.traffic
    hw = (cfg_dict["image_size"],) * 2
    return [generator.scene_batch(cell.seed, i, t["batch"], hw,
                                cfg_dict["num_classes"], t["scenes"],
                                cell.device)["images"]
            for i in range(t["pool_batches"])]


def serve_window(cell, pred, batches: list) -> list:
    """The measured window -> ``[(pool index, detections)]`` collected in
    it (and the rest drained after it)."""
    depth = cell.traffic["depth"]
    inflight = collections.deque()
    done, nxt = [], 0
    with cell.window() as w:
        end = w.start + w.seconds
        while True:
            while len(inflight) < depth:
                j = nxt % len(batches)
                inflight.append((j, pred.predict_dispatch(batches[j])))
                nxt += 1
            j, handle = inflight.popleft()
            done.append((j, pred.predict_collect(handle)))
            if time.perf_counter() >= end:
                w.close(len(done), len(done) * len(batches[j]))
                break
    counted = len(done)
    while inflight:
        j, handle = inflight.popleft()
        done.append((j, pred.predict_collect(handle)))
    return done[:counted]


def program_stages(pred, batches: list) -> list:
    """The program's raw maps and candidates of each pool batch, from the
    detector the window drove, after the window: ``[(raw levels,
    candidates)]``. Its forward and selection are deterministic, so these
    are the maps the window's NMS took."""
    from ssd_tpu_torch.models.detector import select_from_levels
    det = pred.detector
    out = []
    with torch.inference_mode():
        for images in batches:
            raw = det.raw(images)
            out.append((raw, select_from_levels(raw, det.model, det.anchors,
                                                det.cfg)))
    return out


def flat_raw(raw: list, num_classes: int) -> torch.Tensor:
    """Per-level maps -> ``(N, A, C + 4)``: logits and box codes."""
    logits, deltas = flatten_levels(raw, num_classes)
    return torch.cat([logits.float(), deltas.float()], -1)


def reference(cell, cfg_dict: dict, state: dict, calib, bits):
    """The reference model on the cell's device: float32, or its
    ``bits``-wide integer emulation on scales calibrated anew from the
    calibration batch; -> ``outputs(images)`` -> (raw levels, per-anchor
    logits, decoded boxes, final detections)."""
    dev = cell.device
    model = cell.reference.Model(cfg_dict, state,
                                 Quant(bits) if bits else None)
    if bits:
        model.calibrate(torch.from_numpy(calib).to(dev))
    anchors = reference_anchors(cell, cfg_dict)

    @torch.no_grad()
    def outputs(images):
        raw = model(torch.from_numpy(images).to(dev))
        logits, deltas = flatten_levels(raw, cfg_dict["num_classes"])
        final = detect.hard_nms(*detect.select_cells(
            raw, anchors, cfg_dict["num_classes"], cfg_dict["nms"]),
            cfg_dict["nms"])
        return raw, logits, detect.decode(deltas, anchors), final

    return outputs


def reference_anchors(cell, cfg_dict: dict) -> torch.Tensor:
    return torch.from_numpy(detect.anchors(
        cfg_dict["image_size"], cfg_dict["anchors"])).to(cell.device)


def _digest(out: dict) -> bytes:
    h = hashlib.sha256()
    for k in ("boxes", "scores", "labels", "num_boxes"):
        h.update(np.ascontiguousarray(out[k]).tobytes())
    return h.digest()


def judge_pool(cell, cfg_dict: dict, outputs, batches: list, stages: list,
               served: dict, worst: dict | None = None) -> dict:
    """``served``: pool index -> the distinct detections served for it;
    ``stages``: the program's ``(raw levels, candidates)`` of each pool
    batch -> the worst of each gap over them."""
    gaps = dict.fromkeys(judge.GAPS, 0.0)
    nms = cfg_dict["nms"]
    c = cfg_dict["num_classes"]
    anchors = reference_anchors(cell, cfg_dict)
    for j, outs in sorted(served.items()):
        ref_raw, logits, boxes, final = outputs(batches[j])
        raw, cand = stages[j]
        ref_cand = detect.select_cells(raw, anchors, c, nms)
        ref_final = detect.hard_nms(*cand, nms)
        for out in outs:
            g = judge.serve_gaps(out, logits, boxes, final, worst=worst)
            g.update(judge.stage_gaps(out, flat_raw(raw, c),
                                      flat_raw(ref_raw, c), cand, ref_cand,
                                      ref_final))
            gaps = {k: max(gaps[k], g[k]) for k in gaps}
        del ref_raw, logits, boxes, final, ref_cand, ref_final
    return gaps


def judge_batches(cell, cfg_dict, state, calib, batches, collected,
                  stages, bits) -> tuple[dict, dict]:
    """Every collected batch against the reference of its pool batch ->
    (the worst of each gap, counts for the metrics)."""
    by_pool = collections.defaultdict(dict)
    for j, out in collected:
        by_pool[j].setdefault(_digest(out), out)
    nms = cfg_dict["nms"]
    outputs = reference(cell, cfg_dict, state, calib, bits)
    worst = judge_pool(cell, cfg_dict, outputs, batches, stages,
                       {j: list(o.values()) for j, o in by_pool.items()})
    extra = {}
    if cell.trace:
        n = cell.traffic["batch"]
        q = nms["num_candidates"]
        k = min(nms["pre_nms_top_k"], q)
        # the IoUs K1 needs on the candidates it took (the first batch's)
        extra["k1_bound_s"] = peaks.k1_bound_s(
            n, q, cfg_dict["num_classes"], k,
            detect.greedy_ious(*stages[0][1], nms))
    return worst, extra


def run(cell) -> dict:
    cfg_dict = cell.repo_config
    pred, state, calib = build(cell, cfg_dict)
    batches = pool(cell, cfg_dict)
    for b in batches[:2]:
        pred.predict(b)
    cell.setup_done()
    collected = serve_window(cell, pred, batches)
    memory = (torch.cuda.max_memory_allocated(cell.device)
              if cell.device.type == "cuda" else 0)
    stages = program_stages(pred, batches)
    del pred
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    precise()
    bits = 8 if cfg_dict["model"]["compute_dtype"] == "int8" else None
    worst, extra = judge_batches(cell, cfg_dict, state, calib, batches,
                                 collected, stages, bits)
    metrics = {}
    if cell.trace:
        dtype = cfg_dict["model"]["compute_dtype"]
        extra.update(flops_per_image=cell.config["flops_per_image"]["serve"],
                     peak_flops=peaks.DENSE_PEAK[dtype])
        metrics = per_layer_metrics(cell, extra)
    else:
        metrics["serve_img_per_s"] = {"value": cell.images / cell.window_s,
                                      "unit": "img/s"}
    checks = cell.checks(worst)
    return {"attempted": len(collected) * cell.traffic["batch"],
            "failed": 0, "checks": checks, "metrics": metrics,
            "memory_peak_bytes": memory}

