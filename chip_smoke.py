#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA device and ``nvcc``; exits non-zero without them, and without
the rest of the repository beside it. Each phase prints one JSON line, and
any failure raises:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every kernel under ``ssd_tpu_torch/csrc`` built with nvcc;
3. nms: the suppression kernel against its plain PyTorch version on the
   card, at the serving shape (N=32, Q=1024, C=80, K=128, every problem
   live) and at the edge cases (K=100, K=512, all empty, an adversarial
   chain), with its time, the plain version's and the card's bound;
4. sanity: the trained sanity artifact (``ssd_tpu_torch/assets``) served by
   ``Predictor.from_npz``; f32 detections set-equal to the stored JAX ones,
   bf16 detections' share of the JAX bf16 ones;
5. flagship: ``configs/coco_mobilenet_640_flagship.json`` at full width
   (bf16, 640 px, 80 classes, seeded weights) serving 10 batches of 32
   through ``Predictor.predict``, a list of mixed-size images and a
   letterboxed request, with the NMS launches of that run counted; on one
   batch the kernel path and the plain ``batched_nms`` agree exactly;
6. the kernels line, then the card's ``nvidia-smi`` line, then the result.

Times are CUDA-event times after warm-up, or host times around work that
ends in a synchronise; they are from an unoptimised eager bring-up.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ssd_tpu_torch import _build
from ssd_tpu_torch.config import Config, NMSConfig
from ssd_tpu_torch.convert import load_npz_artifact
from ssd_tpu_torch.ops import box_utils, nms, nms_cuda
from ssd_tpu_torch.ops.ingest import pack_s2d
from ssd_tpu_torch.ops.postprocess import select_candidates_cells
from ssd_tpu_torch.predictor import Predictor

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, "configs", "coco_mobilenet_640_flagship.json")
ASSET = os.path.join(ROOT, "ssd_tpu_torch", "assets", "sanity_v1.npz")
DET_KEYS = ("boxes", "scores", "labels", "num_boxes")
DEVICE = torch.device("cuda")

# H100 SXM data sheet: HBM rate and f32 (non-tensor-core) peak.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
IOU_FLOPS = 12  # 4 min/max, 3 sub, 2 clamp, 1 mul, 1 add, 1 div
# Class-head bias of the seeded flagship: sigmoid(-2.5) = 0.076, above the
# 0.05 score threshold, so candidates of every class are live and NMS works.
FLAGSHIP_CLASS_BIAS = -2.5


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean CUDA-event milliseconds of ``fn()`` over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ NMS

def clustered_problem(rng, n: int, q: int, c: int, cluster: int = 16):
    """Boxes in dense overlapping clusters of ``cluster`` and tie-free
    scores: ``boxes (n, q, 4)``, ``scores (n, q, c)``, f32 numpy."""
    k = q // cluster
    centre = rng.uniform(0.1, 0.9, (n, k, 1, 2))
    size = rng.uniform(0.05, 0.3, (n, k, 1, 2))
    centre = centre + rng.normal(0.0, 0.02, (n, k, cluster, 2))
    size = size * rng.uniform(0.8, 1.2, (n, k, cluster, 2))
    boxes = np.concatenate([centre - size / 2, centre + size / 2], -1)
    boxes = np.clip(boxes, 0.0, 1.0).reshape(n, q, 4).astype(np.float32)
    scores = rng.permutation(n * q * c).astype(np.float32) / (n * q * c)
    return boxes, scores.reshape(n, q, c)


def chain_problem(n: int, q: int, c: int):
    """Boxes in a chain, each overlapping the next at IoU 0.25 and not the
    one after; scores fall along it."""
    x0 = 0.06 * np.arange(q) / (0.06 * q + 0.1)
    w = 0.1 / (0.06 * q + 0.1)
    one = np.stack([np.zeros(q), x0, np.full(q, 0.2), x0 + w], -1)
    boxes = np.broadcast_to(one, (n, q, 4)).astype(np.float32)
    s = np.linspace(0.9, 0.5, q)[None, :, None] - 1e-3 * np.arange(c)
    return boxes.copy(), np.broadcast_to(s, (n, q, c)).astype(np.float32)


def greedy_ious(top_boxes: torch.Tensor, valid: torch.Tensor,
                thr: float) -> int:
    """IoUs greedy NMS needs on these inputs: for each pivot still kept at
    its step, one per later candidate still alive."""
    k = top_boxes.shape[-2]
    over = box_utils.iou(top_boxes, top_boxes) > nms.f32(thr)
    over &= torch.ones(k, k, dtype=torch.bool,
                       device=over.device).triu(diagonal=1)
    keep = valid.clone()
    count = torch.zeros((), dtype=torch.int64, device=keep.device)
    for i in range(k):
        pivot = keep[..., i]
        count += (pivot[..., None] & keep[..., i + 1:]).sum()
        keep &= ~(over[..., i, :] & pivot[..., None])
    return int(count)


def check_nms_case(name: str, boxes_np, scores_np, cfg: NMSConfig,
                   timed: bool = False) -> dict:
    """Kernel vs plain on the card: kept masks equal, kept scores within
    1e-6, and whole-path detections equal."""
    boxes = torch.from_numpy(boxes_np).to(DEVICE)
    scores = torch.from_numpy(scores_np).to(DEVICE)
    top_scores, top_idx = nms.class_topk(scores, cfg)
    got = nms_cuda.suppress_cuda(boxes, top_idx, top_scores,
                                 cfg.iou_threshold)
    want = nms.suppress(boxes, top_idx, top_scores, cfg.iou_threshold)
    torch.cuda.synchronize()
    if not torch.equal(got > 0, want > 0):
        bad = int(((got > 0) != (want > 0)).sum())
        raise AssertionError(f"nms {name}: {bad} keep decisions differ")
    err = float((got - want).abs().max())
    if err > 1e-6:
        raise AssertionError(f"nms {name}: kept scores differ by {err}")
    a = nms_cuda.batched_nms_cuda(boxes, scores, cfg)
    b = nms.batched_nms(boxes, scores, cfg)
    assert torch.equal(a.num_boxes, b.num_boxes), name
    assert torch.equal(a.labels, b.labels), name
    assert float((a.scores - b.scores).abs().max()) <= 1e-6, name
    assert float((a.boxes - b.boxes).abs().max()) <= 1e-6, name

    n, c, k = top_idx.shape
    g = n * c
    live = int((top_scores[..., 0] > 0).sum())
    row = {"phase": "nms", "case": name, "N": n, "Q": boxes.shape[1],
           "C": c, "K": k, "G": g, "live_problems": live,
           "kept": int((got > 0).sum()), "max_abs_err": err,
           "num_boxes_equal": True}
    if timed:
        flat = top_idx.reshape(n, c * k).long()
        top_boxes = torch.gather(
            boxes, 1, flat[..., None].expand(n, c * k, 4)).reshape(n, c, k, 4)
        ious = greedy_ious(top_boxes, top_scores > 0, cfg.iou_threshold)
        nbytes = boxes.numel() * 4 + top_idx.numel() * 4 + 2 * got.numel() * 4
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ious * IOU_FLOPS / F32_FLOP_PER_S * 1e3
        row.update({
            "ms": cuda_ms(lambda: nms_cuda.suppress_cuda(
                boxes, top_idx, top_scores, cfg.iou_threshold), iters=200),
            "plain_ms": cuda_ms(lambda: nms.suppress(
                boxes, top_idx, top_scores, cfg.iou_threshold), iters=5),
            "bytes": nbytes, "ious": ious,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "library_note": "no single PyTorch call computes batched greedy "
                            "NMS, and the card has no package of finished "
                            "kernels"})
    emit(row)
    return row


def phase_nms() -> dict:
    rng = np.random.default_rng(0)
    serve = NMSConfig()  # flagship: K=128, iou 0.5, score 0.05
    boxes, scores = clustered_problem(rng, 32, 1024, 80)
    main = check_nms_case("serve_b32", boxes, scores, serve, timed=True)
    if main["live_problems"] != main["G"]:
        raise AssertionError("serving-shape case must have every problem live")
    check_nms_case("k100", boxes, scores,
                   dataclasses.replace(serve, pre_nms_top_k=100))
    b8, s8 = clustered_problem(rng, 8, 1024, 80)
    check_nms_case("k512", b8, s8,
                   dataclasses.replace(serve, pre_nms_top_k=512))
    empty = check_nms_case("all_empty", boxes, scores * 0.04, serve)
    if empty["kept"] or empty["live_problems"]:
        raise AssertionError("all-empty case kept a candidate")
    cb, cs = chain_problem(2, 128, 4)
    chain = check_nms_case("chain", cb, cs, dataclasses.replace(
        serve, iou_threshold=0.2, score_threshold=0.1))
    if chain["kept"] != 2 * 4 * 64:
        raise AssertionError(f"chain kept {chain['kept']}, want every other")
    return main


# ------------------------------------------------------------------ models

def set_match(got: dict, want: dict, score_tol: float = 1e-3) -> tuple[int, int]:
    """(matched, total) wanted detections under the golden rule: same label,
    score within ``score_tol`` (1e-3), box within 1e-2, each got detection
    used once."""
    matched = total = 0
    for i in range(len(want["num_boxes"])):
        nb_w, nb_g = int(want["num_boxes"][i]), int(got["num_boxes"][i])
        used = set()
        for j in range(nb_w):
            total += 1
            for q in range(nb_g):
                if (q not in used
                        and got["labels"][i, q] == want["labels"][i, j]
                        and abs(got["scores"][i, q]
                                - want["scores"][i, j]) < score_tol
                        and np.abs(got["boxes"][i, q]
                                   - want["boxes"][i, j]).max() < 1e-2):
                    used.add(q)
                    matched += 1
                    break
    return matched, total


def phase_sanity() -> None:
    nms_cuda.launches = 0
    with np.load(ASSET) as z:
        images = z["images"]
        jax_det = {t: {k: z[f"jax_{t}_{k}"] for k in DET_KEYS}
                   for t in ("f32", "bf16")}
    p16 = Predictor.from_npz(ASSET, device=DEVICE)
    cfg, state = load_npz_artifact(ASSET)
    p32 = Predictor(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32")), state, device=DEVICE)
    got32 = p32.predict(images)
    got16 = p16.predict(images)
    launches = nms_cuda.launches
    m32, t32 = set_match(got32, jax_det["f32"])
    m16, t16 = set_match(got16, jax_det["bf16"])
    # one bf16 step of a logit near -3 moves its score by ~1e-3, so bf16
    # detections are also matched with the score held to 1e-2
    m16_loose, _ = set_match(got16, jax_det["bf16"], score_tol=1e-2)
    nb_equal = bool((got32["num_boxes"] == jax_det["f32"]["num_boxes"]).all())
    emit({"phase": "sanity", "images": len(images), "nms_launches": launches,
          "f32_matched": m32, "f32_total": t32, "f32_num_boxes_equal": nb_equal,
          "bf16_matched": m16, "bf16_total": t16,
          "bf16_match_share": m16 / max(t16, 1),
          "bf16_match_share_score_1e-2": m16_loose / max(t16, 1)})
    if launches < 2:
        raise AssertionError("sanity phase did not run the NMS kernel")
    if m32 != t32 or not nb_equal:
        raise AssertionError(f"f32 detections differ from JAX: {m32}/{t32}")


def _check_output(out: dict, n: int, max_boxes: int) -> None:
    assert out["boxes"].shape == (n, max_boxes, 4), out["boxes"].shape
    assert out["scores"].shape == (n, max_boxes)
    assert out["labels"].shape == (n, max_boxes)
    assert out["num_boxes"].shape == (n,)
    assert np.isfinite(out["boxes"]).all() and np.isfinite(out["scores"]).all()
    assert (out["boxes"] >= 0).all() and (out["boxes"] <= 1).all()


def phase_flagship(power_line: str) -> int:
    cfg = Config.load(FLAGSHIP)
    assert cfg.model.compute_dtype == "bfloat16"
    pred = Predictor(cfg, None, device=DEVICE)  # weights seeded from 0
    with torch.no_grad():
        pred.detector.model.head.class_net.predict.bias.fill_(
            FLAGSHIP_CLASS_BIAS)
    rng = np.random.default_rng(1)
    h, w = cfg.image_hw()
    batches = [rng.integers(0, 256, (32, h, w, 3), dtype=np.uint8)
               for _ in range(3)]
    mixed = [rng.integers(0, 256, s + (3,), dtype=np.uint8)
             for s in ((480, 640), (333, 517), (700, 1000))]
    pred.warmup(32)
    pred.predict(mixed)
    torch.cuda.synchronize()

    # ---- the main path, counted
    torch.cuda.reset_peak_memory_stats()
    nms_cuda.launches = 0
    batch_ms = []
    for i in range(10):
        t0 = time.perf_counter()
        out = pred.predict(batches[i % len(batches)])
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        _check_output(out, 32, cfg.nms.max_boxes)
    out_mixed = pred.predict(mixed)
    _check_output(out_mixed, 3, cfg.nms.max_boxes)
    pred.preserve_aspect = True
    out_box = pred.predict(mixed[2])
    pred.preserve_aspect = False
    launches = nms_cuda.launches
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    assert out_box["boxes"].shape == (cfg.nms.max_boxes, 4)
    if launches != 12:
        raise AssertionError(f"{launches} NMS launches, want one per request")

    # ---- host side of one batch: the numpy pack and the copy to the card
    t0 = time.perf_counter()
    packed = pack_s2d(batches[0])
    pack_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feed = torch.from_numpy(packed).to(DEVICE)
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3

    # ---- kernel path vs plain batched_nms on one batch's raw maps
    det = pred.detector
    with torch.inference_mode():
        raw = det.model(feed)
        boxes, scores = select_candidates_cells(raw, det.anchors,
                                                cfg.num_classes, cfg.nms)
        a = nms_cuda.batched_nms_cuda(boxes, scores, cfg.nms)
        b = nms.batched_nms(boxes, scores, cfg.nms)
        top_scores, _ = nms.class_topk(scores, cfg.nms)
    assert torch.equal(a.num_boxes, b.num_boxes)
    assert torch.equal(a.labels, b.labels)
    assert float((a.scores - b.scores).abs().max()) <= 1e-6
    assert float((a.boxes - b.boxes).abs().max()) <= 1e-6
    live = int((top_scores[..., 0] > 0).sum())
    valid = int((top_scores > 0).sum())

    # ---- where one batch's device time goes (CUDA events, warm)
    with torch.inference_mode():
        fwd = cuda_ms(lambda: det.model(feed), iters=5)
        sel = cuda_ms(lambda: select_candidates_cells(
            raw, det.anchors, cfg.num_classes, cfg.nms), iters=5)
        post = cuda_ms(lambda: nms_cuda.batched_nms_cuda(
            boxes, scores, cfg.nms), iters=5)

    p50 = float(np.median(batch_ms))
    emit({"phase": "flagship", "config": os.path.relpath(FLAGSHIP, ROOT),
          "dtype": "bfloat16", "batch": 32, "image": [h, w],
          "anchors": cfg.num_anchors(), "weights": "seeded (seed 0)",
          "class_bias": FLAGSHIP_CLASS_BIAS,
          "live_problems": live, "problems": 32 * cfg.num_classes,
          "valid_candidates": valid, "num_boxes_mean":
              float(np.mean(out["num_boxes"])),
          "nms_launches": launches, "kernel_vs_plain_equal": True,
          "batch_ms": batch_ms, "p50_batch_ms": p50,
          "img_per_s": 32 / p50 * 1e3,
          "device_ms": {"model": fwd, "select": sel, "nms": post},
          "host_ms": {"pack_s2d": pack_ms, "to_device": h2d_ms},
          "peak_mem_gib": peak_gb,
          "note": "unoptimised eager bring-up reading on " + power_line})
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    power_line = nvidia_smi_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": power_line, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": built, "sources": _build.sources(),
          "ptxas": {k: [ln for ln in v.splitlines() if "ptxas info" in ln]
                    for k, v in _build.build_logs.items()}})

    main_nms = phase_nms()
    phase_sanity()
    launches = phase_flagship(power_line)

    emit({"kernels": [{
        "name": "nms", "route": "cuda", "source": "ssd_tpu_torch/csrc/nms.cu",
        "replaces": "ssd_tpu/ops/nms_pallas.py:78", "launches": launches,
        "max_abs_err": main_nms["max_abs_err"], "ms": main_nms["ms"],
        "plain_ms": main_nms["plain_ms"], "bound_ms": main_nms["bound_ms"],
        "bound_by": main_nms["bound_by"], "library_ms": None}]})
    print(power_line)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
