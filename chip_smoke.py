#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA device and ``nvcc``; exits non-zero without them, and without
the rest of the repository beside it. Each phase prints one JSON line, and
any failure raises:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every kernel under ``ssd_tpu_torch/csrc`` built with nvcc;
3. nms: the suppression kernel against its plain PyTorch version on the
   card, on every case of ``ssd_tpu_torch/tools/kernel_cases.py``: the
   serving shape (N=32, Q=1024, C=80, K=128, every problem live) and the
   edge cases (K = 1, 32, 33, 100, 512 and the largest K the card admits,
   all empty, an adversarial chain, identical boxes, an IoU exactly at the
   threshold, thresholds of 0, -0.5 and 1), with its time, the plain
   version's and the card's bound;
4. sanity: the trained sanity artifact (``ssd_tpu_torch/assets``) served by
   ``Predictor.from_npz``; f32 detections set-equal to the stored JAX ones,
   bf16 detections' share of the JAX bf16 ones;
5. flagship: ``configs/coco_mobilenet_640_flagship.json`` at full width
   (bf16, 640 px, 80 classes, seeded weights) serving 10 batches of 32
   through ``Predictor.predict``, a list of mixed-size images and a
   letterboxed request, with the NMS launches of that run counted; on one
   batch the kernel path and the plain ``batched_nms`` agree exactly;
   reference_serve: the same for ``configs/coco_mobilenet_640.json`` (the
   reference MobileNet-v1 schedule, stem at stride 2 then ds1 and ds2) on
   the raw uint8 feed;
   reference_golden: ``ssd_tpu_torch/assets/golden_cells_v1.npz`` (the
   JAX package's ``tests/goldens/predict_cells_v1.npz`` with its weights)
   served in f32: raw slices at the golden bars (atol 2e-4, rtol 2e-3) and
   detections set-equal to JAX's under the golden rule;
   fused_early: the fused ds1+ds2 kernel, driven through its entry point
   (``ssd_tpu_torch.tools.bench_fused_early.run``) on the stem output of
   the served reference model (x1.0) on a 640 px batch of 32, with that
   model's ds1/ds2 batch norm randomized so the fold is exercised, its
   launches counted; then against its plain version at that shape and at
   the edge cases (one image, 16 x 16, 48 x 80, C1 of 8 and 16, saturated
   relu6): within atol 0.08, rtol 0.05 and at least 95% bit-equal, overall
   and on the first and last rows and columns, with the largest bf16 ulps
   and absolute error printed; against the model's own ds1+ds2 modules at
   the same bars; with its time, the plain version's, the modules' and the
   card's bound (depthwise at the f32 peak, pointwise at the bf16
   tensor-core peak);
6. match: the anchor-matching kernel against its plain PyTorch version on
   the card, on every case of ``ssd_tpu_torch/tools/kernel_cases.py``: the
   flagship training shape (N=64, A=76 725, M=100, crowded 640 px scenes
   of 80 classes) and the edge cases (images without gts, duplicate gts,
   gts that overlap no anchor, M=1, M=13, no force-match, an anchor
   repeated across blocks, gts on a run of anchors' bound, gts partly
   outside [0, 1]): all three outputs and the matches equal, with its
   time, the share of pairs its cull skips (counted by the kernel), the
   plain version's time and the card's bound;
7. train_sanity: ten f32 steps of the sanity task from JAX's seed-0 state
   (``ssd_tpu_torch/assets/train_ref_v1.npz``) against JAX's per-step
   metrics: num_positives equal at every step, step 0's loss within 1e-4
   and grad_norm within 2e-3, every loss within 1e-2 (all relative);
8. train_flagship: ``train()`` on the flagship config at full width and
   depth (bf16, 640 px, 80 classes, batch 64, its own optimizer recipe,
   seeded weights) over crowded 640 px batches: 3 warm-up and 10 timed
   steps, with the matching launches of that run counted, the losses
   finite, one batch's kernel matches equal to the plain ones, and the
   exported ``.npz`` served by ``Predictor.from_npz``;
9. the kernels line, then the card's ``nvidia-smi`` line, then the result.

Times are CUDA-event times after warm-up, or host times around work that
ends in a synchronise; they are from an unoptimised eager bring-up. K1's,
K2's and K3's ``ms`` is device time by CUDA-graph replay, and ``call_ms`` the
time of back-to-back eager calls of the wrapper, its host work included
(``ssd_tpu_torch/tools/bench_kernels.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ssd_tpu_torch import _build
from ssd_tpu_torch.config import Config, MatcherConfig, NMSConfig
from ssd_tpu_torch.convert import load_npz_artifact
from ssd_tpu_torch.data import synthetic
from ssd_tpu_torch.models.detector import Detector, normalize_images
from ssd_tpu_torch.models.fpn import flatten_levels
from ssd_tpu_torch.ops import (box_utils, fused_early, fused_early_cuda,
                               losses, matching, matching_cuda, nms, nms_cuda)
from ssd_tpu_torch.ops.anchors import generate_anchors
from ssd_tpu_torch.ops.postprocess import select_candidates_cells
from ssd_tpu_torch.ops.targets import create_targets
from ssd_tpu_torch.predictor import Predictor
from ssd_tpu_torch.tools import bench_fused_early, kernel_cases
from ssd_tpu_torch.tools.bench_fused_early import cuda_ms, randomize_early_bn
from ssd_tpu_torch.tools.bench_kernels import kernel_ms
from ssd_tpu_torch.train import EXPORT_NAME, train
from ssd_tpu_torch.train_step import (Optimizer, create_train_state,
                                      make_train_step)

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, "configs", "coco_mobilenet_640_flagship.json")
REFERENCE = os.path.join(ROOT, "configs", "coco_mobilenet_640.json")
ASSET = os.path.join(ROOT, "ssd_tpu_torch", "assets", "sanity_v1.npz")
GOLDEN = os.path.join(ROOT, "ssd_tpu_torch", "assets", "golden_cells_v1.npz")
TRAIN_REF = os.path.join(ROOT, "ssd_tpu_torch", "assets", "train_ref_v1.npz")
DET_KEYS = ("boxes", "scores", "labels", "num_boxes")
DEVICE = torch.device("cuda")

# H100 SXM data sheet: HBM rate, f32 (non-tensor-core) peak and the dense
# bf16 tensor-core peak.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_TENSOR_FLOP_PER_S = 989e12
IOU_FLOPS = 12  # 4 min/max, 3 sub, 2 clamp, 1 mul, 1 add, 1 div
# matching: the IoU, the union's floor, and the compare into each maximum
MATCH_FLOPS = 13
# the flagship training shape: data.max_gt_boxes and crowded scenes
MATCH_M = 100
CROWDED_SEED = 0
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


# ------------------------------------------------------------------ NMS

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


def check_nms_case(case: kernel_cases.NMSCase, name: str,
                   timed: bool = False) -> dict:
    """Kernel vs plain on the card: kept masks equal, kept scores within
    1e-6, whole-path detections equal, and the kept count the case fixes."""
    cfg = NMSConfig(**case.cfg)
    boxes = torch.from_numpy(case.boxes).to(DEVICE)
    scores = torch.from_numpy(case.scores).to(DEVICE)
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
    if case.kept is not None and row["kept"] != case.kept:
        raise AssertionError(f"nms {name}: kept {row['kept']}, want "
                             f"{case.kept}")
    if timed:
        flat = top_idx.reshape(n, c * k).long()
        top_boxes = torch.gather(
            boxes, 1, flat[..., None].expand(n, c * k, 4)).reshape(n, c, k, 4)
        ious = greedy_ious(top_boxes, top_scores > 0, cfg.iou_threshold)
        nbytes = boxes.numel() * 4 + top_idx.numel() * 4 + 2 * got.numel() * 4
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ious * IOU_FLOPS / F32_FLOP_PER_S * 1e3
        row.update(kernel_ms(lambda: nms_cuda.suppress_cuda(
            boxes, top_idx, top_scores, cfg.iou_threshold)))
        row.update({
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
    """Every NMS case; the serving one (``serve_b32``) timed and returned."""
    main = None
    for case in kernel_cases.nms_cases(32, 1024, 80,
                                       max_k=nms_cuda._max_k(DEVICE)):
        if case.name == "serve":
            main = check_nms_case(case, "serve_b32", timed=True)
            if main["live_problems"] != main["G"]:
                raise AssertionError(
                    "serving-shape case must have every problem live")
        else:
            check_nms_case(case, case.name)
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


def phase_serve(phase: str, config: str, power_line: str) -> int:
    """A full-width bf16 config served through ``Predictor.predict``: 10
    batches of 32, a mixed-size list and a letterboxed request, with the NMS
    launches of that run counted; returns them."""
    cfg = Config.load(config)
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

    # ---- host side of one batch: the feed (the dense4 pack, or the raw
    # batch as it is) and the copy to the card
    t0 = time.perf_counter()
    host_feed = pred._feed(batches[0])
    feed_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feed = torch.from_numpy(host_feed).to(DEVICE)
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
    emit({"phase": phase, "config": os.path.relpath(config, ROOT),
          "stem_schedule": cfg.model.stem_schedule,
          "feed": "packed s8" if pred._packed else "raw uint8",
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
          "host_ms": {"feed": feed_ms, "to_device": h2d_ms},
          "peak_mem_gib": peak_gb,
          "note": "unoptimised eager bring-up reading on " + power_line})
    return launches


def phase_reference_golden() -> None:
    """The JAX package's cells golden served in f32 on the card."""
    cfg, state = load_npz_artifact(GOLDEN)
    with np.load(GOLDEN) as z:
        images = z["images"]
        want = {k[len("jax_"):]: z[k] for k in z.files if k.startswith("jax_")}
    assert cfg.model.stem_schedule == "reference"
    assert cfg.model.compute_dtype == "float32"
    det = Detector(cfg, state, device=DEVICE)
    norm = torch.from_numpy((images.astype(np.float32) - 127.5) / 64.0)
    with torch.inference_mode():
        logits, deltas = flatten_levels(
            det.model(norm.to(DEVICE), raw_input=False), cfg.num_classes)
    got = {"logits_slice": logits[:, :64], "deltas_slice": deltas[:, :64],
           "anchors_head": det.anchors[:64]}
    errs = {}
    for k, g in got.items():
        g = g.float().cpu().numpy()
        errs[k] = float(np.abs(g - want[k]).max())
        if not np.allclose(g, want[k], atol=2e-4, rtol=2e-3):
            raise AssertionError(f"golden {k} off by {errs[k]}")
    out = det.predict(images)
    det_got = {k: getattr(out, k).cpu().numpy() for k in DET_KEYS}
    matched, total = set_match(det_got, want)
    nb_equal = bool((det_got["num_boxes"] == want["num_boxes"]).all())
    emit({"phase": "reference_golden", "images": len(images),
          "config": "tests/test_golden.py CFG, select=cells (f32)",
          "max_abs_err": errs, "num_boxes": det_got["num_boxes"].tolist(),
          "num_boxes_equal": nb_equal, "matched": matched, "total": total})
    if matched != total or not nb_equal or total == 0:
        raise AssertionError(f"golden detections differ: {matched}/{total}")


# ------------------------------------------------------------------ fused early

EARLY_BARS = dict(atol=0.08, rtol=0.05)  # tests/test_fused_early.py's
EARLY_BIT_EQUAL = 0.95  # least share of K3's outputs equal to the plain's


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in units of the bf16 spacing at the larger
    magnitude of the two (2^(floor(log2 m) - 7)); equal values count 0."""
    g, w = got.double(), want.double()
    mag = torch.maximum(g.abs(), w.abs())
    ulp = torch.exp2(torch.floor(torch.log2(torch.where(
        mag > 0, mag, torch.ones_like(mag)))) - 7)
    diff = (g - w).abs()
    return float(torch.where(diff > 0, diff / ulp, torch.zeros_like(diff))
                 .max())


def _borders(t: torch.Tensor):
    """The first and last rows and columns of an NCHW tensor (rows are dim
    2, columns dim 3)."""
    return [t.select(dim, i) for dim in (2, 3) for i in (0, -1)]


def _close(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    """The JAX kernel test's bars, overall and on the borders."""
    g, w = got.float(), want.float()
    for gp, wp in zip([g] + _borders(g), [w] + _borders(w)):
        if not torch.allclose(gp, wp, **EARLY_BARS):
            raise AssertionError(
                f"{what}: {float((gp - wp).abs().max())} off")


def hold_to_plain(got: torch.Tensor, want: torch.Tensor, name) -> dict:
    """K3 against its plain version on the card: within the JAX bars, and
    at least ``EARLY_BIT_EQUAL`` of the elements bit-equal, overall and on
    the borders (the tensor cores sum pw1's and pw2's exact products in
    their own order, so an f32 sum, and rarely a bf16 output, differs)."""
    _close(got, want, f"fused_early {name} vs plain")
    equal = float((got == want).float().mean())
    border_equal = min(float((g == w).float().mean())
                       for g, w in zip(_borders(got), _borders(want)))
    if min(equal, border_equal) < EARLY_BIT_EQUAL:
        raise AssertionError(f"fused_early {name}: bit-equal share {equal}, "
                             f"{border_equal} on the borders")
    return {"max_ulps": bf16_ulps(got, want), "bit_equal_share": equal,
            "bit_equal_share_borders": border_equal,
            "max_abs_err": float((got.float() - want.float()).abs().max())}


def check_early_case(name: str, backbone, x: torch.Tensor,
                     modules: bool = True, extra: dict | None = None) -> dict:
    """Kernel vs plain on the card (``hold_to_plain``), and vs the model's
    ds1+ds2 modules at the JAX kernel test's bars; the row, with ``extra``
    merged in, is printed and returned."""
    folded = fused_early.fold_early_params(backbone)
    with torch.inference_mode():
        got = fused_early_cuda.fused_ds1_ds2_cuda(x, folded)
        want = fused_early.fused_ds1_ds2_plain(x, folded)
        ref = bench_fused_early.unfused(backbone, x) if modules else None
    torch.cuda.synchronize()
    if got.shape != want.shape or not got.is_contiguous(
            memory_format=torch.channels_last):
        raise AssertionError(f"fused_early {name}: shape or layout")
    row = {"phase": "fused_early", "case": name, "shape_in": list(x.shape),
           "shape_out": list(got.shape), **hold_to_plain(got, want, name),
           "saturated_share": float((got == 6).float().mean()),
           "zero_share": float((got == 0).float().mean())}
    if modules:
        _close(got, ref, f"fused_early {name} vs modules")
        row["max_abs_diff_modules"] = float(
            (got.float() - ref.float()).abs().max())
    row.update(extra or {})
    emit(row)
    return row


def early_bound(x: torch.Tensor, folded: dict) -> dict:
    """The least time of the fused function on these inputs: each input
    and weight byte read once and the output written once, over the HBM
    rate; the depthwise multiply-adds (two operations each) over the f32
    peak plus the pointwise ones over the bf16 tensor-core peak, each of
    those two bf16 products (the weight's hi and lo terms). Also
    ``bound_f32_ms``, every multiply-add once at the f32 peak (the bound of
    the earlier all-f32 design, kept so its times stay comparable)."""
    n, c1, h, w = x.shape
    c2, c3 = folded["pw1_k"].shape[1], folded["pw2_k"].shape[1]
    ho, wo = h // 2, w // 2
    nbytes = (x.numel() * 2 + n * c3 * ho * wo * 2
              + sum(t.numel() * 4 for t in folded.values()))
    dw_macs = n * 9 * (h * w * c1 + ho * wo * c2)
    pw_macs = n * (h * w * c1 * c2 + ho * wo * c2 * c3)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_dw = 2 * dw_macs / F32_FLOP_PER_S * 1e3
    t_pw = 2 * 2 * pw_macs / BF16_TENSOR_FLOP_PER_S * 1e3
    t_ops = t_dw + t_pw
    t_f32 = max(t_bytes, 2 * (dw_macs + pw_macs) / F32_FLOP_PER_S * 1e3)
    return {"bytes": nbytes, "macs": dw_macs + pw_macs,
            "depthwise_macs": dw_macs, "pointwise_macs": pw_macs,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
            "bound_depthwise_f32_ms": t_dw,
            "bound_pointwise_bf16_ms": t_pw, "bound_f32_ms": t_f32}


def phase_fused_early(power_line: str) -> tuple[dict, int]:
    """K3 through its entry point on the served model's stem output, then
    against its plain version and the modules. Returns (row, launches)."""
    cfg = Config.load(REFERENCE)
    det = Detector(cfg, device=DEVICE)  # the served model, seeded from 0
    backbone = det.model.backbone
    randomize_early_bn(backbone, seed=3)
    images = np.random.default_rng(1).integers(
        0, 256, (32, *cfg.image_hw(), 3), dtype=np.uint8)
    with torch.inference_mode():
        x = backbone.stem_output(
            normalize_images(torch.from_numpy(images).to(DEVICE)),
            torch.bfloat16)
    assert x.is_contiguous(memory_format=torch.channels_last), "stem layout"

    # ---- the main path: the entry point, its launches counted
    fused_early_cuda.launches = 0
    bench = bench_fused_early.run(backbone, x, iters=20)
    launches = fused_early_cuda.launches
    if launches < 1:
        raise AssertionError("the entry point did not launch the kernel")

    folded = fused_early.fold_early_params(backbone)
    with torch.inference_mode():
        plain_ms = cuda_ms(lambda: fused_early.fused_ds1_ds2_plain(
            x, folded), iters=2, warmup=1)
        timed = kernel_ms(lambda: fused_early_cuda.fused_ds1_ds2_cuda(
            x, folded))
    main = check_early_case("served_b32", backbone, x, extra={
        "launches_entry_point": launches, **timed,
        "entry_point_ms": bench["fused_ms"],
        "unfused_ms": bench["unfused_ms"], "plain_ms": plain_ms,
        "entry_point_max_abs_diff": bench["max_abs_diff"],
        **early_bound(x, folded), "library_ms": None,
        "library_note": "no single PyTorch call computes the fused four "
                        "convs; unfused_ms is the model's own modules "
                        "(cuDNN, bf16, each conv rounded)",
        "note": "unoptimised bring-up reading on " + power_line})
    del x, det, backbone

    # ---- edge cases: kernel vs plain, and vs the modules
    rng = np.random.default_rng(4)

    def case(name, width, n, h, w, scale=1.5, gain=1.0):
        bb = bench_fused_early.reference_backbone(width, seed=5)
        randomize_early_bn(bb, seed=6, gain=gain)
        c1 = bb.ds1.depthwise.conv.weight.shape[0]
        xs = rng.normal(0.0, scale, (n, h, w, c1)).astype(np.float32)
        xe = torch.from_numpy(xs).to(DEVICE).to(torch.bfloat16).permute(
            0, 3, 1, 2)
        return check_early_case(name, bb, xe, modules=gain == 1.0)

    case("n1", 1.0, 1, 64, 64)
    case("16x16", 1.0, 2, 16, 16)
    case("48x80", 1.0, 2, 48, 80)
    case("c1_8", 0.25, 4, 40, 56)
    case("c1_16", 0.5, 4, 40, 56)
    sat = case("saturated", 1.0, 2, 48, 48, scale=100.0, gain=8.0)
    if sat["saturated_share"] < 0.01:
        raise AssertionError("saturated case did not saturate relu6")
    torch.cuda.empty_cache()
    return main, launches


# ------------------------------------------------------------------ matching

def _plain_core(anchors, gt, num, chunk: int = 16):
    """The plain version, a slice of images at a time: at N=64 one (N, A,
    M) f32 temporary is 2 GB."""
    parts = [matching.match_core(anchors, gt[i:i + chunk], num[i:i + chunk])
             for i in range(0, gt.shape[0], chunk)]
    return tuple(torch.cat([p[j] for p in parts]) for j in range(3))


def check_match_case(case: kernel_cases.MatchCase, name: str,
                     cfg: MatcherConfig, timed: bool = False) -> dict:
    """Kernel vs plain on the card: best_gt, best_iou, best_anchor and the
    matches equal."""
    cfg = dataclasses.replace(cfg, force_match_for_each_gt=case.force_match)
    anchors = torch.from_numpy(case.anchors).to(DEVICE)
    gt = torch.from_numpy(case.gt).to(DEVICE)
    num = torch.from_numpy(case.num).to(DEVICE, torch.int32)
    got = matching_cuda.match_core_cuda(anchors, gt, num)
    want = _plain_core(anchors, gt, num)
    torch.cuda.synchronize()
    for what, g, w in zip(("best_gt", "best_iou", "best_anchor"), got, want):
        if not torch.equal(g, w):
            bad = int((g != w).sum())
            raise AssertionError(f"match {name}: {bad} {what} differ")
    err = float((got[1] - want[1]).abs().max())
    m_kernel = matching_cuda.match_anchors(anchors, gt, num, cfg)
    m_plain = matching.finish_matches(*want, num, cfg)
    if not torch.equal(m_kernel, m_plain):
        raise AssertionError(f"match {name}: matches differ")
    n, m = gt.shape[:2]
    a = anchors.shape[0]
    nb = num.clamp(0, m)
    row = {"phase": "match", "case": name, "N": n, "A": a, "M": m,
           "gts": int(nb.sum()), "images_without_gts": int((nb == 0).sum()),
           "force_match": cfg.force_match_for_each_gt,
           "positives": int((m_kernel >= 0).sum()),
           "ignored": int((m_kernel == -2).sum()),
           "max_abs_err": err, "equal": True}
    if timed:
        nbytes = (a * 16 + n * m * 16 + n * 4  # anchors, gts, num_boxes
                  + n * a * 8 + n * m * 4)  # best_gt + best_iou, best_anchor
        ious = int(nb.sum()) * a
        listed = matching_cuda.listed_pairs(anchors, gt, num)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ious * MATCH_FLOPS / F32_FLOP_PER_S * 1e3
        row.update(kernel_ms(lambda: matching_cuda.match_core_cuda(
            anchors, gt, num)))
        row.update({
            "plain_ms": cuda_ms(lambda: matching.match_core(anchors, gt, num),
                                iters=3, warmup=1),
            "bytes": nbytes, "ious": ious, "pairs_after_cull": listed,
            "cull_share": 1.0 - listed / max(ious, 1),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
            "library_ms": None,
            "library_note": "no single PyTorch call computes both argmaxes "
                            "from one IoU pass"})
    emit(row)
    return row


def phase_match() -> dict:
    """Every matching case; the flagship batch (``flagship_b64``) timed and
    returned."""
    cfg = Config.load(FLAGSHIP)
    anchors = generate_anchors(cfg.image_size, cfg.anchors)
    b = synthetic.crowded_batch(0, CROWDED_SEED, cfg.train.batch_size,
                                cfg.image_hw()[0], cfg.num_classes, MATCH_M)
    main = None
    for case in kernel_cases.match_cases(anchors, b["boxes"], b["num_boxes"]):
        if case.name == "crowded":
            main = check_match_case(case, "flagship_b64", cfg.matcher,
                                    timed=True)
        else:
            check_match_case(case, case.name, cfg.matcher)
    return main


# ------------------------------------------------------------------ training

def phase_train_sanity() -> dict:
    """Ten f32 steps from JAX's seed-0 state against JAX's metrics."""
    cfg, init = load_npz_artifact(TRAIN_REF)
    with np.load(TRAIN_REF) as z:
        ref = {k: [float(v) for v in z[f"jax_{k}"]]
               for k in ("loss", "num_positives", "grad_norm")}
        final = {k[len("final/"):]: z[k] for k in z.files
                 if k.startswith("final/")}
    det = Detector(cfg, init, device=DEVICE)
    opt = Optimizer(cfg)
    state = create_train_state(det, opt)
    step = make_train_step(det, opt)
    batches = [synthetic.sanity_train_batch(i, cfg.train.batch_size,
                                            cfg.data.max_gt_boxes)
               for i in range(len(ref["loss"]))]
    matching_cuda.launches = 0
    got = {k: [] for k in ref}
    for batch in batches:
        state, m = step(state, batch)
        for k in got:
            got[k].append(float(m[k]))
    launches = matching_cuda.launches
    loss_dev = [abs(g / w - 1) for g, w in zip(got["loss"], ref["loss"])]
    gn_dev = [abs(g / w - 1) for g, w in zip(got["grad_norm"],
                                             ref["grad_norm"])]
    weights = det.model.state_dict()
    param_dev = max(float(np.abs(weights[k].cpu().numpy() - v).max())
                    for k, v in final.items())
    emit({"phase": "train_sanity", "steps": len(batches),
          "match_launches": launches,
          "num_positives": got["num_positives"],
          "num_positives_equal": got["num_positives"] == ref["num_positives"],
          "loss": got["loss"], "jax_loss": ref["loss"],
          "loss_rel_dev": loss_dev, "max_loss_rel_dev": max(loss_dev),
          "grad_norm_rel_dev": gn_dev,
          "final_weights_max_abs_dev": param_dev})
    if launches != len(batches):
        raise AssertionError(f"{launches} matching launches for "
                             f"{len(batches)} steps")
    if got["num_positives"] != ref["num_positives"]:
        raise AssertionError("num_positives differ from JAX's")
    if loss_dev[0] > 1e-4 or gn_dev[0] > 2e-3 or max(loss_dev) > 1e-2:
        raise AssertionError(f"training deviates from JAX's: loss "
                             f"{loss_dev}, grad_norm {gn_dev}")
    return {"max_loss_rel_dev": max(loss_dev)}


def train_step_breakdown(det: Detector, cfg: Config, batch: dict,
                         iters: int = 3) -> dict:
    """CUDA-event milliseconds of one training step's stages on ``batch``,
    the mean of ``iters`` steps after one warm-up: the model's train-mode
    forward, target creation (matching kernel included), the per-level loss
    and L2, the backward pass and the optimizer update."""
    opt = Optimizer(cfg)
    state = create_train_state(det, opt)
    images, boxes, labels, num = (det.as_input(batch[k]) for k in (
        "images", "boxes", "labels", "num_boxes"))
    names = ("forward", "targets", "loss", "backward", "update")
    sums = dict.fromkeys(names, 0.0)
    det.model.train()
    for it in range(iters + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        raw = det.model(images)
        ev[1].record()
        t = create_targets(det.anchors, boxes, labels, num, cfg.num_classes,
                           cfg.matcher, class_onehot=False)
        ev[2].record()
        ld = losses.detection_loss_levels(raw, t, cfg.num_classes,
                                          cfg.losses, anchors=det.anchors)
        total = ld.total + losses.l2_regularization(
            det.model.parameters(), cfg.losses.weight_decay)
        ev[3].record()
        total.backward()
        ev[4].record()
        opt.update({k: p.grad for k, p in state.params.items()},
                   state.opt_state, state.params)
        ev[5].record()
        for p in state.params.values():
            p.grad = None
        torch.cuda.synchronize()
        if it:
            for i, name in enumerate(names):
                sums[name] += ev[i].elapsed_time(ev[i + 1]) / iters
    return sums


class TimedBatches(synthetic.SceneBatches):
    """Records when each batch was asked for and when it was ready."""

    def __init__(self, make_batch):
        super().__init__(make_batch)
        self.marks = []

    def __next__(self) -> dict:
        t0 = time.perf_counter()
        batch = super().__next__()
        self.marks.append((t0, time.perf_counter()))
        return batch


def phase_train_flagship(power_line: str, warmup: int = 3,
                         timed: int = 10) -> int:
    """``warmup + timed + 1`` steps through ``train()``: a step is timed
    from its batch being ready to the next batch being asked for (its
    metrics read back in between), so the last step, followed by the
    loop's checkpoint and export, is run but not timed."""
    cfg = Config.load(FLAGSHIP)
    assert cfg.model.compute_dtype == "bfloat16"
    # log every step: each step then ends in a readback of its metrics
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, log_every=1))
    accum = max(cfg.train.grad_accum_steps, 1)
    h, w = cfg.image_hw()
    batches = TimedBatches(lambda i: synthetic.crowded_batch(
        i, CROWDED_SEED, cfg.train.batch_size, h, cfg.num_classes,
        cfg.data.max_gt_boxes))
    workdir = tempfile.mkdtemp(prefix="ssd_train_")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        matching_cuda.launches = 0
        t0 = time.perf_counter()
        steps = warmup + timed + 1
        last = train(cfg, workdir, batches, max_steps=steps, device=DEVICE)
        wall = time.perf_counter() - t0
        launches = matching_cuda.launches
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(os.path.join(workdir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        marks = batches.marks
        step_ms = [(marks[i + 1][0] - marks[i][1]) * 1e3
                   for i in range(len(marks) - 1)]
        data_ms = [(b - a) * 1e3 for a, b in marks]
        losses = [r["loss"] for r in records]
        if len(records) != steps:
            raise AssertionError(f"{len(records)} logged steps")
        if not all(np.isfinite(v) for r in records for k, v in r.items()
                   if isinstance(v, float)):
            raise AssertionError("a training metric is not finite")
        if launches != steps * accum:
            raise AssertionError(f"{launches} matching launches, want "
                                 f"{steps * accum}")

        # one step's batch: the kernel's matches equal the plain version's
        det = Detector(cfg, device=DEVICE)
        b = synthetic.crowded_batch(0, CROWDED_SEED, cfg.train.batch_size, h,
                                    cfg.num_classes, cfg.data.max_gt_boxes)
        gt = torch.from_numpy(b["boxes"]).to(DEVICE)
        num = torch.from_numpy(b["num_boxes"]).to(DEVICE)
        m_kernel = matching_cuda.match_anchors(det.anchors, gt, num,
                                               cfg.matcher)
        m_plain = matching.finish_matches(
            *_plain_core(det.anchors, gt, num), num, cfg.matcher)
        if not torch.equal(m_kernel, m_plain):
            raise AssertionError("flagship batch: kernel matches differ")
        breakdown = train_step_breakdown(det, cfg, b)
        del det

        # the export serves
        pred = Predictor.from_npz(os.path.join(workdir, EXPORT_NAME),
                                  device=DEVICE)
        served = b["images"][:8]
        out = pred.predict(served)
        _check_output(out, len(served), cfg.nms.max_boxes)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    timed_ms = step_ms[warmup:warmup + timed]
    p50 = float(np.median(timed_ms))
    emit({"phase": "train_flagship", "config": os.path.relpath(FLAGSHIP, ROOT),
          "dtype": "bfloat16", "batch": cfg.train.batch_size, "image": [h, w],
          "anchors": cfg.num_anchors(), "grad_accum_steps": accum,
          "optimizer": cfg.train.optimizer, "box_loss": cfg.losses.box_loss,
          "ema_decay": cfg.train.ema_decay, "weights": "seeded (train.seed)",
          "steps": steps, "warmup_steps": warmup, "timed_steps": timed,
          "match_launches": launches, "kernel_vs_plain_equal": True,
          "losses": losses, "final_metrics": last,
          "step_ms": step_ms, "p50_step_ms": p50,
          "img_per_s": cfg.train.batch_size / p50 * 1e3,
          "host_data_ms": data_ms,
          "p50_host_data_ms": float(np.median(data_ms[warmup:
                                                      warmup + timed])),
          "wall_s": wall, "peak_mem_gib": peak_gib,
          "device_ms": breakdown,
          "export_served": True,
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
    ptxas = {k: _build.ptxas_lines(v) for k, v in _build.build_logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": built, "sources": _build.sources(),
          "ptxas": ptxas})

    main_nms = phase_nms()
    phase_sanity()
    nms_launches = phase_serve("flagship", FLAGSHIP, power_line)
    nms_launches_reference = phase_serve("reference_serve", REFERENCE,
                                         power_line)
    phase_reference_golden()
    main_early, early_launches = phase_fused_early(power_line)
    main_match = phase_match()
    phase_train_sanity()
    match_launches = phase_train_flagship(power_line)

    emit({"kernels": [{
        "name": "nms", "route": "cuda", "source": "ssd_tpu_torch/csrc/nms.cu",
        "replaces": "ssd_tpu/ops/nms_pallas.py:78",
        "launches": nms_launches + nms_launches_reference,
        "max_abs_err": main_nms["max_abs_err"], "ms": main_nms["ms"],
        "timing": main_nms["timing"], "call_ms": main_nms["call_ms"],
        "plain_ms": main_nms["plain_ms"], "bound_ms": main_nms["bound_ms"],
        "bound_by": main_nms["bound_by"], "library_ms": None,
        "ptxas": ptxas.get("nms")}, {
        "name": "match", "route": "cuda",
        "source": "ssd_tpu_torch/csrc/match.cu",
        "replaces": "ssd_tpu/ops/matching_pallas.py:60",
        "launches": match_launches,
        "max_abs_err": main_match["max_abs_err"], "ms": main_match["ms"],
        "timing": main_match["timing"], "call_ms": main_match["call_ms"],
        "plain_ms": main_match["plain_ms"],
        "bound_ms": main_match["bound_ms"],
        "bound_by": main_match["bound_by"], "library_ms": None,
        "cull_share": main_match["cull_share"],
        "ptxas": ptxas.get("match")}, {
        "name": "fused_early", "route": "cuda",
        "source": "ssd_tpu_torch/csrc/fused_early.cu",
        "replaces": "ssd_tpu/ops/fused_early.py:187",
        "launches": early_launches,
        "max_abs_err": main_early["max_abs_err"],
        "max_ulps": main_early["max_ulps"],
        "bit_equal_share": main_early["bit_equal_share"],
        "ms": main_early["ms"], "timing": main_early["timing"],
        "call_ms": main_early["call_ms"],
        "plain_ms": main_early["plain_ms"],
        "unfused_ms": main_early["unfused_ms"],
        "bound_ms": main_early["bound_ms"],
        "bound_by": main_early["bound_by"],
        **{k: main_early[k] for k in (
            "bound_bytes_ms", "bound_operations_ms", "bound_depthwise_f32_ms",
            "bound_pointwise_bf16_ms", "bound_f32_ms")},
        "library_ms": None, "ptxas": ptxas.get("fused_early")}]})
    print(power_line)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
