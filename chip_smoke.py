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
   ``Predictor.from_npz``; f32 detections on both feeds (the packed s8 and
   the raw uint8) set-equal to the stored JAX ones, bf16 detections' share
   of the JAX bf16 ones;
   int8_sanity: the same artifact in int8 (``int8_neck``), calibrated on
   the card on the seed-7 batch of 8 as the JAX package does: its 39
   scales against JAX's stored ones (``assets/sanity_int8_v1.npz``), the
   mAP of the 32 val scenes by the port's own evaluator within 0.002 of
   JAX's CPU mAP, and, served on JAX's stored scales instead, the share of
   JAX's int8 detections matched under the golden rule (reported);
   gemm_exact: the int8 product at the flagship's P3 class ``predict``
   shape (b32: M = 204 800, K = 1152, N = 720) on the card equal, element
   for element, to the same conv on the CPU, in s32 and dequantized bf16,
   the CPU's own sums checked against an int32 matmul on a slice; and the
   shapes ``torch._int_mm`` takes on the card;
5. flagship: ``configs/coco_mobilenet_640_flagship.json`` at full width
   (bf16, 640 px, 80 classes, seeded weights) serving 10 batches of 32
   through ``Predictor.predict``, a list of mixed-size images and a
   letterboxed request, with the NMS launches of that run counted; on one
   batch the kernel path and the plain ``batched_nms`` agree exactly;
   int8_flagship: the same in int8 with ``int8_neck`` (the shipped serving
   configuration), calibrated on one seeded batch of 8 (absmax, and a
   99.9-percentile run on another copy of the model, past 2^24 values),
   the packed and raw uint8 feeds' raw maps bit-equal, the bf16 model of
   the same weights timed in turns with it, and the P3 class ``predict``
   conv's quantize, im2col, GEMM and dequantize timed;
   reference_serve: the same for ``configs/coco_mobilenet_640.json`` (the
   reference MobileNet-v1 schedule, stem at stride 2 then ds1 and ds2) on
   the raw uint8 feed;
   reference_golden: ``ssd_tpu_torch/assets/golden_cells_v1.npz`` (the
   JAX package's ``tests/goldens/predict_cells_v1.npz`` with its weights)
   served in f32: raw slices at the golden bars (atol 2e-4, rtol 2e-3) and
   detections set-equal to JAX's under the golden rule;
   backbones_golden: ``ssd_tpu_torch/assets/backbones_golden_v1.npz``
   (JAX's numbers for MobileNet-v2, EfficientNet-lite0, ShuffleNet-v2,
   ResNet-50 and MobileNet-v1 with group norm, at full width, 128 px, 8
   classes, f32, weights from ``convert.seeded_state``) on the card: raw
   maps at the golden bars, detections under the golden set rule, step-0
   loss terms within 1e-4, the gradient norm within 2e-3 of JAX's float64
   truth and within 2e-3 plus JAX's own distance from that truth of JAX's;
   serve_resnet50, serve_mobilenet_v2, serve_efficientnet_lite,
   serve_shufflenet: each other shipped config at full width as the
   flagship serve runs (b32/640; ShuffleNet b8/512), K1 held against the
   plain ``batched_nms`` on the candidates of the path it serves;
   int8_resnet50, int8_mobilenet_v2, int8_efficientnet_lite,
   int8_shufflenet: the same configs in int8 with the calibrated neck
   (every dense conv quantized, calibrated on one seeded batch of 8), the
   same way;
   select_anchors, fused_head: the flagship with ``select="anchors"`` and
   with the fused 1x1 head, the same way; select_paths: the pyramid
   selection through K1 on 4 batches, the fused head's ``fused_logit_max``
   beside the cuDNN class conv it replaces, and Soft-NMS (linear,
   gaussian) served with no K1 launch, timed beside K1 on the same
   candidates, the card's result equal to the CPU's on two images;
   tiled: tiled inference (``tiling.TiledPredictor``) of one seeded
   3840x2160 image with the flagship, 40 tiles and the full pass in one
   predict (bucket 64), the IoS merge on the card bit-equal to the CPU's
   on the same per-tile detections, its time and share;
   tta: flip TTA (``tta.TTAPredictor``) of the flagship at b32, 64 views
   in one predict, the weighted box fusion on the card bit-equal to the
   CPU's on the same view detections, its time and share; then behind the
   daemon with the TTA predictor (``scan_depth`` 1), each request's JSON
   against the direct call;
   streaming: ``configs/streaming_1024.json`` (the reference stem at
   1024x1024, full width and depth) through ``StreamingDetector`` at depth
   2, bf16 and int8 (calibrated neck): 64 frames from 8 seeded 1024 frames
   and 8 of 1080x1920 (the native resize stretches them), K1 launched once
   a frame, no wait for the card under ``streaming.push`` in a profiled
   window, every frame bit-equal to ``Predictor.predict`` of it; fps,
   p50/p95 latency, the card's busy time and the host's push time a frame;
   export: ``export.export_program`` of the flagship at b8, bf16 and int8
   (calibrated neck), each ``.pt2`` loaded (``load_program``) and run:
   bit-equal to eager ``Detector.predict`` on the same uint8 batch, K1
   launched by the loaded program; export and load seconds, the program's
   ms beside eager's;
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
   conv_s8: K4, the int8 dense conv (``csrc/conv_s8.cu``), driven through
   ``ssd_tpu_torch.tools.bench_conv_s8``: every case of
   ``tools/kernel_cases.conv_cases`` bit-equal to its plain composition
   on the card; the benchmark cell's int8 forward at b32
   (``bench_port/configs/ssd_mnv1_fpn_640.json``): K4's launches equal to
   its int8 dense convs, no ``torch._int_mm``, no weight preparation after
   the first batch; each distinct conv shape of that forward, on seeded
   inputs, bit-equal to the plain composition and timed (graph replay and
   eager calls) beside its bound, the plain composition and
   ``torch._int_mm`` alone on its im2col; one conv's host cost through
   the operator; that forward at b32 and every shipped config's int8
   forward with K4 bit-equal to the same forward with the plain
   composition on the card (``python3 chip_smoke.py --phase conv_s8``
   runs this phase alone, ``--phase int8`` it and every phase that serves
   int8: int8_sanity, gemm_exact, int8_flagship, the int8_ serves,
   serve_pipelined, tiled, streaming, export). Every phase that serves
   counts K4's launches beside K1's and holds them to the model's int8
   dense convs a forward times its forwards (none in bf16);
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
   exported artifact directory served by ``Predictor.from_checkpoint``;
   train_resnet50, train_mobilenet_v2, train_efficientnet_lite,
   train_shufflenet: each other shipped config trained the same way, as
   shipped (b64, no accumulation: the ResNet-50 config's step fits since
   the train-mode batch norm keeps only its input), 2 warm-up and 4 timed
   steps, its K2 launches counted, K2 held against its plain version on
   one batch (ShuffleNet's at 512: 49 104 anchors), peak memory and step
   p50;
   train_memory: ``tools/train_memory.py`` at b64/640 on the ResNet-50,
   MobileNet-v2 and flagship configs: the tensors one forward and backward
   saves, by module and dtype, and the peak;
9. train_pipeline: the shipped flagship trained through the CLI
   (``python -m ssd_tpu_torch.train`` in a subprocess) from tfrecords that
   the port's ``create_tfrecords`` writes from seeded crowded scenes (256
   train JPEGs of 480x640, 640x640 and 800x600 in 4 shards, 64 val, a
   label map), at full width, batch 64, 24 steps in turns of 4 at 512,
   640 and 768, mosaic, crop, flip, colour and EMA, evaluated at its last
   step, one steady step profiled: no stream sync and no pageable upload
   inside a step, K2 launched once a step and microbatch, the eval mAP
   finite; the same command again resumes and stops; the artifact
   directories ``best/`` and ``export/`` serve with K1 and the label map;
   eval_cli: ``python -m ssd_tpu_torch.eval --export`` on ``best/`` and
   the val shards, with and without ``--tta``, the mAP finite and K1
   launched once a predict; export_cli: ``python -m ssd_tpu_torch.export``
   on the workdir, its weights bit-equal to the loop's ``export/``, and
   the eval CLI on it (``--export``) and on the same weights as one file
   (``--npz``) giving the same mAP; a run warm-started from
   that export and distilled from it copies every leaf and logs a finite
   ``distill_loss``; the host pipeline on ``assets/train_golden_v1.npz``'s
   shard gives JAX's stored batches (images bit-equal, or at most 1 unit
   apart in examples whose colour jitter ran); the pipeline timed alone at
   each scale with 8 workers; per-scale step p50, the wait for data, img/s
   and peak memory;
10. tools_m12: the rest of the tools and the demo, each through its entry
    point, their K1 and K2 launches counted: ``tools/summarize.py`` on the
    flagship at b32 (serve and train: FLOPs by class, bytes, the H100
    roofline) beside the same predict's device ms; ``tools/
    analyze_anchors.py`` on the flagship at 640 over 64 seeded 80-class
    crowded scenes written as a tfrecord, K2 once a batch, the report
    equal to the CPU plain matcher's; ``tools/crowded_validation.py`` at
    its full width (256 px, x0.5, FPN 64, 40 classes) trained 100 steps
    from its tfrecords (512 train scenes, one step profiled), then its 24
    variants over 64 val scenes: K1 once a batch on each of the 21 hard
    rows and never on the 3 Soft-NMS rows, each hard row's detections of
    4 images equal to the CPU plain version's on the same raw maps under
    the golden set rule; ``utils/trace_tools.py``'s tables over that
    run's trace within 1% of ``utils/profiling.summarize``'s device ms on
    the same window, K2's row counting the window's launch, and its
    ``tb/`` events equal to its ``metrics.jsonl`` (the same for
    train_pipeline's run, in its line); ``tools/tiled_validation.py`` on
    those weights, 4 scenes at 1024 px with the ablations;
    ``tools/calibration_study.py``'s dense4 model trained 100 steps, bf16
    and one int8 regime (8 train images, absmax); ``tools/
    make_bench_artifact.py`` 200 steps from ``--seed 0`` (loss,
    ``sanity_map``); ``tools/import_tf.py`` on the committed TF1
    checkpoint ``assets/tf_ckpt_v1``, served on the card equal to the
    CPU's predict under the golden set rule; ``python -m
    ssd_tpu_torch.demo --selftest``, its PNG written with one K1 launch.
    ``--phase tools_m12`` runs it alone;
11. scaleout: the flagship over a process group on the one card: (a) the
    data-parallel step over NCCL at world size 1 (global batch norm,
    normalizers and gradient sum: identities there), one warm-up and 4
    steps held bit-equal to the plain step from the same seeded state on
    the same batches (params, BN statistics, EMA, metrics; cuDNN's
    deterministic algorithms in both), K2 once a step, no wait for the
    card inside a profiled step; (b) the same step under FSDP
    (``param_sharding: "fsdp"``) within rtol and atol 1e-5 of (a), its
    bit-equal share; the three timed in turns (p50, peak memory); (c)
    ``train.evaluate`` with the mesh and the stat gather over the eval
    golden, JAX's numbers to 1e-6, K1 once a batch; (d)
    ``Predictor(mesh=True)`` at b32 bit-equal to the plain predictor, K1
    once a device a predict; (e) two ranks on the card over gloo
    (``torchrun`` of ``tools/bench_train.py``, the f32 flagship at b8):
    the ranks' states bit-identical and within the f32 bars of the
    one-process step on the 8 rows. ``python3 chip_smoke.py --phase
    scaleout`` runs this phase alone, after the build;
    scaleout_m11b: (f) channel TP at the flagship's full width, f32, two
    gloo ranks on the card on a (1, 2) mesh (``tools/scaleout_check.py
    --model-parallelism 2``), 3 steps at b4 within (e)'s bars of the
    one-process step, K2 once a step and rank; (g) ``tools/dryrun.py``'s
    ``dryrun_multichip(4)``: TP, then FSDP x TP with 2 accumulation steps
    on a (2, 2) mesh of four gloo ranks on the card, its meshed predict
    equal to one device's; (h) ``configs/streaming_1024.json`` streamed
    with each frame's rows in 4 strips of the card (``spatial_shard``, the
    halo exchange of ``parallel/spatial.py``), 16 frames in f32 within
    1e-5 of the unsplit stream and in bf16 under the golden rule, K1 once
    a frame, no wait for the card under a push, ms a frame beside the
    unsplit stream's; the flagship ``Predictor(spatial_shard=True)`` on a
    (2, 2) mesh of the card at b8; with four cards visible, (h)'s bf16
    stream on four cards and each card's peak memory over a 1024 frame
    against one card's. ``--phase scaleout_m11b`` runs it alone;
12. the kernels line, then the card's ``nvidia-smi`` line, then the
    result.

Times are CUDA-event times after warm-up, or host times around work that
ends in a synchronise; they are from an unoptimised eager bring-up. K1's,
K2's and K3's ``ms`` is device time by CUDA-graph replay, and ``call_ms`` the
time of back-to-back eager calls of the wrapper, its host work included
(``ssd_tpu_torch/tools/bench_kernels.py``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import glob
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import types
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ssd_tpu_torch import _build
from ssd_tpu_torch.config import Config, MatcherConfig, NMSConfig
from ssd_tpu_torch.convert import (is_scale, load_npz_artifact,
                                   save_npz_artifact, scale_name,
                                   seeded_state)
from ssd_tpu_torch.data import create_tfrecords, native, pipeline, synthetic
from ssd_tpu_torch.data.resize import resize as plain_resize
from ssd_tpu_torch.eval import sanity
from ssd_tpu_torch.export import (export_program, load_inference_artifact,
                                  load_program)
from ssd_tpu_torch.models.detector import Detector, normalize_images
from ssd_tpu_torch.models.fpn import flatten_levels
from ssd_tpu_torch.models.layers import (conv_int8, dequantize,
                                         im2col_padded, int_mm,
                                         quantize_activation,
                                         quantize_weight)
from ssd_tpu_torch.ops import (box_utils, conv_s8_cuda, fused_early,
                               fused_early_cuda, ingest, losses, matching,
                               matching_cuda, nms, nms_cuda)
from ssd_tpu_torch.ops.anchors import generate_anchors
from ssd_tpu_torch.ops.fused_head import fused_logit_max, predict_params
from ssd_tpu_torch.ops.postprocess import (postprocess_pyramid, run_nms,
                                           select_candidates_cells,
                                           select_candidates_pyramid)
from ssd_tpu_torch.ops.targets import create_targets
from ssd_tpu_torch.predictor import (Predictor, detection_rows,
                                     detections_arrays)
from ssd_tpu_torch.quant import calibrate, int8_config
from ssd_tpu_torch.serve import DetectionServer
from ssd_tpu_torch.parallel.spatial import STRIP_SPAN
from ssd_tpu_torch.streaming import PUSH_SPAN, StreamingDetector
from ssd_tpu_torch.tiling import TiledPredictor
from ssd_tpu_torch.parallel import mesh as mesh_lib
from ssd_tpu_torch.tools import (bench_conv_s8, bench_fused_early,
                                 bench_http, bench_serve, bench_streaming,
                                 kernel_cases, scaleout_check, train_memory)
from ssd_tpu_torch.tta import TTAPredictor, fuse_flip_batch
from ssd_tpu_torch.tools.bench_fused_early import cuda_ms, randomize_early_bn
from ssd_tpu_torch.tools.bench_kernels import kernel_ms
# the H100 SXM data sheet's HBM rate and f32, dense bf16 and int8 peaks: one
# copy, the cost summary's
from ssd_tpu_torch.tools.summarize import (BF16_TENSOR_FLOP_PER_S,
                                           F32_FLOP_PER_S, HBM_BYTES_PER_S,
                                           INT8_TENSOR_OP_PER_S)
from ssd_tpu_torch.train import (BEST_NAME, EXPORT_NAME, PROFILE_START,
                                 DeviceFeed, evaluate, train)
from ssd_tpu_torch.train_step import (Optimizer, create_train_state,
                                      make_train_step)
from ssd_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, "configs", "coco_mobilenet_640_flagship.json")
REFERENCE = os.path.join(ROOT, "configs", "coco_mobilenet_640.json")
STREAMING = os.path.join(ROOT, "configs", "streaming_1024.json")
ASSET = os.path.join(ROOT, "ssd_tpu_torch", "assets", "sanity_v1.npz")
GOLDEN = os.path.join(ROOT, "ssd_tpu_torch", "assets", "golden_cells_v1.npz")
TRAIN_REF = os.path.join(ROOT, "ssd_tpu_torch", "assets", "train_ref_v1.npz")
INT8_REF = os.path.join(ROOT, "ssd_tpu_torch", "assets", "sanity_int8_v1.npz")
SERVE_GOLDEN = os.path.join(ROOT, "ssd_tpu_torch", "assets",
                            "serve_golden_v1.npz")
TRAIN_GOLDEN = os.path.join(ROOT, "ssd_tpu_torch", "assets",
                            "train_golden_v1.npz")
EVAL_GOLDEN = os.path.join(ROOT, "ssd_tpu_torch", "assets",
                           "eval_golden_v1.npz")
BACKBONES_GOLDEN = os.path.join(ROOT, "ssd_tpu_torch", "assets",
                                "backbones_golden_v1.npz")
# the shipped configs of the other backbones (M9): name -> (config, the
# serving batch: BASELINE's b8 for ShuffleNet at 512, b32 for the rest).
# Each trains as shipped (b64, no accumulation; the ResNet-50 config's step
# fits the card's 80 GB since the train-mode batch norm keeps only its
# input), and serves in int8 with the calibrated neck (M9b).
NEW_CONFIGS = {
    "resnet50": ("coco_retinanet_resnet50_640.json", 32),
    "mobilenet_v2": ("coco_mobilenet_v2_640.json", 32),
    "efficientnet_lite": ("coco_efficientnet_lite0_640.json", 32),
    "shufflenet": ("coco_shufflenet_512.json", 8),
}
# the configs whose step memory train_memory tallies at b64/640
MEMORY_CONFIGS = ("coco_retinanet_resnet50_640.json",
                  "coco_mobilenet_v2_640.json",
                  "coco_mobilenet_640_flagship.json")
TILED_IMAGE_HW = (2160, 3840)  # a 4K frame: 40 flagship tiles + full pass
STREAM_FRAMES = 64  # timed frames a streaming run, after its warmup
STREAM_DEPTH = 2
STREAM_PROFILED = 16  # frames under the profiler after the timed ones
STREAM_HD_HW = (1080, 1920)  # frames that the native resize stretches
EXPORT_BATCH = 8
GOLDEN_BARS = dict(atol=2e-4, rtol=2e-3)  # tests/test_golden.py's
LOSS_RTOL = 1e-4  # step-0 loss terms against JAX's
GRAD_NORM_RTOL = 2e-3  # step-0 gradient norm (train_sanity's bar)
DET_KEYS = ("boxes", "scores", "labels", "num_boxes")
DEVICE = torch.device("cuda")

IOU_FLOPS = 12  # 4 min/max, 3 sub, 2 clamp, 1 mul, 1 add, 1 div
# matching: the IoU, the union's floor, and the compare into each maximum
MATCH_FLOPS = 13
# the flagship training shape: data.max_gt_boxes and crowded scenes
MATCH_M = 100
CROWDED_SEED = 0
# Class-head bias of the seeded flagship: sigmoid(-2.5) = 0.076, above the
# 0.05 score threshold, so candidates of every class are live and NMS works.
FLAGSHIP_CLASS_BIAS = -2.5
SANITY_MAP_BAR = 0.002  # int8 mAP against JAX's, the bar bf16 is held to
# f32 evaluate() against JAX's numbers: the f32 detections match JAX's with
# scores within 1e-3 (phase sanity), which can reorder only near-ties
EVAL_MAP_BAR = 1e-3
# a staging buffer's wait for its last upload, within a step or a predict:
# with the metrics read back every step, that upload has long finished
STAGING_WAIT_BAR_MS = 1.0
# what an earlier phase measured that a later one reads: each serve's device
# ms a batch by phase (phase_serve; tools_m12 reads the flagship's)
MEASURED: dict = {}


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


def phase_nms() -> tuple[dict, dict]:
    """Every NMS case; the serving one (``serve_b32``) timed and returned,
    with the timed serving case at the streamed frame's batch (one) and
    the exported program's (``EXPORT_BATCH``) by name."""
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
    # an evaluation's predict at the flagship's training batch: 64 x 80
    # problems, every one live
    b64 = next(c for c in kernel_cases.nms_cases(
        64, 1024, 80, max_k=nms_cuda._max_k(DEVICE)) if c.name == "serve")
    row = check_nms_case(b64, "eval_b64")
    if row["live_problems"] != row["G"]:
        raise AssertionError("eval_b64 must have every problem live")
    shapes = {}
    for n, name in ((1, "stream_b1"), (EXPORT_BATCH, f"export_b{EXPORT_BATCH}")):
        case = next(c for c in kernel_cases.nms_cases(
            n, 1024, 80, max_k=nms_cuda._max_k(DEVICE)) if c.name == "serve")
        row = check_nms_case(case, name, timed=True)
        if row["live_problems"] != row["G"]:
            raise AssertionError(f"{name} must have every problem live")
        shapes[name] = {k: row[k] for k in (
            "N", "Q", "C", "K", "max_abs_err", "ms", "call_ms", "plain_ms",
            "bound_ms", "bound_by")}
    return main, shapes


# ------------------------------------------------------------------ models

def set_match(got: dict, want: dict, score_tol: float = 1e-3,
              box_tol: float = 1e-2) -> tuple[int, int]:
    """(matched, total) wanted detections under the golden rule: same label,
    score within ``score_tol`` (1e-3), box within ``box_tol`` (1e-2), each
    got detection used once."""
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
                                   - want["boxes"][i, j]).max() < box_tol):
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
    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32"))
    p32 = Predictor(cfg32, state, device=DEVICE)
    p32_raw = Predictor(cfg32, state, device=DEVICE, packed_ingest=False)
    assert p32._packed and not p32_raw._packed
    got32 = p32.predict(images)
    got32_raw = p32_raw.predict(images)
    got16 = p16.predict(images)
    launches = nms_cuda.launches
    m32, t32 = set_match(got32, jax_det["f32"])
    m32_raw, _ = set_match(got32_raw, jax_det["f32"])
    m16, t16 = set_match(got16, jax_det["bf16"])
    # one bf16 step of a logit near -3 moves its score by ~1e-3, so bf16
    # detections are also matched with the score held to 1e-2
    m16_loose, _ = set_match(got16, jax_det["bf16"], score_tol=1e-2)
    nb_equal = all(bool((g["num_boxes"] == jax_det["f32"]["num_boxes"]).all())
                   for g in (got32, got32_raw))
    emit({"phase": "sanity", "images": len(images), "nms_launches": launches,
          "f32_matched": m32, "f32_total": t32, "f32_num_boxes_equal": nb_equal,
          "f32_raw_feed_matched": m32_raw,
          "bf16_matched": m16, "bf16_total": t16,
          "bf16_match_share": m16 / max(t16, 1),
          "bf16_match_share_score_1e-2": m16_loose / max(t16, 1)})
    if launches < 3:
        raise AssertionError("sanity phase did not run the NMS kernel")
    if m32 != t32 or m32_raw != t32 or not nb_equal:
        raise AssertionError(f"f32 detections differ from JAX: {m32}/{t32} "
                             f"packed, {m32_raw}/{t32} raw")


def _scales(model) -> dict:
    return {k: float(v) for k, v in model.state_dict().items()
            if is_scale(k)}


def phase_int8_sanity(power_line: str) -> int:
    """The sanity artifact in int8 on the card: calibrated here, scored by
    the port's evaluator against JAX's CPU mAP; then served on JAX's
    stored scales. Returns the NMS launches of the calibrated run."""
    with np.load(INT8_REF) as z:
        jax_scales = {scale_name(k): float(z[k]) for k in z.files
                      if k.startswith("quant/")}
        jax_det = {k: z[f"jax_int8_{k}"] for k in DET_KEYS}
        jax_map = float(z["jax_int8_map"])
    with np.load(ASSET) as z:
        images = z["images"]

    t0 = time.perf_counter()
    pred = sanity.sanity_predictor(ASSET, int8=True, device=DEVICE)
    cal_s = time.perf_counter() - t0
    got_scales = _scales(pred.detector.model)
    if set(got_scales) != set(jax_scales) or len(jax_scales) != 39:
        raise AssertionError("calibrated scale keys differ from JAX's")
    rel = {k: abs(got_scales[k] / jax_scales[k] - 1) for k in jax_scales}
    worst = max(rel, key=rel.get)

    nms_cuda.launches = conv_s8_cuda.launches = 0
    result = sanity.evaluate_predictor(pred)
    launches, k4 = nms_cuda.launches, conv_s8_cuda.launches
    port_map = float(result["mAP"])
    k4 = k4_count(pred.detector, images[:1], k4, launches, "int8_sanity")

    cfg, state = load_npz_artifact(ASSET)
    state.update({k: torch.tensor(v) for k, v in jax_scales.items()})
    on_jax = Predictor(int8_config(cfg), state, device=DEVICE)
    got = on_jax.predict(images)
    matched, total = set_match(got, jax_det)
    emit({"phase": "int8_sanity", "images": len(images),
          "calibration_s": cal_s, "scales": len(got_scales),
          "scale_max_rel_diff": rel[worst], "scale_max_rel_diff_at": worst,
          "backbone_scales_at_6_over_127": sum(
              v == float(np.float32(6) / np.float32(127))
              for k, v in got_scales.items() if k.startswith("backbone.")),
          "map": port_map, "jax_cpu_map": jax_map,
          "map_diff": port_map - jax_map, "map_bar": SANITY_MAP_BAR,
          "ap50": result["AP50"], "nms_launches": launches, **k4,
          "jax_scales_matched": matched, "jax_scales_total": total,
          "jax_scales_match_share": matched / max(total, 1),
          "note": "int8 on " + power_line})
    if launches < 4:
        raise AssertionError("int8 sanity did not run the NMS kernel")
    if abs(port_map - jax_map) > SANITY_MAP_BAR:
        raise AssertionError(f"int8 mAP {port_map} vs JAX {jax_map}")
    return launches


def int_mm_limits() -> dict:
    """Which shapes ``torch._int_mm`` takes on the card, unpadded: each
    probe's error, or None. ``int_mm`` pads every product to M > 16 and K,
    N multiples of 8; this records what the limits are."""
    out = {}
    for m, k, n, layout in ((16, 64, 64, "b col-major"),
                            (17, 64, 64, "b col-major"),
                            (32, 60, 64, "b col-major"),
                            (32, 64, 36, "b col-major"),
                            (32, 64, 64, "b row-major")):
        a = torch.ones(m, k, dtype=torch.int8, device=DEVICE)
        b = torch.ones(n, k, dtype=torch.int8, device=DEVICE)
        b = b.t() if layout == "b col-major" else b.t().contiguous()
        try:
            torch._int_mm(a, b)
            torch.cuda.synchronize()
            out[f"{m}x{k}x{n} {layout}"] = None
        except RuntimeError as e:  # a refused shape: recorded, not used
            out[f"{m}x{k}x{n} {layout}"] = str(e).splitlines()[0][:120]
    return out


def phase_gemm_exact(power_line: str) -> None:
    """The flagship's P3 class ``predict`` product at b32 on the card and on
    the CPU, on the same s8 input and weights: s32 and bf16 equal."""
    cfg = Config.load(FLAGSHIP)
    k_out = cfg.anchors.num_anchors_per_cell * cfg.num_classes  # 720
    c, (h, w) = cfg.model.fpn_channels, cfg.feature_map_sizes()[0]
    gen = torch.Generator().manual_seed(7)
    x_q = torch.randint(-127, 128, (32, h, w, c), dtype=torch.int8,
                        generator=gen)
    weight = torch.randn(k_out, c, 3, 3, generator=gen) * 0.01
    bias = torch.full((k_out,), FLAGSHIP_CLASS_BIAS)
    a_scale = torch.tensor(0.05)
    k_q, k_scale = quantize_weight(weight)
    scale = a_scale * k_scale

    t0 = time.perf_counter()
    y_cpu = conv_int8(x_q, k_q, 1)
    cpu_s = time.perf_counter() - t0
    cols = im2col_padded(x_q, 3, 3, 1, (1, 1, 1, 1), (h, w)).reshape(
        -1, 9 * c)[:2048]
    w2d = k_q.permute(0, 2, 3, 1).reshape(k_out, 9 * c)
    if not torch.equal(y_cpu.reshape(-1, k_out)[:2048],
                       cols.int() @ w2d.int().t()):
        raise AssertionError("the CPU's int8 GEMM is not exact here")
    out_cpu = dequantize(y_cpu, scale, bias)

    x_d, k_d = x_q.to(DEVICE), k_q.to(DEVICE)
    with torch.inference_mode():
        y_dev = conv_int8(x_d, k_d, 1)
        out_dev = dequantize(y_dev, scale.to(DEVICE), bias.to(DEVICE))
        cols_d = im2col_padded(x_d, 3, 3, 1, (1, 1, 1, 1), (h, w)).reshape(
            -1, 9 * c)
        w_d = w2d.to(DEVICE)
        gemm_ms = cuda_ms(lambda: int_mm(cols_d, w_d), iters=10)
    torch.cuda.synchronize()
    s32_diff = int((y_dev.cpu() != y_cpu).sum())
    bf16_diff = int((out_dev.cpu() != out_cpu).sum())
    m, kk = cols_d.shape
    ops = 2 * m * kk * k_out
    emit({"phase": "gemm_exact", "M": m, "K": kk, "N": k_out,
          "s32_elements": y_cpu.numel(), "s32_differ": s32_diff,
          "bf16_differ": bf16_diff, "cpu_s": cpu_s,
          "gemm_ms": gemm_ms, "gemm_tops": ops / gemm_ms / 1e9,
          "gemm_bound_ms": max(ops / INT8_TENSOR_OP_PER_S,
                               (m * kk + kk * k_out + 4 * m * k_out)
                               / HBM_BYTES_PER_S) * 1e3,
          "int_mm_unpadded": int_mm_limits(),
          "note": "on " + power_line})
    if s32_diff or bf16_diff:
        raise AssertionError(f"int8 GEMM differs from the CPU's: {s32_diff} "
                             f"s32, {bf16_diff} bf16 elements")


def _check_output(out: dict, n: int, max_boxes: int) -> None:
    assert out["boxes"].shape == (n, max_boxes, 4), out["boxes"].shape
    assert out["scores"].shape == (n, max_boxes)
    assert out["labels"].shape == (n, max_boxes)
    assert out["num_boxes"].shape == (n,)
    assert np.isfinite(out["boxes"]).all() and np.isfinite(out["scores"]).all()
    assert (out["boxes"] >= 0).all() and (out["boxes"] <= 1).all()


def k4_count(det: Detector, images, launches: int, forwards: int,
             what: str) -> dict:
    """K4's ``launches`` (``conv_s8_cuda.launches``) over ``forwards``
    forwards of ``det``'s model, against its int8 dense convs a forward
    (counted on one more forward of ``images`` by
    ``bench_conv_s8.conv_calls``; none in a bf16 model): raises unless
    equal."""
    model = det.model.eval()
    with torch.inference_mode(), bench_conv_s8.conv_calls(model) as convs:
        model(det.as_input(images))
    if launches != convs[0] * forwards:
        raise AssertionError(f"{what}: {launches} K4 launches for "
                             f"{forwards} forwards of {convs[0]} int8 "
                             "dense convs")
    return {"k4_launches": launches, "int8_dense_convs_a_forward": convs[0]}


def calibrate_flagship(pred: Predictor, cfg: Config) -> dict:
    """Calibrates ``pred`` on one seeded batch of 8 (absmax); a second copy
    of the model takes the 99.9 percentile of the same batch, whose largest
    conv input (ds3's, 8 x 128 x 160 x 160) is past 2^24 values."""
    h, w = cfg.image_hw()
    batch = np.random.default_rng(8).integers(0, 256, (8, h, w, 3),
                                              dtype=np.uint8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calibrate(pred.detector, [batch])
    torch.cuda.synchronize()
    absmax_s = time.perf_counter() - t0
    state = pred.detector.model.state_dict()
    pct = Detector(cfg, {k: v for k, v in state.items() if not is_scale(k)},
                   device=DEVICE)
    t0 = time.perf_counter()
    calibrate(pct, [batch], percentile=99.9)
    torch.cuda.synchronize()
    pct_s = time.perf_counter() - t0
    absmax, p999 = _scales(pred.detector.model), _scales(pct.model)
    ratio = [p999[k] / absmax[k] for k in absmax]
    if set(p999) != set(absmax) or max(ratio) > 1.0:
        raise AssertionError("percentile scales exceed absmax's")
    return {"calibration": {
        "batch": 8, "scales": len(absmax), "absmax_s": absmax_s,
        "percentile_99.9_s": pct_s,
        "largest_conv_input": batch.shape[0] * pct.model.backbone.ds3
        .pointwise.conv.weight.shape[1] * (h // 4) * (w // 4),
        "percentile_over_absmax_min": min(ratio),
        "percentile_over_absmax_median": float(np.median(ratio))}}


def int8_checks(pred: Predictor, cfg: Config, batches: list,
                feed: torch.Tensor, power_line: str) -> dict:
    """The int8 serve beside the bf16 model of the same weights (batches in
    turns, same process), its two feeds' raw maps, and the P3 class
    ``predict`` conv's parts."""
    det = pred.detector
    state = {k: v for k, v in det.model.state_dict().items()
             if not is_scale(k)}
    cfg16 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="bfloat16", int8_neck=False))
    p16 = Predictor(cfg16, state, device=DEVICE)
    p16.warmup(32)
    times = {"int8": [], "bfloat16": []}
    for i in range(10):
        for name, p in (("int8", pred), ("bfloat16", p16)):
            t0 = time.perf_counter()
            p.predict(batches[i % len(batches)])
            times[name].append((time.perf_counter() - t0) * 1e3)
    with torch.inference_mode():
        raw_u8 = torch.from_numpy(batches[0]).to(DEVICE)
        packed_maps, raw_maps = det.model(feed), det.model(raw_u8)
        feeds_equal = all(torch.equal(a, b) for pa, pb in zip(
            packed_maps, raw_maps) for a, b in zip(pa, pb))
        fwd = {"int8": cuda_ms(lambda: det.model(feed), iters=5),
               "bfloat16": cuda_ms(lambda: p16.detector.model(feed), iters=5)}
        del packed_maps, raw_maps

        conv = det.model.head.class_net.predict
        fh, fw = cfg.feature_map_sizes()[0]
        x = torch.randn(32, conv.weight.shape[1], fh, fw, device=DEVICE,
                        dtype=torch.bfloat16).contiguous(
                            memory_format=torch.channels_last)
        a_scale = conv.act_scale(x)
        x_q = quantize_activation(x, a_scale)
        k_q, k_scale = quantize_weight(conv.weight)
        cols = im2col_padded(x_q, 3, 3, 1, (1, 1, 1, 1), (fh, fw))
        cols2d = cols.reshape(-1, cols.shape[-1])
        w2d = k_q.permute(0, 2, 3, 1).reshape(k_q.shape[0], -1)
        y = int_mm(cols2d, w2d)
        scale = a_scale * k_scale
        w16 = conv.weight.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        parts = {
            "quantize": cuda_ms(lambda: quantize_activation(x, a_scale), 10),
            "weights": cuda_ms(lambda: quantize_weight(conv.weight), 10),
            "im2col": cuda_ms(lambda: im2col_padded(
                x_q, 3, 3, 1, (1, 1, 1, 1), (fh, fw)), 10),
            "gemm": cuda_ms(lambda: int_mm(cols2d, w2d), 10),
            "dequantize": cuda_ms(lambda: dequantize(y, scale, conv.bias), 10),
            "whole": cuda_ms(lambda: conv(x), 10),
            "bf16_conv2d": cuda_ms(lambda: torch.nn.functional.conv2d(
                x, w16, conv.bias.to(torch.bfloat16), padding=1), 10)}
    if not feeds_equal:
        raise AssertionError("int8 packed and raw feeds' maps differ")
    p50 = {k: float(np.median(v)) for k, v in times.items()}
    return {"in_turns_with_bf16": {
                "batch_ms": times, "p50_batch_ms": p50,
                "img_per_s": {k: 32 / v * 1e3 for k, v in p50.items()},
                "model_device_ms": fwd, "note": "same weights, batches in "
                "turns, one process, on " + power_line},
            "packed_raw_maps_bit_equal": feeds_equal,
            "p3_class_predict_ms": parts,
            "p3_class_predict_shape": {"M": cols2d.shape[0],
                                       "K": cols2d.shape[1],
                                       "N": w2d.shape[0]}}


def phase_serve(phase: str, config: str, power_line: str,
                int8: bool = False, batch: int = 32,
                cfg: Config | None = None) -> int:
    """A full-width config served through ``Predictor.predict``: 10 batches
    of ``batch``, a mixed-size list and a letterboxed request, with the NMS
    launches of that run counted; returns them. ``cfg``: that config
    changed (another selection path); ``config`` names its file. ``int8``:
    the config in int8 with ``int8_neck``, calibrated first
    (``calibrate_flagship``), with ``int8_checks`` after. The kernel is
    held against the plain ``batched_nms`` on the candidates of the path
    the detector serves (``Detector.candidates``)."""
    cfg = Config.load(config) if cfg is None else cfg
    assert cfg.model.compute_dtype == "bfloat16"
    assert cfg.nms.method == "hard"
    if int8:
        cfg = int8_config(cfg)
    flagship_int8 = int8 and cfg.model.backbone == "mobilenet"
    pred = Predictor(cfg, None, device=DEVICE)  # weights seeded from 0
    with torch.no_grad():
        pred.detector.model.head.class_net.predict.bias.fill_(
            FLAGSHIP_CLASS_BIAS)
    extra = {}
    if flagship_int8:
        extra = calibrate_flagship(pred, cfg)
    elif int8:  # M9b: every conv on calibrated scales
        extra = {"calibration": {
            "batch": 8, "absmax_s": bench_serve.calibrate_seeded(pred),
            "scales": len(_scales(pred.detector.model))}}
    rng = np.random.default_rng(1)
    h, w = cfg.image_hw()
    batches = [rng.integers(0, 256, (batch, h, w, 3), dtype=np.uint8)
               for _ in range(3)]
    mixed = [rng.integers(0, 256, s + (3,), dtype=np.uint8)
             for s in ((480, 640), (333, 517), (700, 1000))]
    pred.warmup(batch)
    pred.predict(mixed)
    torch.cuda.synchronize()

    # ---- the main path, counted
    torch.cuda.reset_peak_memory_stats()
    nms_cuda.launches = conv_s8_cuda.launches = 0
    batch_ms = []
    for i in range(10):
        t0 = time.perf_counter()
        out = pred.predict(batches[i % len(batches)])
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        _check_output(out, batch, cfg.nms.max_boxes)
    out_mixed = pred.predict(mixed)
    _check_output(out_mixed, 3, cfg.nms.max_boxes)
    pred.preserve_aspect = True
    out_box = pred.predict(mixed[2])
    pred.preserve_aspect = False
    launches, k4 = nms_cuda.launches, conv_s8_cuda.launches
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    assert out_box["boxes"].shape == (cfg.nms.max_boxes, 4)
    if launches != 12:
        raise AssertionError(f"{launches} NMS launches, want one per request")
    extra.update(k4_count(pred.detector, batches[0][:1], k4, launches,
                          phase))

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

    # ---- kernel path vs plain batched_nms on one batch's candidates, as
    # this detector selects them
    det = pred.detector
    trunk_only = cfg.model.head_final_kernel == 1
    with torch.inference_mode():
        boxes, scores = det.candidates(feed)
        a = nms_cuda.batched_nms_cuda(boxes, scores, cfg.nms)
        b = nms.batched_nms(boxes, scores, cfg.nms)
        top_scores, _ = nms.class_topk(scores, cfg.nms)
    assert torch.equal(a.num_boxes, b.num_boxes)
    assert torch.equal(a.labels, b.labels)
    assert float((a.scores - b.scores).abs().max()) <= 1e-6
    assert float((a.boxes - b.boxes).abs().max()) <= 1e-6
    live = int((top_scores[..., 0] > 0).sum())
    valid = int((top_scores > 0).sum())

    # ---- where one batch's device time goes (CUDA events, warm): the
    # forward (to the trunks for the fused head), the rest of selection,
    # NMS
    with torch.inference_mode():
        fwd = cuda_ms(lambda: det.model(feed, trunk_only=trunk_only),
                      iters=5)
        sel = cuda_ms(lambda: det.candidates(feed), iters=5) - fwd
        post = cuda_ms(lambda: nms_cuda.batched_nms_cuda(
            boxes, scores, cfg.nms), iters=5)

    if flagship_int8:
        extra.update(int8_checks(pred, cfg, batches, feed, power_line))
    extra["host_attribution"] = host_attribution(pred, batches[0])
    p50 = float(np.median(batch_ms))
    MEASURED[phase] = fwd + sel + post
    emit({"phase": phase, "config": os.path.relpath(config, ROOT),
          "backbone": cfg.model.backbone, "norm": cfg.model.norm,
          "stem_schedule": cfg.model.stem_schedule,
          "select": ("fused head" if trunk_only else cfg.nms.select),
          "head_final_kernel": cfg.model.head_final_kernel,
          "feed": "packed s8" if pred._packed else "raw uint8",
          "dtype": cfg.model.compute_dtype,
          "int8_neck": cfg.model.int8_neck, "batch": batch, "image": [h, w],
          "anchors": cfg.num_anchors(), "weights": "seeded (seed 0)",
          "class_bias": FLAGSHIP_CLASS_BIAS,
          "live_problems": live, "problems": batch * cfg.num_classes,
          "valid_candidates": valid, "num_boxes_mean":
              float(np.mean(out["num_boxes"])),
          "nms_launches": launches, "kernel_vs_plain_equal": True,
          "batch_ms": batch_ms, "p50_batch_ms": p50,
          "img_per_s": batch / p50 * 1e3,
          "device_ms": {"model": fwd, "select": sel, "nms": post},
          "host_ms": {"feed": feed_ms, "to_device": h2d_ms},
          "peak_mem_gib": peak_gb, **extra,
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


# ------------------------------------------------------------------ M9: the other backbones and paths

def _grad_norm(det: Detector) -> float:
    return float(torch.sqrt(sum(p.grad.double().square().sum()
                                for p in det.model.parameters())))


def phase_backbones_golden() -> tuple[int, int]:
    """``assets/backbones_golden_v1.npz`` on the card in f32: each case's
    seeded weights (``convert.seeded_state``), its raw maps at the golden
    bars, its detections under the golden set rule, its step-0 loss terms
    within 1e-4 of JAX's, and its gradient norm within 2e-3 of JAX's
    float64 truth (JAX's f32 model run in f64) and within 2e-3 plus JAX's
    own distance from that truth of JAX's
    (``tests/test_torch_backbones_golden.py``). Returns the NMS and
    matching launches."""
    with np.load(BACKBONES_GOLDEN) as z:
        arrays = {k: z[k] for k in z.files}
    data = {k[len("batch/"):]: v for k, v in arrays.items()
            if k.startswith("batch/")}
    names = sorted({k.split("/")[0] for k in arrays} - {"batch"})
    nms_cuda.launches = matching_cuda.launches = 0
    rows = {}
    for name in names:
        case = {k[len(name) + 1:]: v for k, v in arrays.items()
                if k.startswith(name + "/")}
        cfg = Config.from_json(str(case["config_json"]))
        det = Detector(cfg, seeded_state(cfg, int(case["seed"]),
                                         float(case["class_bias"])),
                       device=DEVICE)
        raw = det.raw(data["images"])
        raw_err = 0.0
        for i, maps in enumerate(raw):
            for part, got in zip(("cls", "box"), maps):
                want = case[f"raw/{i}/{part}"]
                got = got.float().cpu().numpy()
                raw_err = max(raw_err, float(np.abs(got - want).max()))
                if not np.allclose(got, want, **GOLDEN_BARS):
                    raise AssertionError(f"{name} P{i + 3} {part}: raw maps "
                                         f"off JAX's by {raw_err}")
        out = det.predict(data["images"])
        got = {k: getattr(out, k).cpu().numpy() for k in DET_KEYS}
        want = {k: case[f"det/{k}"] for k in DET_KEYS}
        matched, total = set_match(got, want)
        nb_equal = bool((got["num_boxes"] == want["num_boxes"]).all())
        if matched != total or not nb_equal or total == 0:
            raise AssertionError(f"{name}: detections {matched}/{total}")
        total_loss, metrics = det.loss(data)
        total_loss.backward()
        loss_dev = {k: abs(float(metrics[k]) / float(case[f"loss/{k}"]) - 1)
                    for k in ("loss", "classification_loss",
                              "localization_loss", "regularization_loss",
                              "num_positives")}
        if max(loss_dev.values()) > LOSS_RTOL:
            raise AssertionError(f"{name}: loss terms off JAX's {loss_dev}")
        norm = _grad_norm(det)
        truth, jax_norm = float(case["grad_norm_f64"]), float(
            case["grad_norm"])
        gn = {"port": norm, "jax": jax_norm, "f64": truth,
              "rel_to_f64": abs(norm / truth - 1),
              "rel_to_jax": abs(norm / jax_norm - 1),
              "jax_bar": GRAD_NORM_RTOL + abs(jax_norm / truth - 1)}
        if (gn["rel_to_f64"] > GRAD_NORM_RTOL
                or gn["rel_to_jax"] > gn["jax_bar"]):
            raise AssertionError(f"{name}: gradient norm {gn}")
        rows[name] = {"backbone": cfg.model.backbone, "norm": cfg.model.norm,
                      "raw_max_abs_err": raw_err, "matched": matched,
                      "total": total, "loss_rel_dev": loss_dev,
                      "grad_norm": gn}
        del det, raw, out, total_loss
    launches = (nms_cuda.launches, matching_cuda.launches)
    emit({"phase": "backbones_golden", "image": [128, 128],
          "dtype": "float32", "cases": rows, "nms_launches": launches[0],
          "match_launches": launches[1]})
    if launches != (len(names), len(names)):
        raise AssertionError(f"launches {launches} for {len(names)} cases")
    return launches


def _flagship_with(**nms_or_model) -> Config:
    cfg = Config.load(FLAGSHIP)
    model = {k: v for k, v in nms_or_model.items()
             if hasattr(cfg.model, k)}
    nms_kw = {k: v for k, v in nms_or_model.items() if k not in model}
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **model),
        nms=dataclasses.replace(cfg.nms, **nms_kw))


def _hold_k1(boxes, scores, cfg: Config, what: str) -> None:
    a = nms_cuda.batched_nms_cuda(boxes, scores, cfg.nms)
    b = nms.batched_nms(boxes, scores, cfg.nms)
    if not (torch.equal(a.num_boxes, b.num_boxes)
            and torch.equal(a.labels, b.labels)
            and float((a.scores - b.scores).abs().max()) <= 1e-6
            and float((a.boxes - b.boxes).abs().max()) <= 1e-6):
        raise AssertionError(f"{what}: kernel and plain NMS differ")


def phase_select_paths(power_line: str) -> dict:
    """The flagship at full width on its other paths: ``select="anchors"``
    and the fused 1x1 head (``head_final_kernel=1``) served through
    ``Predictor.predict`` (``phase_serve``); the pyramid selection
    (``postprocess_pyramid`` on the model's maps); Soft-NMS, linear and
    gaussian, through ``Predictor.predict`` with no K1 launch, its time
    beside K1's on the same candidates and its card result equal to the
    CPU's on two images. Also the fused head's ``fused_logit_max`` beside
    the cuDNN class ``predict`` conv it replaces. Returns the NMS launches
    by path."""
    launches = {
        "select_anchors": phase_serve("select_anchors", FLAGSHIP, power_line,
                                      cfg=_flagship_with(select="anchors")),
        "fused_head": phase_serve("fused_head", FLAGSHIP, power_line,
                                  cfg=_flagship_with(head_final_kernel=1))}

    cfg = Config.load(FLAGSHIP)
    h, w = cfg.image_hw()
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, 256, (32, h, w, 3), dtype=np.uint8)
               for _ in range(2)]
    det = Detector(cfg, device=DEVICE)
    with torch.no_grad():
        det.model.head.class_net.predict.bias.fill_(FLAGSHIP_CLASS_BIAS)
    feed = det.as_input(batches[0])
    row = {"phase": "select_paths"}
    with torch.inference_mode():
        raw = det.raw(feed)
        postprocess_pyramid(raw, det.anchors, cfg.num_classes, cfg.nms)
        torch.cuda.synchronize()
        nms_cuda.launches = 0
        for i in range(4):
            out = postprocess_pyramid(det.raw(batches[i % 2]), det.anchors,
                                      cfg.num_classes, cfg.nms)
            _check_output({k: getattr(out, k).cpu().numpy()
                           for k in DET_KEYS}, 32, cfg.nms.max_boxes)
        launches["select_pyramid"] = nms_cuda.launches
        boxes, scores = select_candidates_pyramid(raw, det.anchors,
                                                  cfg.num_classes, cfg.nms)
        _hold_k1(boxes, scores, cfg, "pyramid")
        row["pyramid"] = {
            "batches": 4, "nms_launches": launches["select_pyramid"],
            "kernel_vs_plain_equal": True,
            "select_ms": cuda_ms(lambda: select_candidates_pyramid(
                raw, det.anchors, cfg.num_classes, cfg.nms), iters=5),
            "cells_select_ms": cuda_ms(lambda: select_candidates_cells(
                raw, det.anchors, cfg.num_classes, cfg.nms), iters=5)}

        # the class predict conv (cuDNN, 3x3 over each level's trunk) and
        # the fused head's product + max over the same trunks with a 1x1
        # kernel of its shape (the trunks' math is the same either way)
        m = det.model
        pyramid = m.fpn(m.backbone(m.backbone_input(feed),
                                   torch.bfloat16))
        trunks = [m.head.class_net.trunk(p) for p in pyramid]
        cls_trunk, _ = m.head.trunks(pyramid)
        k = cfg.anchors.num_anchors_per_cell
        fused_det = Detector(_flagship_with(head_final_kernel=1),
                             device=DEVICE)
        w_cls, b_cls, _, _ = predict_params(fused_det.model.head)
        conv = m.head.class_net.predict
        row["fused_logit_max"] = {
            "cells": cls_trunk.shape[1], "channels": cls_trunk.shape[2],
            "ms": cuda_ms(lambda: fused_logit_max(cls_trunk, w_cls, b_cls,
                                                  k), iters=5),
            "cudnn_class_predict_3x3_ms": cuda_ms(
                lambda: [conv(t) for t in trunks], iters=5),
            "cudnn_class_predict_3x3_and_cell_max_ms": cuda_ms(
                lambda: [conv(t).amax(dim=1) for t in trunks], iters=5)}
        del fused_det, pyramid, trunks, cls_trunk

    soft = {}
    for method in ("soft_linear", "soft_gaussian"):
        scfg = _flagship_with(method=method)
        pred = Predictor(scfg, None, device=DEVICE)
        with torch.no_grad():
            pred.detector.model.head.class_net.predict.bias.fill_(
                FLAGSHIP_CLASS_BIAS)
        pred.warmup(32)
        torch.cuda.synchronize()
        nms_cuda.launches = 0
        batch_ms = []
        for i in range(3):
            t0 = time.perf_counter()
            out = pred.predict(batches[i % 2])
            batch_ms.append((time.perf_counter() - t0) * 1e3)
            _check_output(out, 32, scfg.nms.max_boxes)
        if nms_cuda.launches:
            raise AssertionError(f"{method}: {nms_cuda.launches} K1 launches")
        sdet = pred.detector
        with torch.inference_mode():
            boxes, scores = sdet.candidates(sdet.as_input(batches[0]))
            soft_ms = cuda_ms(lambda: run_nms(boxes, scores, scfg.nms),
                              iters=3, warmup=1)
            hard_ms = cuda_ms(lambda: nms_cuda.batched_nms_cuda(
                boxes, scores, cfg.nms), iters=5)
            # the seeded model's scores are near-ties (a constant class
            # bias), where an ulp of exp moves a pivot: reported only
            served = [{k: getattr(d, k).cpu().numpy() for k in DET_KEYS}
                      for d in (run_nms(boxes[:2], scores[:2], scfg.nms),
                                run_nms(boxes[:2].cpu(), scores[:2].cpu(),
                                        scfg.nms))]
            # held: tie-free scores on clustered boxes, the card against
            # the CPU
            tb, ts = kernel_cases.clustered_problem(
                np.random.default_rng(9), 2, 1024, cfg.num_classes)
            on_card = run_nms(torch.from_numpy(tb).to(DEVICE),
                              torch.from_numpy(ts).to(DEVICE), scfg.nms)
            on_cpu = run_nms(torch.from_numpy(tb), torch.from_numpy(ts),
                             scfg.nms)
        err = {"scores": float((on_card.scores.cpu() - on_cpu.scores).abs()
                               .max()),
               "boxes": float((on_card.boxes.cpu() - on_cpu.boxes).abs()
                              .max())}
        if not (torch.equal(on_card.num_boxes.cpu(), on_cpu.num_boxes)
                and torch.equal(on_card.labels.cpu(), on_cpu.labels)
                and err["scores"] <= 1e-5 and err["boxes"] <= 1e-6):
            raise AssertionError(f"{method}: the card's result differs from "
                                 f"the CPU's on tie-free inputs: {err}")
        matched, total = set_match(*served)
        soft[method] = {"nms_launches": 0, "batch_ms": batch_ms,
                        "p50_batch_ms": float(np.median(batch_ms)),
                        "soft_nms_ms": soft_ms, "k1_hard_nms_ms": hard_ms,
                        "num_boxes_mean": float(np.mean(out["num_boxes"])),
                        "card_vs_cpu_tie_free": {
                            "num_boxes": on_cpu.num_boxes.tolist(),
                            "max_abs_err": err},
                        "served_2_images_card_vs_cpu_matched": [matched,
                                                                total]}
        del pred, sdet
    row["soft_nms"] = soft
    row["nms_launches"] = launches
    row["note"] = "flagship config, seeded weights, class bias " \
        f"{FLAGSHIP_CLASS_BIAS}, b32/640 bf16, on {power_line}"
    emit(row)
    if launches["select_pyramid"] != 4:
        raise AssertionError(f"pyramid: {launches['select_pyramid']} NMS "
                             "launches, want 4")
    return launches


# ------------------------------------------------------------------ serving host path

SPANS = ("feed", "copy", "launch", "readback")


def host_attribution(pred: Predictor, batch: np.ndarray) -> dict:
    """One warm ``predict`` of ``batch`` under ``torch.profiler``: the host
    time of each of its spans (feed: resize and pack into the staging
    buffer; copy: the host-to-device copy issued; launch: the model,
    postprocess and the readback copies enqueued; readback: the wait on the
    batch's event and the numpy views), the rest of the call's wall time,
    the host time inside CUDA runtime calls by name, and the count and
    device time of its kernels and copies, and each stream or device
    synchronization with the ops it ran under. Fails if one ran under the
    dispatch's spans (a host copy to the card from pageable memory, a
    scalar read back): dispatch would wait for the card; and if the staging
    buffer's wait for its last upload took ``STAGING_WAIT_BAR_MS``."""
    pred.predict(batch)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pred.predict(batch)
        wall = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    summary = profiling.summarize(prof, "predict.")
    spans = {k: summary["host_ms"].get(f"predict.{k}", 0.0) for k in SPANS}
    if not all(spans.values()):
        raise AssertionError(f"profiler spans missing: {spans}")
    # dispatch must return without waiting for the card: the only wait of a
    # predict is collect's, on its readback event
    stalls = profiling.syncs_under(summary, tuple(
        f"predict.{k}" for k in ("feed", "copy", "launch")))
    if stalls:
        raise AssertionError(f"predict_dispatch waited for the card: {stalls}")
    staging_ms = sum(w["ms"] for w in profiling.staging_waits(summary))
    if staging_ms > STAGING_WAIT_BAR_MS:
        raise AssertionError(f"staging waited {staging_ms} ms")
    runtime = collections.Counter(summary["cuda_runtime_ms"])
    device = summary["device_busy_ms"]
    return {"wall_ms": wall, "host_ms": spans, "syncs": summary["syncs"],
            "staging_wait_ms": staging_ms,
            "host_other_ms": wall - sum(spans.values()),
            "cuda_runtime_calls_ms": sum(runtime.values()),
            "cuda_runtime_top": {
                k: {"ms": v, "calls": summary["cuda_runtime_calls"][k]}
                for k, v in runtime.most_common(4)},
            "device_ops": summary["device_ops"],
            "device_busy_ms": device,
            "device_idle_share": max(0.0, 1.0 - device / wall),
            "profiler_saw_device": device > 0}


def _best_ms(fn, reps: int = 3) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def phase_host_ingest(power_line: str) -> None:
    """The native host library on this machine: built with the host
    compiler, its pack bit-equal to the numpy version on the flagship's
    b32/640 batch, its resize within one unit of the numpy version on a
    mixed-size set, both timed beside the numpy versions; which JPEG
    decoders exist, and their decode time on the 640 px request bodies."""
    t0 = time.perf_counter()
    native.library()
    build_s = time.perf_counter() - t0
    cfg = Config.load(FLAGSHIP)
    h, w = cfg.image_hw()
    images = np.random.default_rng(1).integers(0, 256, (32, h, w, 3),
                                               dtype=np.uint8)
    want = ingest.pack_s2d(images)
    got = native.pack_s2d(images)
    if not np.array_equal(got, want):
        raise AssertionError("native pack_s2d differs from the numpy one")
    threads = os.cpu_count() or 1
    pack = {"numpy_ms": _best_ms(lambda: ingest.pack_s2d(images)),
            "native_ms_4_threads": _best_ms(lambda: native.pack_s2d(
                images, n_threads=4), 5),
            f"native_ms_{threads}_threads": _best_ms(lambda: native.pack_s2d(
                images, n_threads=threads), 5),
            "bytes_in": images.nbytes, "bit_equal": True}
    rng = np.random.default_rng(2)
    resize = {"max_unit_diff": 0, "numpy_ms": 0.0, "native_ms": 0.0}
    for hw in ((480, 640), (333, 517), (700, 1000), (1080, 1920), (640, 640),
               (200, 300)):
        im = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
        a = native.resize(im, h, w)
        b = plain_resize(im, h, w)
        resize["max_unit_diff"] = max(resize["max_unit_diff"], int(
            np.abs(a.astype(np.int16) - b).max()))
        resize["numpy_ms"] += _best_ms(lambda: plain_resize(im, h, w))
        resize["native_ms"] += _best_ms(lambda: native.resize(im, h, w))
    if resize["max_unit_diff"] > 1:
        raise AssertionError(f"native resize off the numpy one by "
                             f"{resize['max_unit_diff']}")
    decoders = native.decoders()
    decode = None
    if decoders["native_libjpeg"] or decoders["pil"]:
        bodies, source = bench_http.request_bodies(w)
        decode = {"bodies": source, "images": len(bodies),
                  "ms_per_image": _best_ms(lambda: [
                      native.decode_jpeg(d, h, w) for d in bodies])
                  / len(bodies),
                  "path": "native libjpeg" if decoders["native_libjpeg"]
                  else "PIL (DCT scale) + native resize"}
    emit({"phase": "host_ingest", "build_s": build_s,
          "compiler": _build.host_compiler(), "cpu_count": threads,
          "pack_b32_640": pack, "resize_6_images_to_640": resize,
          "decoders": decoders, "decode_640": decode,
          "libjpeg_found": decoders["native_libjpeg"],
          "note": "host times on the card's machine, " + power_line})


def post_json(port: int, body: bytes) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/detect?score_threshold=0", data=body,
        method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


# the daemon's JSON rounds to 4 decimals: half a unit, and a little
JSON_TOL = 1.01e-4


def _equal_results(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


def phase_serve_golden() -> int:
    """The sanity artifact in f32 served by ``DetectionServer`` on the card
    (``assets/serve_golden_v1.npz``): decoded here, the 16 JPEGs against
    the pixels JAX's native decode gave; over HTTP on 127.0.0.1 (or, with
    no JPEG decoder on this machine, through the request queue with the
    stored pixels) the daemon's detections against the port's direct
    ``predict`` of the same pixels, and, where the pixels are equal, JAX's
    stored detections under the golden rule; then with ``scan_depth=4``
    the grouped results against per-batch predicts. Returns the NMS
    launches of the daemon's runs."""
    with np.load(SERVE_GOLDEN, allow_pickle=False) as z:
        jpegs = bench_http.unpack_blobs(z["golden_jpeg_blob"],
                                        z["golden_jpeg_offsets"])
        stored = z["golden_pixels"]
        stored_version = {k: int(z[k]) for k in (
            "jpeg_lib_version", "libjpeg_turbo_version_number")}
        want = {k: z[f"jax_f32_{k}"] for k in DET_KEYS}
    cfg, state = load_npz_artifact(ASSET)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32"))
    pred = Predictor(cfg, state, device=DEVICE)
    h, w = cfg.image_hw()
    decoders = native.decoders()
    http = bool(decoders["native_libjpeg"] or decoders["pil"])
    srv = DetectionServer(pred, host="127.0.0.1", port=0, max_batch=8,
                          max_wait_ms=20.0, default_score_threshold=0.0)
    srv.warmup()
    srv.start()
    try:
        if http:
            pixels = np.stack([native.decode_jpeg(d, h, w) for d in jpegs])
            nms_cuda.launches = 0
            with ThreadPoolExecutor(len(jpegs)) as ex:
                rows = [r["detections"] for r in ex.map(
                    lambda b: post_json(srv.port, b), jpegs)]
        else:
            emit({"phase": "serve_golden", "decoder": "none",
                  "note": "this machine has no JPEG decoder (no libjpeg "
                          "in the host library, no PIL): the daemon is "
                          "driven through its request queue with the "
                          "stored pixels, the path right after _decode; "
                          "this is not HTTP"})
            pixels = stored
            nms_cuda.launches = 0
            futs = [srv.submit(srv._prepare(p)) for p in pixels]
            rows = [detection_rows(f.result(timeout=120), 0.0)
                    for f in futs]
        launches = nms_cuda.launches
        batches = srv.stats.batches
    finally:
        srv.stop()
    if launches != batches or batches >= len(jpegs):
        raise AssertionError(f"{launches} NMS launches for {batches} daemon "
                             f"batches of {len(jpegs)} requests")
    pixels_equal = [bool(np.array_equal(a, b)) for a, b in zip(pixels, stored)]
    got = detections_arrays(rows, cfg.nms.max_boxes)

    # the port's direct predict of the same pixels, through the same JSON
    out = pred.predict(pixels)
    direct = detections_arrays([detection_rows(
        {k: v[i] for k, v in out.items()}, 0.0)
        for i in range(len(pixels))], cfg.nms.max_boxes)
    m_direct, t_direct = set_match(got, direct, score_tol=JSON_TOL,
                                   box_tol=JSON_TOL)
    if (m_direct != t_direct or t_direct == 0
            or not np.array_equal(got["num_boxes"], direct["num_boxes"])):
        raise AssertionError(f"daemon vs direct predict: {m_direct}/"
                             f"{t_direct}")
    row = {"phase": "serve_golden", "images": len(jpegs),
           "path": "HTTP on 127.0.0.1" if http
           else "request queue (no JPEG decoder)",
           "decoders": decoders, "stored_pixels_libjpeg": stored_version,
           "pixels_equal_stored": sum(pixels_equal),
           "daemon_batches": batches, "nms_launches": launches,
           "daemon_vs_direct_matched": m_direct,
           "daemon_vs_direct_total": t_direct}
    if all(pixels_equal):
        m, t = set_match(got, want)
        nb_equal = bool(np.array_equal(got["num_boxes"], want["num_boxes"]))
        row.update(jax_matched=m, jax_total=t, jax_num_boxes_equal=nb_equal)
        if m != t or not nb_equal:
            raise AssertionError(f"daemon vs JAX's stored detections: "
                                 f"{m}/{t}")
    else:
        row["jax_check"] = ("skipped: this machine decodes "
                            f"{len(jpegs) - sum(pixels_equal)} of the JPEGs "
                            "to other pixels than the stored ones")

    # grouped dispatch: 16 requests queued before the dispatcher starts form
    # four batches of 4, grouped under one handle
    srv4 = DetectionServer(pred, host="127.0.0.1", port=0, max_batch=4,
                           max_wait_ms=0.0, default_score_threshold=0.0,
                           scan_depth=4)
    srv4.warmup()
    groups = []
    dispatch_group = pred.predict_dispatch_group
    pred.predict_dispatch_group = lambda b: (groups.append(len(b)),
                                            dispatch_group(b))[1]
    try:
        futs = [srv4.submit(srv4._prepare(p)) for p in pixels]
        nms_cuda.launches = 0
        srv4.dispatcher.start()
        grouped = [f.result(timeout=120) for f in futs]
        launches4 = nms_cuda.launches
    finally:
        del pred.predict_dispatch_group
        srv4.dispatcher.stop()
        srv4.dispatcher.join(timeout=30)
        srv4.httpd.server_close()
    per_batch = [pred.predict(pixels[i:i + 4]) for i in range(0, 16, 4)]
    equal = all(_equal_results(g, {k: v[i % 4] for k, v in
                                   per_batch[i // 4].items()})
                for i, g in enumerate(grouped))
    row.update(scan_depth=4, groups=groups, group_nms_launches=launches4,
               grouped_equal_per_batch=equal)
    emit(row)
    if groups != [4] or launches4 != 4 or not equal:
        raise AssertionError(f"grouped dispatch: groups {groups}, "
                             f"{launches4} launches, equal {equal}")
    return launches + launches4


def phase_serve_pipelined(power_line: str) -> int:
    """The flagship at full width, bf16 then int8 (``int8_neck``, calibrated
    by ``bench_serve.calibrate_seeded``), b32/640: 10 batches dispatched
    two deep against serial ``predict`` of the same batches; the
    ``bench_serve`` protocol (50 batches queued, collected once) with the
    pinned staging copy and with pageable memory, in turns; ``bench_http``
    with 64 clients x 20 requests and ``max_batch`` 32; the peak memory
    with a ``scan_depth=4`` daemon's groups; one batch's host time by span
    (``host_attribution``). Returns the NMS launches of the counted runs."""
    base = Config.load(FLAGSHIP)
    h, w = base.image_hw()
    rng = np.random.default_rng(11)
    batches = [rng.integers(0, 256, (32, h, w, 3), dtype=np.uint8)
               for _ in range(4)]
    bodies, source = bench_http.request_bodies(w)
    total = 0
    for dtype in ("bfloat16", "int8"):
        cfg = int8_config(base) if dtype == "int8" else base
        pred = Predictor(cfg, None, device=DEVICE)  # weights seeded from 0
        with torch.no_grad():
            pred.detector.model.head.class_net.predict.bias.fill_(
                FLAGSHIP_CLASS_BIAS)
        cal_s = bench_serve.calibrate_seeded(pred) if dtype == "int8" \
            else None
        pred.warmup(32)
        serial = [pred.predict(b) for b in batches]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # ---- the main path, counted: pipelined, bench_serve, bench_http
        nms_cuda.launches = conv_s8_cuda.launches = 0
        handles, piped = collections.deque(), []
        for i in range(10):
            handles.append(pred.predict_dispatch(batches[i % 4]))
            if len(handles) == 2:
                piped.append(pred.predict_collect(handles.popleft()))
        piped += [pred.predict_collect(hd) for hd in handles]
        launches_piped = nms_cuda.launches
        mixed = [i for i, o in enumerate(piped)
                 if not _equal_results(o, serial[i % 4])]
        bench = []
        for pinned in (True, False, False, True):
            pred._pinned = pinned
            r = bench_serve.run(pred, batches, iters=50, warmup=2)
            bench.append({"copy": "pinned" if pinned else "pageable", **r})
        pred._pinned = True
        launches_bench = nms_cuda.launches - launches_piped
        srv = DetectionServer(pred, host="127.0.0.1", port=0, max_batch=32,
                              max_wait_ms=5.0, default_score_threshold=0.3)
        srv.warmup()
        srv.start()
        try:
            before = nms_cuda.launches
            http = bench_http.run(srv, bodies, 64, 20)
            launches_http = nms_cuda.launches - before
        finally:
            srv.stop()
        launches, k4 = nms_cuda.launches, conv_s8_cuda.launches
        k4 = k4_count(pred.detector, batches[0][:1], k4, launches,
                      f"serve_pipelined {dtype}")
        srv4 = DetectionServer(pred, host="127.0.0.1", port=0, max_batch=32,
                               scan_depth=4)
        srv4.warmup()  # groups of 2, 3 and 4 batches of 32
        srv4.httpd.server_close()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        attribution = host_attribution(pred, batches[0])
        total += launches

        def summary(copy):
            runs = [b for b in bench if b["copy"] == copy]
            return {"img_per_s": [b["img_per_s"] for b in runs],
                    "batch_ms_p50": [b["batch_ms"]["p50"] for b in runs],
                    "batch_ms_p99": [b["batch_ms"]["p99"] for b in runs]}
        emit({"phase": "serve_pipelined", "dtype": dtype,
              "config": os.path.relpath(FLAGSHIP, ROOT), "batch": 32,
              "image": [h, w], "calibration_s": cal_s,
              "pipelined_batches": len(piped), "pipeline_depth": 2,
              "pipelined_equal_serial": not mixed, "mixed_batches": mixed,
              "nms_launches": {"pipelined": launches_piped,
                               "bench_serve": launches_bench,
                               "bench_http": launches_http}, **k4,
              "bench_serve": bench, "pinned": summary("pinned"),
              "pageable": summary("pageable"),
              "bench_http": {"bodies": source, **http},
              "peak_mem_gib_with_scan_depth_4": peak_gib,
              "host_attribution": attribution,
              "note": "unoptimised eager bring-up reading on " + power_line})
        if mixed:
            raise AssertionError(f"pipelined batches {mixed} differ from "
                                 "serial predict")
        if launches_piped != 10 or launches_bench != 4 * 52:
            raise AssertionError(f"NMS launches {launches_piped} pipelined, "
                                 f"{launches_bench} in bench_serve")
        if http["failed"] or launches_http != http["batches"]:
            raise AssertionError(f"bench_http: {http['failed']} failed "
                                 f"({http['first_failure']}), "
                                 f"{launches_http} launches for "
                                 f"{http['batches']} batches")
        del pred, srv, srv4
        torch.cuda.empty_cache()
    return total


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


def phase_conv_s8(power_line: str) -> dict:
    """K4 through ``tools/bench_conv_s8.main`` on the benchmark cell's
    configuration, with every shipped config's forward checked (module
    docstring); returns its result."""
    out = bench_conv_s8.main(
        ["--config", os.path.join(ROOT, "bench_port", "configs",
                                  "ssd_mnv1_fpn_640.json"), "--models"],
        emit=lambda row: emit({**row, "phase": "conv_s8." + row["phase"]}))
    emit({"phase": "conv_s8", "nvidia_smi": power_line,
          "forward_k4_ms": out["summary"]["forward_k4_ms"],
          "launches": out["counts"]["launches"]})
    return out


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
                         timed: int = 10, config: str = FLAGSHIP,
                         phase: str = "train_flagship"
                         ) -> tuple[int, float]:
    """``warmup + timed + 1`` steps of ``config`` (as shipped: its batch and
    accumulation, full width and depth) through
    ``train()``: a step is timed from its batch being ready to the next
    batch being asked for (its metrics read back in between), so the last
    step, followed by the loop's checkpoint and export, is run but not
    timed."""
    cfg = Config.load(config)
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
        # the stages of one microbatch's step (the whole batch at 1)
        micro = cfg.train.batch_size // accum
        breakdown = train_step_breakdown(det, cfg, {
            k: v[:micro] for k, v in b.items()})
        del det

        # the export serves
        pred = Predictor.from_checkpoint(os.path.join(workdir, EXPORT_NAME),
                                         device=DEVICE)
        served = b["images"][:8]
        out = pred.predict(served)
        _check_output(out, len(served), cfg.nms.max_boxes)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    timed_ms = step_ms[warmup:warmup + timed]
    p50 = float(np.median(timed_ms))
    emit({"phase": phase, "config": os.path.relpath(config, ROOT),
          "backbone": cfg.model.backbone,
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
    return launches, p50


# ------------------------------------------------------------------ training pipeline

PIPE_STEPS = 24  # 512, 640, 768 in turns of 4 steps (multiscale_every 4)
PIPE_TEACHER_STEPS = 3
PIPE_TRAIN_EXAMPLES, PIPE_TRAIN_SHARDS = 256, 4
PIPE_VAL_EXAMPLES = 64
PIPE_SIZES = [(480, 640), (640, 640), (600, 800)]
PIPE_SEED = 21
PIPE_TIMEOUT_S = 600
PROFILE_AT = PROFILE_START + 1  # the logged step the profiler records


def write_pipeline_dataset(root: str) -> dict:
    """The crowded train and val scenes as PIL JPEGs (quality 90), through
    the port's ``create_tfrecords`` into shards with their label map."""
    t0 = time.perf_counter()
    out = {}
    for name, n, shards, seed in (
            ("train", PIPE_TRAIN_EXAMPLES, PIPE_TRAIN_SHARDS, PIPE_SEED),
            ("val", PIPE_VAL_EXAMPLES, 1, PIPE_SEED + 1)):
        synthetic.write_coco_scenes(
            os.path.join(root, f"{name}_img"),
            os.path.join(root, f"{name}.json"), n, PIPE_SIZES, 80, seed,
            objects=(20, 60), sides=(12, 200))
        create_tfrecords.main([
            "--annotations", os.path.join(root, f"{name}.json"),
            "--images", os.path.join(root, f"{name}_img"),
            "--output", os.path.join(root, name),
            "--num-shards", str(shards)])
        out[name] = os.path.join(root, f"{name}-*-of-*")
    out["seconds"] = time.perf_counter() - t0
    return out


def run_train_cli(cfg_path: str, workdir: str, steps: int,
                  profile: int = 0) -> tuple[list[str], dict]:
    """``python -m ssd_tpu_torch.train`` in a subprocess: its stdout lines
    and its closing summary (kernel launches, peak memory)."""
    cmd = [sys.executable, "-m", "ssd_tpu_torch.train", "--config",
           cfg_path, "--workdir", workdir, "--max-steps", str(steps)]
    if profile:
        cmd += ["--profile", str(profile)]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=PIPE_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"train CLI failed ({proc.returncode}):\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    return lines, json.loads(lines[-1])


def step_times(records: list[dict]) -> dict:
    """Per-step times of a ``log_every=1`` run from its records: step k's
    time is the host clock between records k-1 and k less its wait for the
    batch. The profiled step and the one after it (the profiler's stop)
    are left out of everything; each scale's first step (cuDNN's
    autotuning) is left out of the p50s, not of the wait's share and
    img/s, which are over the loop's wall time of the steps kept."""
    train_recs = [r for r in records if "loss" in r]
    seen, by_scale = {train_recs[0]["image_hw"][0]}, collections.defaultdict(
        list)
    waits, wall, steps = [], 0.0, 0
    for prev, r in zip(train_recs, train_recs[1:]):
        s = r["image_hw"][0]
        first = s not in seen
        seen.add(s)
        if r["step"] in (PROFILE_AT, PROFILE_AT + 1):
            continue
        # the intervals of the unprofiled steps: input wait + step
        waits.append(r["data_wait_s"])
        wall += r["time"] - prev["time"]
        steps += 1
        if not first:
            by_scale[s].append((r["time"] - prev["time"] - r["data_wait_s"])
                               * 1e3)
    return {"step_ms_by_scale": {str(k): v for k, v in by_scale.items()},
            "p50_step_ms_by_scale": {str(k): float(np.median(v))
                                     for k, v in by_scale.items()},
            "data_wait_ms": [w * 1e3 for w in waits],
            "p50_data_wait_ms": float(np.median(waits) * 1e3),
            "data_wait_share": float(sum(waits) / wall),
            "loop_wall_s": wall, "timed_steps": steps}


def golden_pipeline_check() -> dict:
    """The card's ``Pipeline`` on ``assets/train_golden_v1.npz``'s shard
    against JAX's stored batches. Boxes, labels, counts and the eval
    fields equal; images bit-equal, except: at most 1 unit, and only in
    examples whose colour jitter ran (found by replaying the batch with
    the jitter off, which changes no earlier draw)."""
    with np.load(TRAIN_GOLDEN, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    cfg = Config.from_json(str(arrays["config_json"]))
    with tempfile.TemporaryDirectory() as root:
        shard = os.path.join(root, "g-00000-of-00001.tfrecords")
        arrays["shard"].tofile(shard)
        n = sum(1 for k in arrays if k.startswith("train") and
                k.endswith("/images"))

        def take(c: Config) -> list:
            it = iter(pipeline.Pipeline(shard, c, seed=c.train.seed))
            out = [next(it) for _ in range(n)]
            it.close()
            return out

        got = take(cfg)
        no_colour = take(dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, color_jitter_probability=0.0)))
        got_eval = list(pipeline.Pipeline(shard, cfg, is_training=False,
                                          batch_size=6))[-1]
    diffs, colour_examples, failures = [], 0, []
    for i, (g, off) in enumerate(zip(got, no_colour)):
        want = {k.split("/", 1)[1]: v for k, v in arrays.items()
                if k.startswith(f"train{i}/")}
        for k in ("boxes", "labels", "num_boxes"):
            if not np.array_equal(g[k], want[k]):
                failures.append(f"train{i} {k}")
        for j in range(len(g["images"])):
            coloured = not np.array_equal(g["images"][j], off["images"][j])
            colour_examples += coloured
            d = np.abs(g["images"][j].astype(np.int16)
                       - want["images"][j].astype(np.int16))
            if d.any():
                diffs.append({"batch": i, "example": j,
                              "pixels": int((d > 0).sum()),
                              "max": int(d.max()), "colour": coloured})
                if d.max() > 1 or not coloured:
                    failures.append(f"train{i} example {j} images")
    want_eval = {k.split("/", 1)[1]: v for k, v in arrays.items()
                 if k.startswith("eval/")}
    for k, v in want_eval.items():
        if not np.array_equal(got_eval[k], v):
            failures.append(f"eval {k}")
    result = {"train_batches": n,
              "examples": sum(len(g["images"]) for g in got),
              "examples_with_colour": colour_examples,
              "image_diffs": diffs, "eval_equal": not any(
                  f.startswith("eval") for f in failures),
              "decoder": native.decoders(), "failures": failures}
    if failures:
        raise AssertionError(f"pipeline differs from JAX's golden: {result}")
    return result


def pipeline_ms_by_scale(train_pattern: str, cfg: Config,
                         reps: int = 2) -> tuple[dict, dict]:
    """The host pipeline alone (no training running), ``num_workers`` 8:
    ms to make the first batch of epoch 0 at each scale, the best and the
    mean of ``reps``; and that batch at each scale."""
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, num_workers=8))
    p = pipeline.Pipeline(train_pattern, cfg, seed=cfg.train.seed)
    ids = p._epoch_order(0)[:p.batch_size]
    out, batches = {}, {}
    for s in cfg.train.multiscale:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            batches[s] = p._make_batch(ids, 0, (s, s))
            times.append((time.perf_counter() - t0) * 1e3)
        out[str(s)] = {"best_ms": min(times), "mean_ms": float(np.mean(times))}
    return out, batches


def pipeline_match_check(cfg: Config, batches: dict) -> dict:
    """K2 against its plain version on a real pipeline batch at each
    training scale, with the anchors of the ``Detector`` the training loop
    builds for that scale (``train.step_fn_for``): ``check_match_case``'s
    checks, best gt, IoU and anchor and the matches equal."""
    out, model = {}, None
    for s, b in batches.items():
        det = Detector(dataclasses.replace(cfg, image_size=(s, s)),
                       device=DEVICE, model=model)
        model = det.model
        case = kernel_cases.MatchCase(
            f"train_pipeline_{s}", det.anchors.cpu().numpy(), b["boxes"],
            b["num_boxes"].astype(np.int32),
            cfg.matcher.force_match_for_each_gt)
        row = check_match_case(case, case.name, cfg.matcher)
        out[str(s)] = {k: row[k] for k in ("A", "M", "gts", "positives",
                                           "ignored", "equal")}
    return out


def eval_golden_check() -> dict:
    """``train.evaluate`` on the card over ``assets/eval_golden_v1.npz``'s
    shard (the 32 held-out sanity scenes, JPEG bytes) with the trained
    sanity weights in f32, in batches of 12 (a padded tail): every mAP, AP
    and AR within ``EVAL_MAP_BAR`` of JAX's stored numbers (NaN where
    JAX's is), K1 once per eval batch."""
    with np.load(EVAL_GOLDEN, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    want = {k.split("/", 1)[1]: float(v) for k, v in arrays.items()
            if k.startswith("jax/")}
    cfg = Config.from_json(str(arrays["config_json"]))
    _, state = load_npz_artifact(ASSET)
    with tempfile.TemporaryDirectory() as root:
        shard = os.path.join(root, "val-00000-of-00001.tfrecords")
        arrays["shard"].tofile(shard)
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, val_file_pattern=shard))
        n = len(pipeline.ShardIndex([shard]))
        nms_cuda.launches = 0
        got = evaluate(Detector(cfg, state, device=DEVICE), cfg)
        launches = nms_cuda.launches
    diff = {k: got[k] - v for k, v in want.items()}
    bad = [k for k, d in diff.items()
           if not (abs(d) <= EVAL_MAP_BAR
                   or (np.isnan(got[k]) and np.isnan(want[k])))]
    batches = -(-n // cfg.train.batch_size)
    result = {"images": n, "batch": cfg.train.batch_size,
              "map": got["mAP"], "jax_cpu_map": want["mAP"],
              "diff": {k: (None if np.isnan(d) else d)
                       for k, d in diff.items()},
              "bar": EVAL_MAP_BAR, "nms_launches": launches}
    if bad or launches != batches:
        raise AssertionError(f"evaluate differs from JAX's ({bad}) or "
                             f"launched K1 {launches} times for {batches} "
                             f"batches: {result}")
    return result


def phase_train_pipeline(power_line: str, flagship_p50_ms: float
                         ) -> tuple[int, int, int, int]:
    """The shipped flagship trained through the CLI from tfrecords at
    full width (batch 64, 512/640/768, mosaic, crop, flip, colour, EMA),
    evaluated at its last step; re-run (it resumes and stops); its
    ``best/`` and ``export/`` served; a warm-started run distilled
    from that export; the host pipeline against JAX's golden and timed
    alone; K2 against its plain version on a pipeline batch at each scale;
    ``evaluate`` against JAX's numbers on the eval golden; no wait for the
    card inside a profiled steady step; ``python -m ssd_tpu_torch.eval``
    on ``best/`` and the val shards, with and without ``--tta``; the
    export CLI on the workdir, then the eval CLI on its directory and on
    the same weights as a ``.npz`` (``export_cli_check``).
    Returns (K2 launches of the training run, K1 launches of its
    evaluation and the serves, K1 launches of the eval golden's
    ``evaluate``, K1 launches of the eval CLI runs)."""
    root = tempfile.mkdtemp(prefix="ssd_pipe_")
    try:
        data = write_pipeline_dataset(root)
        with open(FLAGSHIP) as f:
            cfg_dict = json.load(f)
        overrides = {
            "data.train_file_pattern": data["train"],
            "data.val_file_pattern": data["val"],
            "train.multiscale_every": 4, "train.log_every": 1,
            "train.eval_every": PIPE_STEPS,
            "train.checkpoint_every": PIPE_STEPS}
        cfg = Config.from_dict(bench_serve.apply_overrides(
            cfg_dict, [f"{k}={json.dumps(v)}" for k, v in overrides.items()]))
        cfg_path = os.path.join(root, "flagship.json")
        cfg.save(cfg_path)
        accum = max(cfg.train.grad_accum_steps, 1)
        workdir = os.path.join(root, "run")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        lines, summary = run_train_cli(cfg_path, workdir, PIPE_STEPS,
                                       profile=1)
        wall = time.perf_counter() - t0
        with open(os.path.join(workdir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        train_recs = [r for r in records if "loss" in r]
        evals = [r for r in records if "mAP" in r]
        if len(train_recs) != PIPE_STEPS:
            raise AssertionError(f"{len(train_recs)} logged steps")
        if not all(np.isfinite(v) for r in train_recs for v in r.values()
                   if isinstance(v, float)):
            raise AssertionError("a training metric is not finite")
        scales = sorted({r["image_hw"][0] for r in train_recs})
        if scales != sorted(cfg.train.multiscale):
            raise AssertionError(f"trained at {scales}")
        if len(evals) != 1 or not np.isfinite(evals[0]["mAP"]):
            raise AssertionError(f"evaluation: {evals}")
        match_launches = summary["kernel_launches"]["match"]
        eval_nms = summary["kernel_launches"]["nms"]
        if match_launches != PIPE_STEPS * accum:
            raise AssertionError(f"{match_launches} matching launches, want "
                                 f"{PIPE_STEPS * accum}")
        if eval_nms < 1:
            raise AssertionError("evaluation launched no NMS")
        with open(os.path.join(workdir, "profile", "summary.json")) as f:
            prof = json.load(f)
        in_step = profiling.syncs_under(prof, ("train.feed", "train.step"))
        pageable = profiling.pageable_uploads(prof)
        staging_ms = sum(w["ms"] for w in profiling.staging_waits(prof))
        if (not prof["device_ops"] or in_step or pageable
                or staging_ms > STAGING_WAIT_BAR_MS):
            raise AssertionError(f"a training step waited for the card: "
                                 f"syncs {in_step}, pageable uploads "
                                 f"{pageable}, staging waits {staging_ms} "
                                 f"ms, device ops {prof['device_ops']}")
        timing = step_times(records)
        # trace_tools' tables and the tb/ events, before the re-run below
        # writes a second events file
        pipe_trace = trace_and_events_check(workdir, accum)

        # the same command again: it resumes, trains no step, stops
        t1 = time.perf_counter()
        again, _ = run_train_cli(cfg_path, workdir, PIPE_STEPS)
        resume_s = time.perf_counter() - t1
        if f"resumed from step {PIPE_STEPS}" not in again or any(
                line.startswith("step=") for line in again):
            raise AssertionError(f"re-run did not resume: {again[-5:]}")

        # both artifacts serve, with the label map, through K1
        val = next(iter(pipeline.Pipeline(data["val"], cfg,
                                          is_training=False, batch_size=8)))
        nms_cuda.launches = 0
        served = {}
        for name in (BEST_NAME, EXPORT_NAME):
            pred = Predictor.from_checkpoint(os.path.join(workdir, name),
                                             device=DEVICE)
            out = pred.predict(val["images"])
            _check_output(out, 8, cfg.nms.max_boxes)
            if pred.label_map is None or len(pred.label_map) != 80:
                raise AssertionError(f"{name}: no label map")
            served[name] = int(out["num_boxes"].sum())
        serve_nms = nms_cuda.launches
        if serve_nms != 2:
            raise AssertionError(f"{serve_nms} NMS launches serving 2")

        # a warm-started run distilled from the first run's export
        export = os.path.join(workdir, EXPORT_NAME)
        t_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, distill_from=export, init_from=export,
            eval_every=0))
        t_path = os.path.join(root, "teacher.json")
        t_cfg.save(t_path)
        t_dir = os.path.join(root, "distill")
        t1 = time.perf_counter()
        t_lines, t_summary = run_train_cli(t_path, t_dir, PIPE_TEACHER_STEPS)
        distill_s = time.perf_counter() - t1
        copied = [line for line in t_lines
                  if line.startswith("warm_start: copied")]
        counts = [line.split()[2].split("/") for line in copied]
        if not copied or any(a != b for a, b in counts):
            raise AssertionError(f"warm start copied {copied}")
        with open(os.path.join(t_dir, "metrics.jsonl")) as f:
            distill = [json.loads(line)["distill_loss"] for line in f]
        if len(distill) != PIPE_TEACHER_STEPS or not all(
                np.isfinite(distill)):
            raise AssertionError(f"distill_loss {distill}")
        if t_summary["kernel_launches"]["match"] != PIPE_TEACHER_STEPS * accum:
            raise AssertionError(f"distilled run: {t_summary}")

        eval_cli = eval_cli_check(os.path.join(workdir, BEST_NAME),
                                  data["val"])
        emit({"phase": "eval_cli", "export": "train_pipeline's best/",
              "val": PIPE_VAL_EXAMPLES, **eval_cli})
        export_cli = export_cli_check(workdir, root, data["val"])
        emit({"phase": "export_cli", "val": PIPE_VAL_EXAMPLES,
              **export_cli})
        golden = golden_pipeline_check()
        alone, scale_batches = pipeline_ms_by_scale(data["train"], cfg)
        match_by_scale = pipeline_match_check(cfg, scale_batches)
        del scale_batches
        eval_golden = eval_golden_check()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    batch = cfg.train.batch_size
    emit({"phase": "train_pipeline", "card": power_line,
          "config": os.path.relpath(FLAGSHIP, ROOT),
          "overrides": overrides | {"--max-steps": PIPE_STEPS,
                                    "--profile": 1},
          "dataset": {"train": PIPE_TRAIN_EXAMPLES,
                      "train_shards": PIPE_TRAIN_SHARDS,
                      "val": PIPE_VAL_EXAMPLES, "sizes": PIPE_SIZES,
                      "write_s": data["seconds"]},
          "batch": batch, "grad_accum_steps": accum,
          "mosaic": cfg.data.mosaic_probability,
          "ema_decay": cfg.train.ema_decay, "steps": PIPE_STEPS,
          **{k: v for k, v in timing.items() if v is not None},
          "img_per_s": batch * timing["timed_steps"] / timing["loop_wall_s"],
          "img_per_s_by_scale": {
              k: batch / v * 1e3
              for k, v in timing["p50_step_ms_by_scale"].items()},
          "train_flagship_p50_step_ms_640": flagship_p50_ms,
          "pipeline_ms_alone": alone,
          "peak_mem_gib": summary["peak_mem_gib"],
          "match_launches": match_launches, "eval_nms_launches": eval_nms,
          "serve_nms_launches": serve_nms, "served_boxes": served,
          "eval": {k: evals[0][k] for k in ("mAP", "AP50")},
          "final_loss": train_recs[-1]["loss"],
          "profiled_step": {
              "syncs_in_step": in_step, "all_syncs": prof["syncs"],
              "staging_wait_ms": staging_ms,
              "copies": prof["copies"], "host_ms": prof["host_ms"],
              "device_busy_ms": prof["device_busy_ms"],
              "device_ops": prof["device_ops"]},
          "trace_and_events": pipe_trace,
          "resume_s": resume_s, "distill": {
              "steps": PIPE_TEACHER_STEPS, "warm_start": copied,
              "distill_loss": distill, "seconds": distill_s,
              "peak_mem_gib": t_summary["peak_mem_gib"]},
          "golden": golden, "match_vs_plain_by_scale": match_by_scale,
          "eval_golden": eval_golden, "cli_wall_s": wall,
          "cli_reported_wall_s": summary["wall_s"]})
    return (match_launches, eval_nms + serve_nms,
            eval_golden["nms_launches"],
            sum(r["kernel_launches"]["nms"] for r in eval_cli.values())
            + sum(r["kernel_launches"]["nms"] for r in
                  export_cli["eval"].values()))


# ------------------------------------------------------------------ M10: tiling, TTA, eval CLI

def _seeded_flagship() -> Predictor:
    """The shipped flagship at full width, weights seeded from 0, class
    bias -2.5 (every (image, class) problem live)."""
    pred = Predictor(Config.load(FLAGSHIP), None, device=DEVICE)
    with torch.no_grad():
        pred.detector.model.head.class_net.predict.bias.fill_(
            FLAGSHIP_CLASS_BIAS)
    return pred


def _host_ms(fn, reps: int) -> tuple[list[float], object]:
    """Host-clock milliseconds of ``reps`` calls of ``fn`` (each ends in a
    readback), and the last result."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, out


def phase_tiled(power_line: str) -> int:
    """Tiled inference (``tiling.TiledPredictor``) of one seeded 3840x2160
    image with the flagship: 40 tiles of 640 and the full pass, one predict
    in the bucket of 64, K1 doing its NMS; the merge (IoS greedy NMS over
    the 41 x 100 candidates, K sequential steps on the card) against the
    same merge on the CPU on the same per-tile detections, bit for bit.
    Returns the NMS launches of the counted runs."""
    pred = _seeded_flagship()
    tiler = TiledPredictor(pred)
    image = np.random.default_rng(31).integers(
        0, 256, TILED_IMAGE_HW + (3,), dtype=np.uint8)
    grid = tiler.grid_for(image.shape[:2])
    passes = len(grid.origins) + 1
    if len(grid.origins) != 40 or pred._bucket_for(passes) != 64:
        raise AssertionError(f"{len(grid.origins)} tiles")
    tiler.predict(image)  # the bucket of 64 warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nms_cuda.launches = conv_s8_cuda.launches = 0
    times, out = _host_ms(lambda: tiler.predict(image), 5)
    launches, k4 = nms_cuda.launches, conv_s8_cuda.launches
    k4 = k4_count(pred.detector, image[None, :640, :640], k4, launches,
                  "tiled")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if launches != 5:
        raise AssertionError(f"{launches} NMS launches for 5 tiled images")
    assert out["boxes"].shape == (tiler.max_boxes, 4)
    assert np.isfinite(out["boxes"]).all() and 0 < out["num_boxes"]

    cand_ms, cand = _host_ms(lambda: tiler.candidates(image), 3)
    merge_ms, card = _host_ms(lambda: tiler.merge(*cand), 3)
    cpu_ms, cpu = _host_ms(lambda: tiler.merge(*cand, device="cpu"), 1)
    for k in ("boxes", "scores", "labels", "num_boxes"):
        if not np.array_equal(card[k], cpu[k]):
            raise AssertionError(f"tiled merge on the card differs from "
                                 f"the CPU's: {k}")
    emit({"phase": "tiled", "config": os.path.relpath(FLAGSHIP, ROOT),
          "image": list(TILED_IMAGE_HW), "tiles": len(grid.origins),
          "passes": passes, "bucket": pred._bucket_for(passes),
          "candidates": int(len(cand[1])),
          "valid_candidates": int((cand[1] > 0).sum()),
          "num_boxes": int(out["num_boxes"]), "nms_launches": launches,
          **k4, "image_ms": times, "p50_image_ms": float(np.median(times)),
          "predict_and_map_ms": float(np.median(cand_ms)),
          "merge_ms_card": float(np.median(merge_ms)),
          "merge_ms_cpu": cpu_ms[0], "merge_share": float(
              np.median(merge_ms) / np.median(times)),
          "merge_card_equals_cpu": True, "peak_mem_gib": peak,
          "note": "host clock, each call ends in its readback; seeded "
                  "weights, class bias -2.5; on " + power_line})
    return launches


def phase_tta(power_line: str) -> tuple[int, int]:
    """Flip TTA of the flagship at b32 (64 views, one predict in the bucket
    of 64, K1 doing its NMS) through ``TTAPredictor.predict``; its weighted
    box fusion (200 candidates an image, 200 sequential steps for the 32
    images at once on the card) against the same fusion on the CPU on the
    same view detections, bit for bit; then behind the daemon
    (``DetectionServer`` with the ``TTAPredictor``, ``scan_depth`` 1): each
    request's JSON against the direct call on the same pixels. Returns the
    NMS launches of the direct and the daemon runs."""
    pred = _seeded_flagship()
    ttap = TTAPredictor(pred)
    h, w = pred.cfg.image_hw()
    rng = np.random.default_rng(41)
    batches = [rng.integers(0, 256, (32, h, w, 3), dtype=np.uint8)
               for _ in range(3)]
    ttap.warmup(32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nms_cuda.launches = 0
    times = []
    for i in range(10):
        t0 = time.perf_counter()
        out = ttap.predict(batches[i % 3])
        times.append((time.perf_counter() - t0) * 1e3)
        _check_output(out, 32, ttap.max_boxes)
    launches = nms_cuda.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if launches != 10:
        raise AssertionError(f"{launches} NMS launches for 10 TTA batches")

    views = pred.predict_collect(ttap.predict_dispatch(batches[0])["inner"])
    base = {k: views[k][:32] for k in DET_KEYS}
    flip = {k: views[k][32:] for k in DET_KEYS}
    args = (base, flip, ttap.iou_threshold, ttap.max_boxes)
    predict_ms, _ = _host_ms(lambda: pred.predict(
        list(batches[0]) + [im[:, ::-1] for im in batches[0]]), 3)
    wbf_ms, card = _host_ms(lambda: fuse_flip_batch(*args, device=DEVICE), 3)
    cpu_ms, cpu = _host_ms(lambda: fuse_flip_batch(*args, device="cpu"), 1)
    for k in DET_KEYS:
        if not np.array_equal(card[k], cpu[k]):
            raise AssertionError(f"WBF on the card differs from the CPU's: "
                                 f"{k}")
    direct = ttap.predict(batches[0])
    for k in DET_KEYS:
        if not np.array_equal(direct[k], card[k]):
            raise AssertionError(f"TTAPredictor differs from its fusion: {k}")

    # behind the daemon: one request at a time, each a batch of one
    dpred = TTAPredictor(_seeded_flagship())
    srv = DetectionServer(dpred, host="127.0.0.1", port=0, max_batch=32,
                          max_wait_ms=0.0, default_score_threshold=0.0,
                          scan_depth=4)
    if srv.dispatcher.scan_depth != 1:
        raise AssertionError("the TTA daemon groups batches")
    bodies, _ = bench_http.request_bodies(w)
    dpred.warmup(1)
    srv.start()
    try:
        nms_cuda.launches = 0
        daemon = [post_json(srv.port, body) for body in bodies[:8]]
        daemon_launches = nms_cuda.launches
    finally:
        srv.stop()
    for body, got in zip(bodies[:8], daemon):
        want = detection_rows(dpred.predict(
            native.decode_jpeg(body, h, w)), 0.0)
        rows = got["detections"]
        if len(rows) != len(want) or any(
                a["label"] != b["label"]
                or abs(a["score"] - b["score"]) > JSON_TOL
                or np.abs(np.subtract(a["box_yxyx"], b["box_yxyx"])).max()
                > JSON_TOL for a, b in zip(rows, want)):
            raise AssertionError("the TTA daemon differs from the direct "
                                 "call")
    if daemon_launches != 8:
        raise AssertionError(f"{daemon_launches} NMS launches for 8 daemon "
                             "requests")
    emit({"phase": "tta", "config": os.path.relpath(FLAGSHIP, ROOT),
          "batch": 32, "views": 64, "bucket": pred._bucket_for(64),
          "merge": ttap.merge, "nms_launches": launches,
          "daemon_nms_launches": daemon_launches, "daemon_requests": 8,
          "num_boxes_mean": float(np.mean(out["num_boxes"])),
          "batch_ms": times, "p50_batch_ms": float(np.median(times)),
          "img_per_s": 32 / np.median(times) * 1e3,
          "predict_64_views_ms": float(np.median(predict_ms)),
          "wbf_ms_card": float(np.median(wbf_ms)), "wbf_ms_cpu": cpu_ms[0],
          "wbf_share": float(np.median(wbf_ms) / np.median(times)),
          "wbf_card_equals_cpu": True, "daemon_equals_direct": True,
          "peak_mem_gib": peak,
          "note": "host clock, each call ends in its readback; seeded "
                  "weights, class bias -2.5; on " + power_line})
    return launches, daemon_launches


def eval_cli_check(artifact: str, val_pattern: str, flag: str = "--export",
                   modes: tuple = (False, True), extra: tuple = ()) -> dict:
    """``python -m ssd_tpu_torch.eval`` on ``artifact`` (``flag``:
    ``--export`` for a directory, ``--npz`` for a file) and the val shards,
    in a subprocess, without and with ``--tta`` (``modes``): the closing
    JSON line of each (mAP finite, K1 launched once a predict). ``extra``:
    more arguments of the CLI."""
    rows = {}
    for tta in modes:
        cmd = [sys.executable, "-m", "ssd_tpu_torch.eval", flag, artifact,
               "--val-pattern", val_pattern, "--batch-size", "32", *extra]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd + ["--tta"] * tta, cwd=ROOT,
                              capture_output=True, text=True,
                              timeout=PIPE_TIMEOUT_S)
        if proc.returncode != 0:
            raise AssertionError(f"eval CLI failed ({proc.returncode}):\n"
                                 f"{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        last = json.loads(proc.stdout.strip().splitlines()[-1])
        batches = -(-last["images"] // 32)
        if (not np.isfinite(last["mAP"]) or last["images"] != PIPE_VAL_EXAMPLES
                or last["kernel_launches"]["nms"] != batches * (1 + tta)):
            raise AssertionError(f"eval CLI: {last}")
        last["wall_s"] = time.perf_counter() - t0
        rows["tta" if tta else "plain"] = last
    return rows


def export_cli_check(workdir: str, root: str, val_pattern: str) -> dict:
    """``python -m ssd_tpu_torch.export`` on the training workdir (its
    last checkpoint, EMA weights) into a new artifact directory: bit-equal
    to the train loop's own ``export/``; then ``python -m
    ssd_tpu_torch.eval --export`` on it and ``--npz`` on the same weights
    as one file, keeping nearly every candidate (score threshold 1e-6):
    the same mAP and the same detections (``--dump-coco``)."""
    out = os.path.join(root, "cli_export")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ssd_tpu_torch.export",
                           "--workdir", workdir, "--output", out], cwd=ROOT,
                          capture_output=True, text=True,
                          timeout=PIPE_TIMEOUT_S)
    export_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"export CLI failed ({proc.returncode}):\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    cfg, got = load_inference_artifact(out)
    _, want = load_inference_artifact(os.path.join(workdir, EXPORT_NAME))
    if set(got) != set(want) or not all(torch.equal(got[k], want[k])
                                        for k in want):
        raise AssertionError("the export CLI's weights differ from the "
                             "train loop's export")
    npz = os.path.join(root, "cli_export.npz")
    save_npz_artifact(npz, cfg, got)
    dumps = [os.path.join(root, f"coco_{k}.json") for k in ("dir", "npz")]
    every = ("--set", "nms.score_threshold=1e-6", "--dump-coco")
    by_dir = eval_cli_check(out, val_pattern, "--export", (False,),
                            (*every, dumps[0]))
    by_npz = eval_cli_check(npz, val_pattern, "--npz", (False,),
                            (*every, dumps[1]))
    rows = []
    for path in dumps:
        with open(path) as f:
            rows.append(json.load(f))
    keys = ("mAP", "AP50", "AP75")
    if (any(by_dir["plain"][k] != by_npz["plain"][k] for k in keys)
            or not rows[0] or rows[0] != rows[1]):
        raise AssertionError(f"eval --export {by_dir} differs from --npz "
                             f"{by_npz}, or their detections do")
    return {"export_s": export_s, "stdout": proc.stdout.strip()[-300:],
            "equal_to_train_export": True,
            "eval": {"export": by_dir["plain"], "npz": by_npz["plain"]},
            "same_map": True, "same_detections": len(rows[0])}


# ------------------------------------------------------------------ M10.3, M10.4: streaming, export

def _stream_pool(cfg: Config) -> list:
    """8 seeded frames at the model resolution and 8 of 1080x1920, in
    turns."""
    rng = np.random.default_rng(51)
    h, w = cfg.image_hw()
    square = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for _ in range(8)]
    hd = [rng.integers(0, 256, (*STREAM_HD_HW, 3), dtype=np.uint8)
          for _ in range(8)]
    return [f for pair in zip(square, hd) for f in pair]


def stream_run(cfg: Config, pool: list, power_line: str) -> dict:
    """One ``StreamingDetector`` (depth 2, weights seeded from 0, class bias
    -2.5; int8 configs calibrated on two seeded frames at the model
    resolution) over ``STREAM_FRAMES`` frames of ``pool`` after its
    warmup, K1 launches counted; then ``STREAM_PROFILED`` more under the
    profiler: no wait for the card under ``streaming.push``, the card's
    busy time, its idle share of that window and the host's push time a
    frame; every timed frame's detections bit-equal to
    ``Predictor.predict`` of the same frame, and K1 held to its plain
    version on one frame's candidates (N=1)."""
    stream = StreamingDetector(cfg, None, depth=STREAM_DEPTH, device=DEVICE)
    with torch.no_grad():
        stream.detector.model.head.class_net.predict.bias.fill_(
            FLAGSHIP_CLASS_BIAS)
    h, w = cfg.image_hw()
    calibration_s = None
    if cfg.model.compute_dtype == "int8":
        noise = np.random.default_rng(8).integers(0, 256, (2, h, w, 3),
                                                  dtype=np.uint8)
        t0 = time.perf_counter()
        calibrate(stream.detector, [noise])
        torch.cuda.synchronize()
        calibration_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stream.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    nms_cuda.launches = conv_s8_cuda.launches = 0
    results = []
    t0 = time.perf_counter()
    for i in range(STREAM_FRAMES):
        results.extend(stream.push(pool[i % len(pool)]))
    results.extend(stream.flush())
    wall = time.perf_counter() - t0
    launches, k4 = nms_cuda.launches, conv_s8_cuda.launches
    k4 = k4_count(stream.detector, pool[0][None], k4, launches,
                  f"streaming {cfg.model.compute_dtype}")
    stats = stream.stats()
    if len(results) != STREAM_FRAMES or launches != STREAM_FRAMES:
        raise AssertionError(f"streaming: {len(results)} results, "
                             f"{launches} NMS launches for {STREAM_FRAMES} "
                             "frames")
    for r in results:
        _check_output({k: np.asarray(r[k])[None] for k in DET_KEYS}, 1,
                      cfg.nms.max_boxes)
        if not isinstance(r["num_boxes"], int):
            raise AssertionError("num_boxes is not an int")

    summary = bench_streaming.profile_pushes(stream, pool, STREAM_PROFILED)
    stalls = profiling.syncs_under(summary, (PUSH_SPAN,))
    pageable = profiling.pageable_uploads(summary)
    staging_ms = sum(x["ms"] for x in profiling.staging_waits(summary))
    if stalls or pageable:
        raise AssertionError(f"a push waited for the card: syncs {stalls}, "
                             f"pageable uploads {pageable}")
    push_ms = (summary["host_ms"][PUSH_SPAN]
               / summary["span_calls"][PUSH_SPAN])
    device_ms = summary["device_busy_ms"] / STREAM_PROFILED
    idle = 1.0 - summary["device_busy_ms"] / summary["wall_ms"]
    if not 0.0 <= idle < 1.0:
        raise AssertionError(f"streaming: device idle share {idle} of the "
                             "profiled window is out of range")

    # K1 against its plain version on a frame's own candidates
    feed = torch.from_numpy(stream.predictor._feed(pool[0][None])).to(DEVICE)
    _hold_k1(*stream.detector.candidates(feed), cfg,
             f"streaming {cfg.model.compute_dtype}")

    # each frame against the predictor's own call on the same frame
    want = [stream.predictor.predict(f) for f in pool]
    differ = [i for i, r in enumerate(results) if not all(
        np.array_equal(r[k], want[i % len(pool)][k]) for k in DET_KEYS)]
    if differ:
        raise AssertionError(f"streamed frames {differ} differ from "
                             "Predictor.predict")
    return {"dtype": cfg.model.compute_dtype,
            "feed": "packed s8" if stream.packed else "raw uint8",
            "depth": STREAM_DEPTH, "frames": STREAM_FRAMES,
            "fps": stats["fps"], "wall_fps": STREAM_FRAMES / wall,
            "p50_latency_ms": stats["p50_latency_s"] * 1e3,
            "p95_latency_ms": stats["p95_latency_s"] * 1e3,
            "device_ms_per_frame": device_ms,
            "device_fps": 1e3 / device_ms,
            "host_push_ms": push_ms,
            "profiled_fps": STREAM_PROFILED / summary["wall_ms"] * 1e3,
            "device_idle_share": idle,
            "staging_wait_ms": staging_ms, "nms_launches": launches, **k4,
            "num_boxes_mean": float(np.mean([r["num_boxes"]
                                             for r in results])),
            "equal_to_predictor": True, "warmup_s": warmup_s,
            "calibration_s": calibration_s,
            "card": power_line}


def phase_streaming(power_line: str) -> dict:
    """``configs/streaming_1024.json`` (the reference stem at 1024, 80
    classes, full width and depth) streamed in bf16 and in int8 with
    ``int8_neck`` (``stream_run``), from 8 seeded 1024 frames and 8 of
    1080x1920 in turns. Returns the K1 launches of each timed run."""
    cfg = Config.load(STREAMING)
    assert cfg.image_hw() == (1024, 1024)
    assert cfg.model.compute_dtype == "bfloat16"
    pool = _stream_pool(cfg)
    rows = [stream_run(cfg, pool, power_line)]
    torch.cuda.empty_cache()
    rows.append(stream_run(int8_config(cfg), pool, power_line))
    emit({"phase": "streaming", "config": os.path.relpath(STREAMING, ROOT),
          "stem_schedule": cfg.model.stem_schedule, "rows": rows,
          "note": "seeded weights, class bias -2.5; fps and latency from "
                  "StreamingDetector.stats (host clock); device ms a frame "
                  f"is the profiler's busy time over {STREAM_PROFILED} "
                  "more frames, the idle share and profiled_fps over the "
                  "same window (host clock, first push to flushed); "
                  "host_push_ms the streaming.push span (resize and "
                  "enqueue)"})
    return {"streaming": rows[0]["nms_launches"],
            "streaming_int8": rows[1]["nms_launches"]}


def phase_export(power_line: str) -> int:
    """``export.export_program`` of the shipped flagship (seeded weights,
    class bias -2.5) at b8, in bf16 and in int8 with its neck calibrated
    on a seeded batch of 8; each program loaded (``load_program``) and run
    on a seeded uint8 batch: its outputs bit-equal to eager
    ``Detector.predict`` of the same batch, K1 launched once by it and
    held to its plain version on the batch's candidates; the
    export and load seconds, and the program's ms beside eager's, with
    the device ops and busy ms of one call of each. Returns
    the K1 launches of the two loaded programs' checked runs."""
    root = tempfile.mkdtemp(prefix="ssd_export_")
    rows, launches = [], 0
    try:
        for int8 in (False, True):
            cfg = Config.load(FLAGSHIP)
            if int8:
                cfg = int8_config(cfg)
            pred = Predictor(cfg, None, device=DEVICE)
            with torch.no_grad():
                pred.detector.model.head.class_net.predict.bias.fill_(
                    FLAGSHIP_CLASS_BIAS)
            if int8:
                bench_serve.calibrate_seeded(pred)
            det = pred.detector
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = export_program(os.path.join(root, cfg.model.compute_dtype),
                                  cfg, det.model.state_dict(),
                                  batch_size=EXPORT_BATCH, device=DEVICE)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            program = load_program(path)
            load_s = time.perf_counter() - t0
            h, w = cfg.image_hw()
            batch = np.random.default_rng(61).integers(
                0, 256, (EXPORT_BATCH, h, w, 3), dtype=np.uint8)
            want = det.predict(batch)
            _hold_k1(*det.candidates(batch), cfg,
                     f"export b{EXPORT_BATCH} {cfg.model.compute_dtype}")
            torch.cuda.synchronize()
            nms_cuda.launches = conv_s8_cuda.launches = 0
            got = program(batch)
            torch.cuda.synchronize()
            n, k4 = nms_cuda.launches, conv_s8_cuda.launches
            if n != 1:
                raise AssertionError(f"the loaded program launched K1 {n} "
                                     "times")
            k4 = k4_count(det, batch[:1], k4, 1,
                          f"export {cfg.model.compute_dtype}")
            launches += n
            for k in DET_KEYS:
                if not torch.equal(got[k], getattr(want, k)):
                    raise AssertionError(f"exported program's {k} differs "
                                         f"from eager ({cfg.model.compute_dtype})")
            feed = torch.from_numpy(batch).to(DEVICE)

            def timed(fn):
                times = []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn(feed)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                return float(np.median(times))

            def device_work(fn):
                """One call's device ops and busy ms (profiler)."""
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    fn(feed)
                    torch.cuda.synchronize()
                summary = profiling.summarize(prof, "export.")
                return {"device_ops": summary["device_ops"],
                        "device_busy_ms": summary["device_busy_ms"]}
            rows.append({"dtype": cfg.model.compute_dtype,
                         "batch": EXPORT_BATCH, "file": os.path.basename(path),
                         "file_mib": os.path.getsize(path) / 2 ** 20,
                         "export_s": export_s, "load_s": load_s,
                         "program_ms": timed(program),
                         "eager_ms": timed(det.predict),
                         "program_device": device_work(program),
                         "eager_device": device_work(det.predict),
                         "num_boxes_mean": float(
                             got["num_boxes"].float().mean()),
                         "bit_equal_to_eager": True, "nms_launches": n,
                         **k4})
            del pred, det, program
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "export", "config": os.path.relpath(FLAGSHIP, ROOT),
          "rows": rows,
          "note": "host clock around each call ended by a synchronize, "
                  "median of 5, the feed already on the card; on "
                  + power_line})
    return launches


def phase_train_memory(power_line: str) -> int:
    """``tools/train_memory.py`` at b64/640 on the ResNet-50, MobileNet-v2
    and flagship configs: one forward and backward each, the tensors saved
    for the backward by module and dtype, and the peak. Returns the
    matching launches (one a step)."""
    matching_cuda.launches = 0
    rows = []
    for name in MEMORY_CONFIGS:
        cfg = Config.load(os.path.join(ROOT, "configs", name))
        row = train_memory.run(cfg, [64], device=DEVICE)[0]
        if row["oom"] is not None:
            raise AssertionError(f"{name}: ran out of memory in the "
                                 f"{row['oom']}")
        norm = sum(v for k, v in row["saved"].items()
                   if k.startswith("BatchNorm/"))
        rows.append({"config": name, **row, "saved_by_batch_norm_gib": norm})
        torch.cuda.empty_cache()
    emit({"phase": "train_memory", "rows": rows,
          "note": "one forward and backward of the loss, no optimizer; "
                  "on " + power_line})
    return matching_cuda.launches


# ------------------------------------------------------------------ scale-out

SCALEOUT_STEPS = 4  # timed data-parallel steps, after one warm-up
SCALEOUT_FSDP_TOL = 1e-5  # (b) against (a), rtol and atol
SCALEOUT_EVAL_BAR = 1e-6  # (c) against JAX's stored numbers
SCALEOUT_PREDICTS = 3
GLOO_BATCH = 8  # (e): the f32 flagship, 4 rows a rank
GLOO_TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _deterministic():
    """cuDNN's deterministic algorithms (and PyTorch's where it has them)
    for the block: two runs of one step then give the same bits, so that
    the data-parallel step can be held bit-equal to the plain one."""
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            prev[:2]
        torch.use_deterministic_algorithms(prev[2])


def _train_setup(cfg: Config, mesh=None, fsdp: bool = False):
    """A seeded flagship, its state and its step: plain (``mesh=None``),
    data-parallel over ``mesh``, or FSDP over it."""
    det = Detector(cfg, device=DEVICE)
    if fsdp:
        mesh_lib.fsdp_sharded(mesh, det.model)
    opt = Optimizer(cfg)
    state = create_train_state(det, opt, cfg.train.ema_decay)
    step = make_train_step(det, opt, cfg.train.ema_decay,
                           cfg.train.grad_accum_steps, mesh=mesh)
    return det, state, step


def _run_steps(run: list, batches: list, feed, times: list | None = None
               ) -> list[dict]:
    """Steps ``run = [det, state, step]`` over ``batches`` (uploaded
    first), each ending in the readback of its metrics; host-clock ms of
    each appended to ``times``."""
    out = []
    for batch in batches:
        dev = feed(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run[1], m = run[2](run[1], dev)
        values = torch.stack([v.float() for v in m.values()]).tolist()
        if times is not None:
            times.append((time.perf_counter() - t0) * 1e3)
        out.append(dict(zip(m, values)))
    return out


def _whole_state(det: Detector, state) -> dict:
    """The model's state dict and the EMA, whole tensors on the host."""
    out = {f"model/{k}": mesh_lib.full_tensor(v.detach()).to("cpu",
                                                             copy=True)
           for k, v in det.model.state_dict().items()}
    out.update({f"ema/{k}": mesh_lib.full_tensor(v.detach()).to("cpu",
                                                               copy=True)
                for k, v in (state.ema_params or {}).items()})
    return out


def _scaleout_train(cfg: Config, mesh, feed) -> dict:
    """(a) and (b): the data-parallel and the FSDP step at world size 1
    held to the plain step, then all three timed in turns."""
    h = cfg.image_hw()[0]
    accum = max(cfg.train.grad_accum_steps, 1)
    batches = [synthetic.crowded_batch(i, CROWDED_SEED, cfg.train.batch_size,
                                       h, cfg.num_classes,
                                       cfg.data.max_gt_boxes)
               for i in range(1 + SCALEOUT_STEPS)]
    plain, dp = list(_train_setup(cfg)), list(_train_setup(cfg, mesh))
    peaks, launches = {}, {}
    with _deterministic():
        m_plain = _run_steps(plain, batches, feed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        matching_cuda.launches = 0
        m_dp = _run_steps(dp, batches, feed)
        launches["scaleout_dp"] = matching_cuda.launches
        peaks["dp"] = torch.cuda.max_memory_allocated() / 2 ** 30
    want, got = _whole_state(plain[0], plain[1]), _whole_state(dp[0], dp[1])
    unequal = sorted(k for k in want if not torch.equal(want[k], got[k]))
    if m_plain != m_dp or unequal:
        raise AssertionError(
            f"(a) the world-1 data-parallel step is not the plain step: "
            f"metrics {m_plain} vs {m_dp}, tensors {unequal[:8]} "
            f"({scaleout_check.state_diff(got, want)})")
    if launches["scaleout_dp"] != len(batches) * accum:
        raise AssertionError(f"(a) {launches['scaleout_dp']} K2 launches "
                             f"for {len(batches)} steps")

    # one profiled step: no wait for the card inside it
    dev = feed(batches[0])
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("train.step"):
            dp[1], m = dp[2](dp[1], dev)
        torch.cuda.synchronize()
    summary = profiling.summarize(prof, "train.")
    stalls = profiling.syncs_under(summary, ("train.step",))
    if stalls or not summary["device_ops"]:
        raise AssertionError(f"(a) the data-parallel step waited for the "
                             f"card: {stalls}")

    fsdp = list(_train_setup(cfg, mesh, fsdp=True))
    sharded = sum(mesh_lib.is_sharded(p) for p in fsdp[1].params.values())
    with _deterministic():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        matching_cuda.launches = 0
        m_fsdp = _run_steps(fsdp, batches, feed)
        launches["scaleout_fsdp"] = matching_cuda.launches
        peaks["fsdp"] = torch.cuda.max_memory_allocated() / 2 ** 30
    fsdp_diff = scaleout_check.state_diff(_whole_state(fsdp[0], fsdp[1]), got)
    metric_rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                     for a, b in zip(m_fsdp, m_dp) for k in b)
    close = all(torch.allclose(_whole_state(fsdp[0], fsdp[1])[k].double(),
                               v.double(), rtol=SCALEOUT_FSDP_TOL,
                               atol=SCALEOUT_FSDP_TOL)
                for k, v in got.items() if v.is_floating_point())
    if not close or metric_rel > SCALEOUT_FSDP_TOL:
        raise AssertionError(f"(b) FSDP differs from (a): {fsdp_diff}, "
                             f"metrics {metric_rel}")

    # times, default cuDNN choices, in turns
    times = {"plain": [], "dp": [], "fsdp": []}
    for name in ("plain", "dp", "fsdp", "fsdp", "dp", "plain"):
        run = {"plain": plain, "dp": dp, "fsdp": fsdp}[name]
        _run_steps(run, batches[1:], feed, times[name])
    p50 = {k: float(np.median(v)) for k, v in times.items()}
    return {"batch": cfg.train.batch_size, "image": list(cfg.image_hw()),
            "steps_held": len(batches), "dp_bit_equal_to_plain": True,
            "dp_profiled_step_syncs": len(stalls),
            "fsdp_sharded_params": sharded,
            "fsdp_vs_dp": fsdp_diff, "fsdp_metric_max_rel_diff": metric_rel,
            "fsdp_tol": SCALEOUT_FSDP_TOL,
            "step_ms": times, "p50_step_ms": p50,
            "dp_over_plain": p50["dp"] / p50["plain"] - 1,
            "fsdp_over_dp": p50["fsdp"] / p50["dp"] - 1,
            "peak_mem_gib": peaks, "launches": launches}


def _scaleout_eval(mesh) -> tuple[dict, int]:
    """(c): ``train.evaluate`` with the mesh and the gather over the eval
    golden's shard, against JAX's stored numbers."""
    with np.load(EVAL_GOLDEN, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    want = {k.split("/", 1)[1]: float(v) for k, v in arrays.items()
            if k.startswith("jax/")}
    cfg = Config.from_json(str(arrays["config_json"]))
    _, state = load_npz_artifact(ASSET)
    with tempfile.TemporaryDirectory() as root:
        shard = os.path.join(root, "val-00000-of-00001.tfrecords")
        arrays["shard"].tofile(shard)
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, val_file_pattern=shard))
        n = len(pipeline.ShardIndex([shard]))
        det = Detector(cfg, state, device=DEVICE)
        nms_cuda.launches = 0
        got = evaluate(det, cfg, 0, 1, mesh=mesh)
        launches = nms_cuda.launches
    diff = {k: got[k] - v for k, v in want.items()}
    bad = [k for k, d in diff.items()
           if not (abs(d) <= SCALEOUT_EVAL_BAR
                   or (np.isnan(got[k]) and np.isnan(want[k])))]
    batches = -(-n // cfg.train.batch_size)
    if bad or launches != batches:
        raise AssertionError(f"(c) the gathered evaluate differs from JAX's "
                             f"({bad}) or launched K1 {launches} times for "
                             f"{batches} batches")
    return {"images": n, "batch": cfg.train.batch_size, "map": got["mAP"],
            "jax_cpu_map": want["mAP"], "bar": SCALEOUT_EVAL_BAR,
            "max_abs_diff": max((abs(d) for d in diff.values()
                                 if not np.isnan(d)), default=0.0)}, launches


def _scaleout_predict() -> tuple[dict, int]:
    """(d): ``Predictor(mesh=True)`` on the flagship at b32, bit-equal to
    the plain predictor, K1 once a device a predict."""
    plain = _seeded_flagship()
    meshed = Predictor(plain.cfg, plain.detector.model.state_dict(),
                       mesh=True)
    images = np.random.default_rng(12).integers(
        0, 256, (32, *plain.cfg.image_hw(), 3), dtype=np.uint8)
    plain.warmup(32)
    meshed.warmup(32)
    plain_ms, want = _host_ms(lambda: plain.predict(images), 5)
    nms_cuda.launches = 0
    mesh_ms, got = _host_ms(lambda: meshed.predict(images),
                            SCALEOUT_PREDICTS)
    launches = nms_cuda.launches
    unequal = [k for k in want if not np.array_equal(want[k], got[k])]
    devices = len(meshed.replicas)
    if unequal or launches != SCALEOUT_PREDICTS * devices:
        raise AssertionError(f"(d) the meshed predictor differs in "
                             f"{unequal} or launched K1 {launches} times")
    _check_output(got, 32, plain.cfg.nms.max_boxes)
    return {"batch": 32, "devices": devices,
            "bucket": meshed._bucket_for(32), "bit_equal": True,
            "p50_ms": float(np.median(mesh_ms)),
            "plain_p50_ms": float(np.median(plain_ms)),
            "detections": int(got["num_boxes"].sum())}, launches


def _scaleout_gloo() -> tuple[dict, int]:
    """(e): two ranks on the one card over gloo (``tools/scaleout_check.py``:
    ``torchrun`` of ``tools/bench_train.py``, DP), the f32 flagship at b8:
    the ranks' states bit-identical, and within the f32 bars of the
    one-process step on the 8 rows."""
    row = scaleout_check.run(FLAGSHIP, 2, GLOO_BATCH, backend="gloo",
                             overrides=["model.compute_dtype=float32"],
                             timeout=GLOO_TIMEOUT_S)
    launches = sum(row["match_launches"])
    if not row["ok"] or row["match_launches"] != [1, 1]:
        raise AssertionError(f"(e) two gloo ranks on the card: {row}")
    return row, launches


def phase_scaleout(power_line: str) -> tuple[dict, dict]:
    """The scale-out paths on the one card: (a) the data-parallel step over
    NCCL at world size 1, bit-equal to the plain step, K2 once a step, no
    wait for the card inside a profiled step; (b) the same under FSDP
    within 1e-5 of (a); (c) ``train.evaluate`` with the mesh and the
    stat gather over the eval golden, JAX's numbers to 1e-6; (d)
    ``Predictor(mesh=True)`` at b32 bit-equal to the plain predictor; (e)
    two ranks on the card over gloo. Returns the K1 and K2 launches by
    path."""
    t0 = time.perf_counter()
    cfg = Config.load(FLAGSHIP)
    mesh_lib.initialize_distributed(
        DEVICE, init_method=f"tcp://localhost:{_free_port()}", world_size=1,
        rank=0)
    try:
        if torch.distributed.get_backend() != "nccl":
            raise AssertionError("the card's process group is not NCCL")
        mesh = mesh_lib.create_mesh()
        feed = DeviceFeed(mesh.device)
        train_rows = _scaleout_train(cfg, mesh, feed)
        eval_row, k1_eval = _scaleout_eval(mesh)
        predict_row, k1_predict = _scaleout_predict()
    finally:
        mesh_lib.shutdown_distributed()
    gloo_row, k2_gloo = _scaleout_gloo()
    k2 = dict(train_rows.pop("launches"), scaleout_gloo=k2_gloo)
    k1 = {"scaleout_eval": k1_eval, "scaleout_predict": k1_predict}
    emit({"phase": "scaleout", "card": power_line,
          "config": os.path.relpath(FLAGSHIP, ROOT), "world_size": 1,
          "backend": "nccl", "train": train_rows, "evaluate": eval_row,
          "predict": predict_row, "gloo_two_ranks": gloo_row,
          "launches": {**k1, **k2}, "wall_s": time.perf_counter() - t0,
          "note": "unoptimised eager bring-up reading on " + power_line})
    return k1, k2


# ------------------------------------------------- the rest of scale-out (M11b)

M11B_TP_BATCH = 4  # (f): the f32 flagship, both ranks on the same 4 rows
M11B_FRAMES = 16  # (h): frames a stream
M11B_STRIPS = 4
M11B_F32_ATOL = 1e-5  # tests/test_spatial.py's bars
M11B_BF16_SHARE = 0.9  # bf16 detections of the split matched, golden rule
M11B_PREDICT_BATCH = 8


def _m11b_tp(power_line: str) -> tuple[dict, int]:
    """(f): the f32 flagship at TP 2 on two gloo ranks on the one card
    (``tools/scaleout_check.py --model-parallelism 2``: ``torchrun`` of
    ``tools/bench_train.py``, mesh (1, 2), both ranks on the same rows),
    3 steps at b4 against the one-process step on the same rows at (e)'s
    f32 bars, the ranks bit-identical, K2 once a step and rank."""
    row = scaleout_check.run(FLAGSHIP, 2, M11B_TP_BATCH, backend="gloo",
                             overrides=["model.compute_dtype=float32"],
                             timeout=GLOO_TIMEOUT_S, model_parallelism=2)
    if (not row["ok"] or row["match_launches"] != [1, 1]
            or not row["model_split_leaves"]):
        raise AssertionError(f"(f) TP 2 on the card: {row}")
    return row, sum(row["match_launches"])


def _m11b_dryrun() -> tuple[dict, int, int]:
    """(g): ``tools/dryrun.dryrun_multichip(4)``: FSDP x TP on a (2, 2)
    mesh of gloo ranks on the one card (NCCL, a card a rank, where four
    are visible), its meshed predict equal to one device's."""
    from ssd_tpu_torch.tools import dryrun
    out = dryrun.dryrun_multichip(4)
    ranks = out["ranks"]
    if any(r["meshed_predict_max_delta"] != 0.0 or not r["tp_sharded_leaves"]
           or r["match_launches"] != 3 or r["nms_launches"] != 2
           for r in ranks):
        raise AssertionError(f"(g) the dry run: {out}")
    return ({"line": out["line"], "backend": out["backend"],
             "k2_per_rank": [r["match_launches"] for r in ranks],
             "k1_per_rank": [r["nms_launches"] for r in ranks]},
            sum(r["match_launches"] for r in ranks),
            sum(r["nms_launches"] for r in ranks))


def _strips_mesh(devices: list) -> "mesh_lib.Mesh":
    return mesh_lib.create_mesh(devices, model_parallelism=len(devices))


def _stream_frames(stream, pool: list) -> tuple[list, float]:
    """``M11B_FRAMES`` frames of ``pool`` through ``stream`` after its
    warmup -> (results as one-row arrays, host ms a frame)."""
    stream.warmup()
    torch.cuda.synchronize()
    out = []
    t0 = time.perf_counter()
    for i in range(M11B_FRAMES):
        out.extend(stream.push(pool[i % len(pool)]))
    out.extend(stream.flush())
    ms = (time.perf_counter() - t0) * 1e3 / M11B_FRAMES
    return [{k: np.asarray(r[k])[None] for k in DET_KEYS} for r in out], ms


def _within_bars(got: dict, want: dict) -> float:
    """The largest score or box distance; raises unless ``num_boxes`` and
    ``labels`` are equal and it is within ``M11B_F32_ATOL``."""
    if not (np.array_equal(got["num_boxes"], want["num_boxes"])
            and np.array_equal(got["labels"], want["labels"])):
        raise AssertionError("split detections differ in count or labels")
    d = max(float(np.abs(got[k] - want[k]).max(initial=0.0))
            for k in ("scores", "boxes"))
    if d > M11B_F32_ATOL:
        raise AssertionError(f"split detections {d} from the unsplit ones")
    return d


def _m11b_stream(cfg: Config, pool: list, devices: list) -> dict:
    """One dtype of (h): the unsplit stream and the stream with each
    frame's rows over ``devices``, the same seeded weights (class bias
    -2.5), ``M11B_FRAMES`` frames each; f32 frames within the spatial
    bars, bf16 frames under ``set_match``; K1 once a frame, and no wait
    for the card under a push (its strips' threads included) in a
    profiled window."""
    plain = StreamingDetector(cfg, None, device=devices[0])
    with torch.no_grad():
        plain.detector.model.head.class_net.predict.bias.fill_(
            FLAGSHIP_CLASS_BIAS)
    state = plain.detector.model.state_dict()
    split = StreamingDetector(cfg, state, mesh=_strips_mesh(devices),
                              spatial_shard=True)
    want, plain_ms = _stream_frames(plain, pool)
    nms_cuda.launches = 0
    got, split_ms = _stream_frames(split, pool)
    launches = nms_cuda.launches
    if launches != M11B_FRAMES + 1:  # and the warmup's frame
        raise AssertionError(f"(h) {launches} K1 launches for "
                             f"{M11B_FRAMES} frames and the warmup")
    row = {"dtype": cfg.model.compute_dtype, "frames": M11B_FRAMES,
           "strips": len(devices), "devices": sorted({str(d)
                                                      for d in devices}),
           "ms_per_frame": split_ms, "unsplit_ms_per_frame": plain_ms,
           "nms_launches": launches - 1,
           "detections": int(sum(int(r["num_boxes"][0]) for r in got))}
    if cfg.model.compute_dtype == "float32":
        row["max_abs_diff"] = max(_within_bars(g, w)
                                  for g, w in zip(got, want))
        row["bar"] = M11B_F32_ATOL
    else:
        matched = total = 0
        for g, w in zip(got, want):
            m, t = set_match(g, w)
            matched, total = matched + m, total + t
        row["set_match"] = [matched, total]
        if total == 0 or matched < M11B_BF16_SHARE * total:
            raise AssertionError(f"(h) bf16 split frames matched "
                                 f"{matched}/{total}")
    summary = bench_streaming.profile_pushes(split, pool, 4)
    stalls = profiling.syncs_under(summary, (PUSH_SPAN, STRIP_SPAN))
    if stalls:
        raise AssertionError(f"(h) a split push waited for the card: "
                             f"{stalls}")
    row["profiled_push_syncs"] = 0
    row["device_ms_per_frame"] = summary["device_busy_ms"] / 4
    return row


def _m11b_predict() -> tuple[dict, int]:
    """(h): the flagship ``Predictor(spatial_shard=True)`` on a (2, 2)
    mesh of the one card at b8 against the plain predictor on the same
    raw uint8 feed, under ``set_match`` (bf16), K1 once a data row."""
    plain = _seeded_flagship()
    state = plain.detector.model.state_dict()
    raw = Predictor(plain.cfg, state, device=DEVICE, packed_ingest=False)
    split = Predictor(plain.cfg, state, spatial_shard=True,
                      mesh=mesh_lib.create_mesh([DEVICE] * 4,
                                                model_parallelism=2))
    images = np.random.default_rng(13).integers(
        0, 256, (M11B_PREDICT_BATCH, *plain.cfg.image_hw(), 3),
        dtype=np.uint8)
    raw.warmup(M11B_PREDICT_BATCH)
    split.warmup(M11B_PREDICT_BATCH)
    raw_ms, want = _host_ms(lambda: raw.predict(images), 3)
    nms_cuda.launches = 0
    split_ms, got = _host_ms(lambda: split.predict(images), 3)
    launches = nms_cuda.launches
    matched, total = set_match(got, want)
    _check_output(got, M11B_PREDICT_BATCH, plain.cfg.nms.max_boxes)
    if launches != 3 * 2 or total == 0 or matched < M11B_BF16_SHARE * total:
        raise AssertionError(f"(h) split flagship predict: {launches} K1 "
                             f"launches, matched {matched}/{total}")
    return {"batch": M11B_PREDICT_BATCH, "mesh": split.mesh.shape,
            "set_match": [matched, total],
            "p50_ms": float(np.median(split_ms)),
            "plain_raw_p50_ms": float(np.median(raw_ms))}, launches


def _m11b_memory(cfg: Config, devices: list) -> dict:
    """Each card's peak memory over one 1024 frame with its rows on
    ``devices`` (a card each), beside one card's for the unsplit frame."""
    frame = np.random.default_rng(21).integers(
        0, 256, (*cfg.image_hw(), 3), dtype=np.uint8)
    plain = Predictor(cfg, None, device=devices[0])
    split = Predictor(cfg, plain.detector.model.state_dict(),
                      spatial_shard=True, mesh=_strips_mesh(devices))
    peaks = {}
    for name, pred in (("one_card", plain), ("split", split)):
        pred.predict(frame)
        torch.cuda.synchronize()
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
        base = [torch.cuda.memory_allocated(d) for d in devices]
        pred.predict(frame)
        for d in devices:
            torch.cuda.synchronize(d)
        peaks[name] = [(torch.cuda.max_memory_allocated(d) - b) / 2 ** 20
                       for d, b in zip(devices, base)]
    one = peaks["one_card"][0]
    return {"devices": [str(d) for d in devices],
            "one_card_peak_mib": one, "split_peak_mib": peaks["split"],
            "split_over_one_card": [p / one for p in peaks["split"]],
            "note": "peak allocated above the weights and buffers held "
                    "before the frame, one warm frame each"}


def phase_scaleout_m11b(power_line: str) -> tuple[dict, dict]:
    """The rest of scale-out on the card: (f) TP 2 at the flagship's full
    width, (g) the FSDP x TP dry run, (h) ``configs/streaming_1024.json``
    streamed with each frame's rows in 4 strips of the one card (f32 and
    bf16) and the flagship's split predict; with four cards visible, (h)'s
    strips on four cards too and each card's peak memory. Returns the K1
    and K2 launches by path."""
    t0 = time.perf_counter()
    tp_row, k2_tp = _m11b_tp(power_line)
    dry_row, k2_dry, k1_dry = _m11b_dryrun()
    cfg = Config.load(STREAMING)
    pool = _stream_pool(cfg)
    one_card = [DEVICE] * M11B_STRIPS
    f32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32"))
    streams = [_m11b_stream(f32, pool, one_card),
               _m11b_stream(cfg, pool, one_card)]
    predict_row, k1_predict = _m11b_predict()
    k1 = {"scaleout_m11b_stream_f32": streams[0]["nms_launches"],
          "scaleout_m11b_stream_bf16": streams[1]["nms_launches"],
          "scaleout_m11b_predict": k1_predict,
          "scaleout_m11b_dryrun_predict": k1_dry}
    row = {"phase": "scaleout_m11b", "card": power_line,
           "tp_f32_flagship": tp_row, "dryrun": dry_row,
           "stream_1024_one_card": streams, "predict_flagship": predict_row}
    if torch.cuda.device_count() >= M11B_STRIPS:
        cards = [torch.device("cuda", i) for i in range(M11B_STRIPS)]
        torch.cuda.empty_cache()
        row["stream_1024_four_cards"] = _m11b_stream(cfg, pool, cards)
        k1["scaleout_m11b_stream_4cards"] = (
            row["stream_1024_four_cards"]["nms_launches"])
        row["memory_1024_four_cards"] = _m11b_memory(cfg, cards)
    k2 = {"scaleout_m11b_tp": k2_tp, "scaleout_m11b_dryrun_steps": k2_dry}
    emit({**row, "launches": {"nms": k1, "match": k2},
          "wall_s": time.perf_counter() - t0,
          "note": "unoptimised eager bring-up reading on " + power_line
                  + "; ms a frame on the host clock, the strips of one "
                  "card sharing its stream"})
    return k1, k2


# ------------------------------------------------------------------ M12: the tools and the demo

TOOLS_SUMMARY_BATCH = 32
TOOLS_TRAIN_IMAGES = 512  # crowded train scenes (the tool's default: 2000)
TOOLS_VAL_IMAGES = 64
TOOLS_STEPS = 100
TOOLS_ARTIFACT_STEPS = 200
TOOLS_HIRES = (4, 1024)  # tiled study: scenes, size
TOOLS_CPU_ROWS = 4  # images of a sweep batch held against the CPU
ANCHOR_SCENES, ANCHOR_BATCH = 64, 16
TRACE_BAR = 0.01  # the trace's device ms against profiling.summarize's
TF_CKPT = os.path.join(ROOT, "ssd_tpu_torch", "assets", "tf_ckpt_v1")


def trace_and_events_check(workdir: str, accum: int = 1) -> dict:
    """A ``train(profile_steps=1)`` run's outputs read back: the per-op
    and per-category tables of ``utils/trace_tools`` over its
    ``profile/trace.json``, their device ms within 1% of
    ``utils/profiling.summarize``'s on the same window and K2's row
    counting the window's launches; its ``tb/`` scalars equal to its
    ``metrics.jsonl`` (at f32, as tfevents stores them)."""
    from ssd_tpu_torch.utils import tensorboard, trace_tools

    with open(os.path.join(workdir, "profile", "summary.json")) as f:
        prof = json.load(f)
    t = trace_tools.tables(trace_tools.find_trace(
        os.path.join(workdir, "profile")), device="cuda")
    k2 = sum(op["calls"] for op in t["ops"] if "match_kernel" in op["name"])
    rel = abs(t["total_ms"] / prof["device_busy_ms"] - 1)
    if rel > TRACE_BAR or k2 != accum:
        raise AssertionError(f"trace tables: {t['total_ms']} ms against "
                             f"{prof['device_busy_ms']}, K2 calls {k2}")
    (events,) = glob.glob(os.path.join(workdir, "tb",
                                       "events.out.tfevents.*"))
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    want = [(r["step"], k, float(np.float32(v))) for r in records
            for k, v in r.items()
            if k != "step" and isinstance(v, (int, float))]
    got = tensorboard.read_scalars(events)
    if got != want or not want:
        raise AssertionError(f"tb/ holds {len(got)} scalars, metrics.jsonl "
                             f"{len(want)}")
    return {"trace_device_ms": t["total_ms"],
            "profiling_device_busy_ms": prof["device_busy_ms"],
            "relative_gap": rel, "by_category_ms": t["by_category_ms"],
            "top_ops": [{k: op[k] for k in ("name", "category", "ms",
                                            "calls")}
                        for op in t["ops"][:8]],
            "k2_calls": k2, "tb_scalars": len(got),
            "tb_equal_metrics_jsonl": True}


def _tools_summarize(power_line: str) -> tuple[dict, int, int]:
    """``tools/summarize.py`` on the flagship at b32, serve and train, its
    roofline beside the same predict's device ms."""
    from ssd_tpu_torch.tools import summarize

    cfg = Config.load(FLAGSHIP)
    nms_cuda.launches = matching_cuda.launches = 0
    t0 = time.perf_counter()
    b = TOOLS_SUMMARY_BATCH
    r = summarize.summarize(cfg, batch=b, train=True, device=DEVICE)
    seconds = time.perf_counter() - t0
    nms_n, match_n = nms_cuda.launches, matching_cuda.launches
    det = Detector(cfg, device=DEVICE)
    images = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (b, *cfg.image_hw(), 3), dtype=np.uint8)).to(DEVICE)
    with torch.inference_mode():
        measured = cuda_ms(lambda: det.predict(images), iters=5)
    serve = r["serve"]
    row = {"config": os.path.relpath(FLAGSHIP, ROOT), "batch": b,
           "params": r["params"]["total"], "seconds": seconds,
           **{name: {k: r[name][k] for k in (
               "flops", "bytes", "flops_by_class", "arithmetic_intensity",
               "bound", "roofline_ms", "roofline_img_per_s",
               "flops_per_image_g")} for name in ("serve", "train")},
           "serve_measured_device_ms": measured,
           "measured_over_roofline": measured / serve["roofline_ms"],
           "flagship_serve_device_ms": MEASURED.get("flagship"),
           "card": power_line}
    if not (serve["flops"] > 0 and r["train"]["flops"]
            > 1.5 * serve["flops"] and nms_n == 1 and match_n == 1):
        raise AssertionError(f"summarize: {row}, K1 {nms_n}, K2 {match_n}")
    return row, nms_n, match_n


def _tools_anchors(root: str) -> tuple[dict, int]:
    """``tools/analyze_anchors.py`` on the flagship at 640 over 64 seeded
    80-class crowded scenes: K2 once a batch on the card, the report equal
    to the CPU's plain matcher's on the same file."""
    import io

    from PIL import Image

    from ssd_tpu_torch.data.tfrecord import (RecordWriter,
                                             encode_detection_example)
    from ssd_tpu_torch.tools import analyze_anchors

    cfg = Config.load(FLAGSHIP)
    path = os.path.join(root, "anchors-00000-of-00001")
    rng = np.random.default_rng(CROWDED_SEED)
    with RecordWriter(path) as w:
        for _ in range(ANCHOR_SCENES):
            img, boxes, labels = synthetic.crowded_example(rng, 80, 640)
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, "JPEG", quality=95)
            w.write(encode_detection_example(buf.getvalue(), boxes, labels,
                                             image_hw=(640, 640)))
    matching_cuda.launches = 0
    t0 = time.perf_counter()
    card = analyze_anchors.analyze(cfg, data_pattern=path,
                                   batch_size=ANCHOR_BATCH, device=DEVICE)
    card_s = time.perf_counter() - t0
    launches = matching_cuda.launches
    t0 = time.perf_counter()
    cpu = analyze_anchors.analyze(cfg, data_pattern=path,
                                  batch_size=ANCHOR_BATCH, device="cpu")
    cpu_s = time.perf_counter() - t0
    if card != cpu or launches != ANCHOR_SCENES // ANCHOR_BATCH:
        raise AssertionError(f"anchors: card {card}, cpu {cpu}, "
                             f"K2 {launches}")
    return {"report": card, "equal_to_cpu": True, "card_s": card_s,
            "cpu_s": cpu_s}, launches


def _hard_rows_vs_cpu(cfg: Config, checks: dict):
    """A ``run_sweep`` hook: on the first batch, each hard row's card
    detections of ``TOOLS_CPU_ROWS`` images against the CPU plain
    version's on the same raw maps, under the golden set rule."""
    from ssd_tpu_torch.tools import crowded_validation as crowded

    anchors = torch.from_numpy(generate_anchors(cfg.image_size, cfg.anchors))
    cpu_variants = crowded.variant_postprocessors(
        types.SimpleNamespace(anchors=anchors), cfg)

    def hook(images, raw, outputs):
        if checks:
            return
        n = TOOLS_CPU_ROWS
        cpu_raw = [(c[:n].cpu(), b[:n].cpu()) for c, b in raw]
        logits, deltas = flatten_levels(cpu_raw, cfg.num_classes)
        for name, kind, fn in cpu_variants:
            if "soft" in name:
                continue
            with torch.inference_mode():
                want = fn(logits, deltas) if kind == "flat" else fn(cpu_raw)
            got = outputs[name]
            checks[name] = set_match(
                {k: getattr(got, k)[:n].cpu().numpy() for k in DET_KEYS},
                {k: getattr(want, k).numpy() for k in DET_KEYS})
    return hook


def _tools_crowded(root: str) -> tuple[dict, dict, Config, dict]:
    """``tools/crowded_validation.py`` at its full width (256 px, x0.5,
    FPN 64, 40 classes): trained 100 steps from tfrecords (one step
    profiled), then the 24 variants over 64 val scenes. Returns (row,
    launches by kind, config, state)."""
    from ssd_tpu_torch.tools import crowded_validation as crowded

    workdir = os.path.join(root, "crowd")
    t0 = time.perf_counter()
    crowded.prepare(workdir, TOOLS_TRAIN_IMAGES, TOOLS_VAL_IMAGES)
    write_s = time.perf_counter() - t0
    cfg = crowded.make_config(workdir, TOOLS_STEPS)
    rundir = os.path.join(workdir, "run")
    matching_cuda.launches = 0
    t0 = time.perf_counter()
    # logged every 10 steps (the tool's 100), for the tb/ check
    train(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, log_every=10)), rundir, max_steps=TOOLS_STEPS,
        device=DEVICE, profile_steps=1)
    train_s = time.perf_counter() - t0
    train_k2 = matching_cuda.launches
    if train_k2 != TOOLS_STEPS:
        raise AssertionError(f"crowded training: {train_k2} K2 launches")
    _, state = load_inference_artifact(os.path.join(rundir, EXPORT_NAME))
    checks: dict = {}
    nms_cuda.launches = 0
    t0 = time.perf_counter()
    rows = crowded.run_sweep(cfg, state, cfg.data.val_file_pattern,
                             TOOLS_VAL_IMAGES, device=DEVICE,
                             on_batch=_hard_rows_vs_cpu(cfg, checks))
    sweep_s = time.perf_counter() - t0
    sweep_k1 = nms_cuda.launches
    batches = -(-TOOLS_VAL_IMAGES // 16)
    hard = [r["variant"] for r in rows if "soft" not in r["variant"]]
    crowded.print_table(rows)
    bad = {k: v for k, v in checks.items() if v[0] != v[1]}
    if (len(rows) != 24 or len(hard) != 21 or sweep_k1 != 21 * batches
            or sorted(checks) != sorted(hard) or bad
            or not all(np.isfinite(r["mAP"]) for r in rows)):
        raise AssertionError(f"crowded sweep: K1 {sweep_k1}, hard rows "
                             f"unmatched on the CPU {bad}, rows {rows}")
    row = {"config": "crowded_validation.make_config (256 px, x0.5, FPN 64, "
                     "40 classes)",
           "train_images": TOOLS_TRAIN_IMAGES, "val_images": TOOLS_VAL_IMAGES,
           "steps": TOOLS_STEPS, "write_s": write_s, "train_s": train_s,
           "sweep_s": sweep_s, "rows": rows,
           "hard_rows_vs_cpu": {k: f"{v[0]}/{v[1]}"
                                for k, v in checks.items()},
           "trace_and_events": trace_and_events_check(rundir)}
    return row, {"train_k2": train_k2, "sweep_k1": sweep_k1}, cfg, state


def _tools_tiled(cfg: Config, state: dict) -> tuple[dict, int]:
    """``tools/tiled_validation.py`` on the sweep's weights: 4 scenes at
    1024 px, the three ablations too."""
    from ssd_tpu_torch.tools import tiled_validation

    scenes, size = TOOLS_HIRES
    args = types.SimpleNamespace(ablate=True, hires_size=size,
                                 val_images=scenes)
    nms_cuda.launches = 0
    rows = tiled_validation.evaluate_variants(state, cfg, args,
                                              device=DEVICE)
    launches = nms_cuda.launches
    tiled_validation.print_rows(rows)
    if launches != (1 + scenes) * len(rows) or len(rows) != 5:
        raise AssertionError(f"tiled: K1 {launches}, rows {rows}")
    return {"scenes": scenes, "hires_size": size, "rows": rows}, launches


def _tools_calibration(root: str, crowd_dir: str) -> tuple[dict, int, int]:
    """``tools/calibration_study.py``: its dense4 model trained 100 steps,
    then bf16 and one int8 regime (8 train images, absmax)."""
    from ssd_tpu_torch.tools import calibration_study as study

    cfg = study.dense4_config(crowd_dir, TOOLS_STEPS)
    rundir = os.path.join(root, "calib_run")
    matching_cuda.launches = 0
    t0 = time.perf_counter()
    train(cfg, rundir, max_steps=TOOLS_STEPS, device=DEVICE)
    train_s = time.perf_counter() - t0
    k2 = matching_cuda.launches
    _, state = load_inference_artifact(os.path.join(rundir, EXPORT_NAME))
    nms_cuda.launches = 0
    bf16 = study.eval_map(cfg, state, cfg.data.val_file_pattern,
                          TOOLS_VAL_IMAGES, DEVICE)
    batches = study._batches_from(cfg.data.train_file_pattern, cfg, 8)
    seen, m8 = study.int8_map(cfg, state, batches, None,
                              cfg.data.val_file_pattern, TOOLS_VAL_IMAGES,
                              DEVICE)
    k1 = nms_cuda.launches
    want_k1 = 2 * -(-TOOLS_VAL_IMAGES // 16)
    if k2 != TOOLS_STEPS or k1 != want_k1 or not np.isfinite(m8):
        raise AssertionError(f"calibration: K2 {k2}, K1 {k1}, int8 {m8}")
    rows = [{"regime": "bf16 baseline", "mAP": bf16, "d_mAP": 0.0},
            {"regime": f"int8 cal=train n={seen} clip=absmax", "mAP": m8,
             "d_mAP": m8 - bf16}]
    study.print_rows(rows)
    return {"steps": TOOLS_STEPS, "train_s": train_s, "rows": rows}, k1, k2


def _tools_artifact(root: str) -> tuple[dict, int, int]:
    """``tools/make_bench_artifact.py``: 200 steps from ``--seed 0``."""
    from ssd_tpu_torch.tools import make_bench_artifact

    nms_cuda.launches = matching_cuda.launches = 0
    t0 = time.perf_counter()
    r = make_bench_artifact.main(["--out", os.path.join(root, "sanity_art"),
                                  "--steps", str(TOOLS_ARTIFACT_STEPS),
                                  "--seed", "0", "--device", str(DEVICE)])
    seconds = time.perf_counter() - t0
    k1, k2 = nms_cuda.launches, matching_cuda.launches
    losses = r["losses"]
    if (k2 != TOOLS_ARTIFACT_STEPS or k1 < 1 or not np.isfinite(losses).all()
            or r["dtype"] != "bf16"):
        raise AssertionError(f"make_bench_artifact: {r}, K1 {k1}, K2 {k2}")
    return {"steps": TOOLS_ARTIFACT_STEPS, "seed": 0,
            "losses": {i: losses[i] for i in (0, 100, len(losses) - 1)},
            "sanity_map_bf16": r["sanity_map"], "seconds": seconds}, k1, k2


def _tools_import(root: str) -> tuple[dict, int]:
    """``tools/import_tf.py`` on the committed TF1 checkpoint: the artifact
    served on the card (K1) equal to the CPU's predict of it."""
    from ssd_tpu_torch.tools import import_tf

    out = os.path.join(root, "imported")
    import_tf.main(["--config", os.path.join(TF_CKPT, "config.json"),
                    "--tf-ckpt", os.path.join(TF_CKPT, "model.ckpt"),
                    "--name-map", os.path.join(TF_CKPT, "name_map.json"),
                    "--output", out])
    card = Predictor.from_checkpoint(out, device=DEVICE)
    cpu = Predictor.from_checkpoint(out, device="cpu")
    h, w = card.cfg.image_hw()
    images = np.random.default_rng(2).integers(0, 256, (8, h, w, 3),
                                               dtype=np.uint8)
    nms_cuda.launches = 0
    got = card.predict(images)
    launches = nms_cuda.launches
    matched, total = set_match(got, cpu.predict(images))
    if launches != 1 or matched != total or not total:
        raise AssertionError(f"import_tf: {matched}/{total}, K1 {launches}")
    return {"checkpoint": os.path.relpath(TF_CKPT, ROOT),
            "tensors": len(import_tf.TensorBundle(
                os.path.join(TF_CKPT, "model.ckpt")).names()),
            "card_vs_cpu": f"{matched}/{total}"}, launches


def _tools_demo(root: str) -> tuple[dict, int]:
    """``python -m ssd_tpu_torch.demo --selftest`` on the card."""
    from PIL import Image

    from ssd_tpu_torch import demo

    png = os.path.join(root, "demo.png")
    nms_cuda.launches = 0
    out = demo.main(["--selftest", "--output", png, "--device",
                     str(DEVICE)])
    launches = nms_cuda.launches
    shape = np.asarray(Image.open(png)).shape
    if launches != 1 or shape != (480, 640, 3):
        raise AssertionError(f"demo: K1 {launches}, png {shape}")
    return {"png": list(shape), "detections": int(out["num_boxes"])}, launches


def phase_tools_m12(power_line: str) -> tuple[dict, dict]:
    """M12 and the demo on the card (module docstring, phase 10). Returns
    the K1 and the K2 launches by row."""
    root = tempfile.mkdtemp(prefix="ssd_tools_")
    nms_by, match_by, rows = {}, {}, {}
    t_phase = time.perf_counter()
    try:
        rows["summarize"], nms_by["summarize"], match_by["summarize"] = \
            _tools_summarize(power_line)
        rows["analyze_anchors"], match_by["analyze_anchors"] = \
            _tools_anchors(root)
        rows["crowded_sweep"], k, cfg, state = _tools_crowded(root)
        match_by["crowded_train"], nms_by["crowded_sweep"] = (
            k["train_k2"], k["sweep_k1"])
        rows["tiled_validation"], nms_by["tiled_validation"] = \
            _tools_tiled(cfg, state)
        (rows["calibration_study"], nms_by["calibration_study"],
         match_by["calibration_train"]) = _tools_calibration(
             root, os.path.join(root, "crowd"))
        (rows["make_bench_artifact"], nms_by["make_bench_artifact"],
         match_by["make_bench_artifact"]) = _tools_artifact(root)
        rows["import_tf"], nms_by["import_tf"] = _tools_import(root)
        rows["demo"], nms_by["demo"] = _tools_demo(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "tools_m12", "card": power_line,
          "seconds": time.perf_counter() - t_phase, **rows,
          "nms_launches": nms_by, "match_launches": match_by})
    return ({f"tools_{k}": v for k, v in nms_by.items()},
            {f"tools_{k}": v for k, v in match_by.items()})


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
    if sys.argv[1:] == ["--phase", "scaleout"]:  # that phase alone
        phase_scaleout(power_line)
        return 0
    if sys.argv[1:] == ["--phase", "scaleout_m11b"]:  # that phase alone
        phase_scaleout_m11b(power_line)
        return 0
    if sys.argv[1:] == ["--phase", "conv_s8"]:  # that phase alone
        phase_conv_s8(power_line)
        return 0
    if sys.argv[1:] == ["--phase", "int8"]:  # the phases that serve int8
        phase_int8_sanity(power_line)
        phase_gemm_exact(power_line)
        phase_serve("int8_flagship", FLAGSHIP, power_line, int8=True)
        for name, (path, batch) in NEW_CONFIGS.items():
            phase_serve(f"int8_{name}", os.path.join(ROOT, "configs", path),
                        power_line, int8=True, batch=batch)
        phase_serve_pipelined(power_line)
        phase_tiled(power_line)
        phase_streaming(power_line)
        phase_export(power_line)
        phase_conv_s8(power_line)
        return 0
    if sys.argv[1:] == ["--phase", "tools_m12"]:  # that phase alone
        phase_tools_m12(power_line)
        return 0

    phase_host_ingest(power_line)
    main_nms, nms_shapes = phase_nms()
    phase_sanity()
    nms_launches_golden = phase_serve_golden()
    nms_launches_int8_sanity = phase_int8_sanity(power_line)
    phase_gemm_exact(power_line)
    nms_launches = phase_serve("flagship", FLAGSHIP, power_line)
    nms_launches_int8 = phase_serve("int8_flagship", FLAGSHIP, power_line,
                                    int8=True)
    nms_launches_reference = phase_serve("reference_serve", REFERENCE,
                                         power_line)
    nms_launches_pipelined = phase_serve_pipelined(power_line)
    phase_reference_golden()
    nms_launches_bb, match_launches_bb = phase_backbones_golden()
    nms_launches_new = {
        f"serve_{name}": phase_serve(
            f"serve_{name}", os.path.join(ROOT, "configs", path), power_line,
            batch=batch)
        for name, (path, batch) in NEW_CONFIGS.items()}
    nms_launches_new.update({
        f"int8_{name}": phase_serve(
            f"int8_{name}", os.path.join(ROOT, "configs", path), power_line,
            int8=True, batch=batch)
        for name, (path, batch) in NEW_CONFIGS.items()})
    nms_launches_new.update(phase_select_paths(power_line))
    nms_launches_new["tiled"] = phase_tiled(power_line)
    (nms_launches_new["tta"],
     nms_launches_new["tta_daemon"]) = phase_tta(power_line)
    nms_launches_new.update(phase_streaming(power_line))
    nms_launches_new["export"] = phase_export(power_line)
    main_early, early_launches = phase_fused_early(power_line)
    main_conv = phase_conv_s8(power_line)
    main_match = phase_match()
    phase_train_sanity()
    match_launches, flagship_p50 = phase_train_flagship(power_line)
    match_launches_new = {
        f"train_{name}": phase_train_flagship(
            power_line, warmup=2, timed=4,
            config=os.path.join(ROOT, "configs", path),
            phase=f"train_{name}")[0]
        for name, (path, _) in NEW_CONFIGS.items()}
    match_launches_new["train_memory"] = phase_train_memory(power_line)
    (match_launches_pipeline, nms_launches_train,
     nms_launches_eval_golden, nms_launches_new["eval_cli"]) = \
        phase_train_pipeline(power_line, flagship_p50)
    nms_launches_tools, match_launches_tools = phase_tools_m12(power_line)
    nms_launches_new.update(nms_launches_tools)
    match_launches_new.update(match_launches_tools)
    nms_launches_scaleout, match_launches_scaleout = phase_scaleout(
        power_line)
    nms_launches_new.update(nms_launches_scaleout)
    match_launches_new.update(match_launches_scaleout)
    nms_launches_m11b, match_launches_m11b = phase_scaleout_m11b(power_line)
    nms_launches_new.update(nms_launches_m11b)
    match_launches_new.update(match_launches_m11b)

    emit({"kernels": [{
        "name": "nms", "route": "cuda", "source": "ssd_tpu_torch/csrc/nms.cu",
        "replaces": "ssd_tpu/ops/nms_pallas.py:78",
        "launches": (nms_launches + nms_launches_int8
                     + nms_launches_reference + nms_launches_int8_sanity
                     + nms_launches_golden + nms_launches_pipelined
                     + nms_launches_train + nms_launches_eval_golden
                     + nms_launches_bb + sum(nms_launches_new.values())),
        "launches_by_path": {
            "flagship": nms_launches, "int8_flagship": nms_launches_int8,
            "reference_serve": nms_launches_reference,
            "int8_sanity": nms_launches_int8_sanity,
            "serve_golden": nms_launches_golden,
            "serve_pipelined": nms_launches_pipelined,
            "train_pipeline": nms_launches_train,
            "eval_golden": nms_launches_eval_golden,
            "backbones_golden": nms_launches_bb, **nms_launches_new},
        "max_abs_err": main_nms["max_abs_err"], "ms": main_nms["ms"],
        "timing": main_nms["timing"], "call_ms": main_nms["call_ms"],
        "plain_ms": main_nms["plain_ms"], "bound_ms": main_nms["bound_ms"],
        "bound_by": main_nms["bound_by"], "library_ms": None,
        "by_shape": nms_shapes, "ptxas": ptxas.get("nms")}, {
        "name": "match", "route": "cuda",
        "source": "ssd_tpu_torch/csrc/match.cu",
        "replaces": "ssd_tpu/ops/matching_pallas.py:60",
        "launches": (match_launches + match_launches_pipeline
                     + match_launches_bb + sum(match_launches_new.values())),
        "launches_by_path": {"train_flagship": match_launches,
                             "train_pipeline": match_launches_pipeline,
                             "backbones_golden": match_launches_bb,
                             **match_launches_new},
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
        "library_ms": None, "ptxas": ptxas.get("fused_early")}, {
        "name": "conv_s8", "route": "cuda",
        "source": "ssd_tpu_torch/csrc/conv_s8.cu",
        "replaces": None, "replaces_note": "no TPU kernel: the JAX package "
        "leaves its int8 convs to XLA (ssd_tpu/models/layers.py "
        "_quantized_conv); it replaces the port's im2col + _int_mm "
        "composition, kept as the plain version",
        "launches": main_conv["counts"]["launches"],
        "forward_ms": main_conv["summary"]["forward_k4_ms"],
        "forward_bound_ms": main_conv["summary"]["forward_bound_ms"],
        "by_shape": main_conv["shapes"],
        "models_bit_equal": [m["config"] for m in main_conv["models"]],
        "library_ms": {"torch._int_mm on the im2col": sum(
            r["library_ms"] * r["count"] for r in main_conv["shapes"])},
        "ptxas": ptxas.get("conv_s8")}]})
    print(power_line)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
