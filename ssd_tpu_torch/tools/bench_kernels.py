"""Device time of the NMS kernel (K1, ``csrc/nms.cu``), the matching
kernel (K2, ``csrc/match.cu``) and the fused ds1+ds2 kernel (K3,
``csrc/fused_early.cu``) at the main paths' shapes, by two methods:

- ``ms``: ``CALLS`` calls of the wrapper captured once in a CUDA graph, the
  graph replayed between CUDA events: the device time of the wrapper's
  kernels alone (for K2 the key fill, the matching kernel and the unpack);
- ``call_ms``: back-to-back eager calls of the wrapper between CUDA events:
  what a caller pays a call, the wrapper's host work included.

    python -m ssd_tpu_torch.tools.bench_kernels [--baseline DIR]

The shapes are the serving one for K1 (32 images, 1024 clustered
candidates, 80 classes, K = 128), the flagship training one for K2 (64
crowded 640 px scenes, 76 725 anchors, M = 100) and served_b32 for K3
(32 x 32 x 320 x 320 bf16: the stem output of a 640 px batch, drawn from a
seed; the seeded x1.0 backbone of ``bench_fused_early.reference_backbone``
with its ds1/ds2 batch norm randomized by ``randomize_early_bn``). With
``--baseline``, the ``nms.cu``, ``match.cu`` and ``fused_early.cu`` in
``DIR`` (another version of the kernels with the same C interfaces) are
built too and timed the same way in the same process, in turns (baseline,
current, current, baseline). K1's and K2's outputs are held equal to the
current kernels'; K3's within the JAX bars (atol 0.08, rtol 0.05), since
its arithmetic changed between versions (bf16 pointwise operands since the
tensor-core design). Prints one JSON line. Runs on the card and raises
without one.

``chip_smoke.py`` times K1, K2 and K3 with ``kernel_ms``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

from ssd_tpu_torch import _build
from ssd_tpu_torch.config import Config, NMSConfig
from ssd_tpu_torch.data import synthetic
from ssd_tpu_torch.ops import fused_early_cuda, matching_cuda, nms, nms_cuda
from ssd_tpu_torch.ops.anchors import generate_anchors
from ssd_tpu_torch.ops.fused_early import fold_early_params
from ssd_tpu_torch.tools import bench_fused_early, kernel_cases
from ssd_tpu_torch.tools.bench_fused_early import cuda_ms

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FLAGSHIP = os.path.join(_ROOT, "configs", "coco_mobilenet_640_flagship.json")
# calls captured in one graph, and replays of it
CALLS = 20
REPLAYS = 20


def graph_ms(fn) -> float:
    """Mean device milliseconds of one ``fn()``: ``CALLS`` calls captured
    in a CUDA graph once, after two eager warm-up calls, and the graph
    replayed ``REPLAYS`` times between CUDA events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (CALLS * REPLAYS)


def kernel_ms(fn) -> dict:
    """``ms`` by graph replay and ``call_ms`` by eager calls of ``fn``."""
    return {"ms": graph_ms(fn), "timing": "graph replay",
            "call_ms": cuda_ms(fn, iters=200)}


def nms_serve_inputs(device: torch.device):
    """The serving shape's suppression inputs: ``(boxes, top_idx,
    top_scores, iou_threshold)``."""
    case = kernel_cases.nms_cases(32, 1024, 80, max_k=32)[0]
    cfg = NMSConfig(**case.cfg)
    boxes = torch.from_numpy(case.boxes).to(device)
    top_scores, top_idx = nms.class_topk(
        torch.from_numpy(case.scores).to(device), cfg)
    return boxes, top_idx, top_scores, cfg.iou_threshold


def match_flagship_inputs(device: torch.device):
    """The flagship training shape's matching inputs: ``(anchors, gts,
    num_boxes)``."""
    cfg = Config.load(FLAGSHIP)
    b = synthetic.crowded_batch(0, 0, cfg.train.batch_size, cfg.image_hw()[0],
                                cfg.num_classes, cfg.data.max_gt_boxes)
    anchors = generate_anchors(cfg.image_size, cfg.anchors)
    return tuple(torch.from_numpy(x).to(device)
                 for x in (anchors, b["boxes"], b["num_boxes"]))


def early_inputs(device, batch: int = 32, size: int = 320,
                 width: float = 1.0):
    """K3's served_b32 inputs (or a smaller ``batch``, ``size`` and
    ``width``): ``(backbone, x, folded)``, the backbone seeded from 0 with
    its ds1/ds2 batch norm randomized from seed 3, ``x`` a seeded normal
    ``(batch, C1, size, size)`` bf16 batch in ``channels_last``."""
    backbone = bench_fused_early.reference_backbone(width, seed=0,
                                                    device=device)
    bench_fused_early.randomize_early_bn(backbone, seed=3)
    c1 = backbone.ds1.depthwise.conv.weight.shape[0]
    x = bench_fused_early.make_input(batch, size, c1, seed=0, device=device)
    return backbone, x, fold_early_params(backbone)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="a directory with nms.cu, match.cu "
                    "and fused_early.cu to time beside the package's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_kernels times the card: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    libs = {"current": (nms_cuda._library(), matching_cuda._library(),
                        fused_early_cuda._library())}
    if args.baseline:
        base = os.path.abspath(args.baseline)
        _build.build_all(["nms", "match", "fused_early"], csrc_dir=base)
        libs["baseline"] = (
            nms_cuda.bind(ctypes.CDLL(_build.target("nms", base))),
            matching_cuda.bind(ctypes.CDLL(_build.target("match", base))),
            fused_early_cuda.bind(ctypes.CDLL(_build.target("fused_early",
                                                            base))))

    nms_in = nms_serve_inputs(dev)
    match_in = match_flagship_inputs(dev)
    want_nms = nms_cuda.suppress_cuda(*nms_in)
    want_match = matching_cuda.match_core_cuda(*match_in)
    _, early_x, early_folded = early_inputs(dev)
    want_early = fused_early_cuda.fused_ds1_ds2_cuda(early_x, early_folded)
    order = (["baseline", "current", "current", "baseline"] if args.baseline
             else ["current"])
    rows = {k: {"nms": [], "match": [], "fused_early": []} for k in libs}
    early_diff = {}
    for label in order:
        nms_lib, match_lib, early_lib = libs[label]
        got_nms = nms_cuda.suppress_cuda(*nms_in, lib=nms_lib)
        got_match = matching_cuda.match_core_cuda(*match_in, lib=match_lib)
        got_early = fused_early_cuda.fused_ds1_ds2_cuda(
            early_x, early_folded, lib=early_lib)
        torch.cuda.synchronize()
        if not torch.equal(got_nms, want_nms) or not all(
                torch.equal(g, w) for g, w in zip(got_match, want_match)):
            raise AssertionError(f"{label} kernels differ from current")
        if not torch.allclose(got_early.float(), want_early.float(),
                              atol=0.08, rtol=0.05):
            raise AssertionError(f"{label} fused_early is off the JAX bars")
        early_diff[label] = {
            "max_abs_diff": float((got_early.float()
                                   - want_early.float()).abs().max()),
            "bit_equal_share": float((got_early == want_early).float()
                                     .mean())}
        rows[label]["nms"].append(kernel_ms(
            lambda: nms_cuda.suppress_cuda(*nms_in, lib=nms_lib)))
        rows[label]["match"].append(kernel_ms(
            lambda: matching_cuda.match_core_cuda(*match_in, lib=match_lib)))
        rows[label]["fused_early"].append(kernel_ms(
            lambda: fused_early_cuda.fused_ds1_ds2_cuda(
                early_x, early_folded, lib=early_lib)))
    print(json.dumps({
        "device": torch.cuda.get_device_name(dev), "nvidia_smi": smi,
        "nms_shape": {"N": 32, "Q": 1024, "C": 80, "K": 128},
        "match_shape": {"N": int(match_in[1].shape[0]),
                        "A": int(match_in[0].shape[0]),
                        "M": int(match_in[1].shape[1])},
        "fused_early_shape": list(early_x.shape),
        "outputs_equal": True, "fused_early_vs_current": early_diff,
        "order": order, "runs": rows,
        # what this process built, by source
        "ptxas": {k: _build.ptxas_lines(v)
                  for k, v in _build.build_logs.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
