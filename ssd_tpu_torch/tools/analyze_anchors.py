"""Anchor coverage: how well the anchor spec fits a dataset (the port's
``ssd_tpu/tools/analyze_anchors.py``).

A gt whose best anchor IoU is under ``matching_threshold`` is learned
only through the forced match (one anchor), and a gt below every anchor's
reach caps recall before training starts. This tool runs the production
matcher (``ops/matching_cuda.match_anchors``: the matching kernel on the
card, its plain version on the CPU; force-match and ignore band included)
over a dataset read by ``data/pipeline.Pipeline`` and reports, with the
JAX tool's keys and rounding:

* matched-gt recall (gts with an anchor at or above the threshold),
  overall and by COCO size bucket at the configured input size;
* the best-IoU distribution over gts (mean, p10, p50) and the uncovered
  tail (best IoU under 0.1);
* the share of gts learned only through the forced match;
* positives and ignored anchors an image, and the positives' split over
  the FPN levels.

The IoUs and the matches are computed on the device, a batch at a time,
and read back once a batch for the per-image tallies.

    python -m ssd_tpu_torch.tools.analyze_anchors --config cfg.json \\
        [--split val|train] [--data "tfrecord-glob"] [--limit N] \\
        [--batch-size N] [--json out.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.data.pipeline import Pipeline
from ssd_tpu_torch.device import resolve_device
from ssd_tpu_torch.ops.anchors import anchor_counts_per_level, generate_anchors
from ssd_tpu_torch.ops.box_utils import iou
from ssd_tpu_torch.ops.matching_cuda import match_anchors

# COCO area buckets in pixels^2, evaluated at the configured input size
_AREA_BUCKETS = (("small", 0.0, 32.0**2), ("medium", 32.0**2, 96.0**2),
                 ("large", 96.0**2, float("inf")))


@dataclasses.dataclass
class _Acc:
    n_gts: int = 0
    n_images: int = 0
    n_matched: int = 0            # gts with >= 1 anchor above threshold
    n_forced_only: int = 0        # gts learned only through force-match
    best_ious: list = dataclasses.field(default_factory=list)
    positives: list = dataclasses.field(default_factory=list)
    ignored: list = dataclasses.field(default_factory=list)
    level_pos: np.ndarray | None = None
    bucket_gts: dict = dataclasses.field(
        default_factory=lambda: {k: 0 for k, *_ in _AREA_BUCKETS})
    bucket_matched: dict = dataclasses.field(
        default_factory=lambda: {k: 0 for k, *_ in _AREA_BUCKETS})


def _device_stats(anchors: torch.Tensor, gt: np.ndarray, num: np.ndarray,
                  cfg: Config) -> tuple[np.ndarray, np.ndarray]:
    """On the device: each gt's best anchor IoU ``(N, M)`` and the
    production matches ``(N, A)``, read back in one copy."""
    dev = anchors.device
    gt_t = torch.from_numpy(np.ascontiguousarray(gt, np.float32)).to(dev)
    num_t = torch.from_numpy(np.asarray(num, np.int32)).to(dev)
    best_per_gt = iou(anchors[None], gt_t).amax(dim=1)          # (N, M)
    matches = match_anchors(anchors, gt_t, num_t, cfg.matcher)  # (N, A)
    m = best_per_gt.shape[1]
    # gt indices and -1/-2 are exact in f32
    both = torch.cat([best_per_gt, matches.float()], dim=1).cpu().numpy()
    return both[:, :m], both[:, m:].astype(np.int32)


def _batch_stats(anchors, level_edges, cfg, gt, num, acc: _Acc):
    ih, iw = cfg.image_hw()
    best_per_gt, matches = _device_stats(anchors, gt, num, cfg)
    thr = cfg.matcher.matching_threshold
    for i in range(gt.shape[0]):
        k = int(num[i])
        if k == 0:
            acc.n_images += 1
            acc.positives.append(0)
            acc.ignored.append(int((matches[i] == -2).sum()))
            continue
        bi = best_per_gt[i, :k]
        acc.best_ious.extend(bi.tolist())
        acc.n_gts += k
        acc.n_matched += int((bi >= thr).sum())
        # a gt under the threshold still appears in the matches by force
        gt_ids, counts = np.unique(matches[i][matches[i] >= 0],
                                   return_counts=True)
        claimed = dict(zip(gt_ids.tolist(), counts.tolist()))
        for j in range(k):
            if bi[j] < thr and claimed.get(j, 0) > 0:
                acc.n_forced_only += 1
        h = (gt[i, :k, 2] - gt[i, :k, 0]) * ih
        w = (gt[i, :k, 3] - gt[i, :k, 1]) * iw
        areas = h * w
        for name, lo, hi in _AREA_BUCKETS:
            sel = (areas >= lo) & (areas < hi)
            acc.bucket_gts[name] += int(sel.sum())
            acc.bucket_matched[name] += int((bi[sel] >= thr).sum())

        pos = matches[i] >= 0
        acc.positives.append(int(pos.sum()))
        acc.ignored.append(int((matches[i] == -2).sum()))
        if acc.level_pos is None:
            acc.level_pos = np.zeros(len(level_edges) - 1, np.int64)
        for li in range(len(level_edges) - 1):
            acc.level_pos[li] += int(
                pos[level_edges[li]:level_edges[li + 1]].sum())
        acc.n_images += 1


def analyze(cfg: Config, split: str = "val", limit: int = 0,
            batch_size: int = 16, data_pattern: str = "",
            device=None) -> dict:
    """The coverage report of ``data_pattern`` (or the config's ``split``
    pattern), the first ``limit`` images (0: all), on ``device``
    (``None``: the card)."""
    pattern = data_pattern or (
        cfg.data.val_file_pattern if split == "val"
        else cfg.data.train_file_pattern)
    pipe = Pipeline(pattern, cfg, is_training=False, batch_size=batch_size)
    anchors_np = generate_anchors(cfg.image_size, cfg.anchors)
    anchors = torch.from_numpy(anchors_np).to(resolve_device(device))
    counts = anchor_counts_per_level(cfg.image_size, cfg.anchors)
    level_edges = np.concatenate([[0], np.cumsum(counts)])

    acc = _Acc()
    seen = 0
    for batch in pipe:
        keep = batch["valid"]
        gt = batch["boxes"][keep]
        num = batch["num_boxes"][keep]
        if limit and seen + len(gt) > limit:
            gt, num = gt[: limit - seen], num[: limit - seen]
        if len(gt):
            _batch_stats(anchors, level_edges, cfg, gt, num, acc)
        seen += len(gt)
        if limit and seen >= limit:
            break

    best = np.asarray(acc.best_ious) if acc.best_ious else np.zeros(1)
    return {
        "images": acc.n_images,
        "gts": acc.n_gts,
        "anchors": int(anchors_np.shape[0]),
        "matched_recall": round(acc.n_matched / max(acc.n_gts, 1), 4),
        "forced_only_frac": round(acc.n_forced_only / max(acc.n_gts, 1), 4),
        "uncovered_frac": round(float((best < 0.1).mean()), 4),
        "best_iou_mean": round(float(best.mean()), 4),
        "best_iou_p10": round(float(np.percentile(best, 10)), 4),
        "best_iou_p50": round(float(np.percentile(best, 50)), 4),
        "positives_per_image": round(float(np.mean(acc.positives)), 2),
        "ignored_per_image": round(float(np.mean(acc.ignored)), 2),
        "bucket_recall": {
            name: (round(acc.bucket_matched[name] / g, 4) if (
                g := acc.bucket_gts[name]) else None)
            for name, *_ in _AREA_BUCKETS
        },
        "bucket_gts": dict(acc.bucket_gts),
        "level_positive_share": (
            [round(float(x), 4) for x in
             (acc.level_pos / max(acc.level_pos.sum(), 1))]
            if acc.level_pos is not None else []),
    }


def print_report(report: dict, cfg: Config) -> None:
    print(f"anchor coverage over {report['images']} images / "
          f"{report['gts']} gts ({report['anchors']} anchors):")
    print(f"  matched-gt recall @IoU>={cfg.matcher.matching_threshold}: "
          f"{report['matched_recall']:.1%}  "
          f"(forced-match-only: {report['forced_only_frac']:.1%}, "
          f"uncovered: {report['uncovered_frac']:.1%})")
    print(f"  best-IoU per gt: mean {report['best_iou_mean']:.3f}  "
          f"p10 {report['best_iou_p10']:.3f}  "
          f"p50 {report['best_iou_p50']:.3f}")
    for name, *_ in _AREA_BUCKETS:
        r = report["bucket_recall"][name]
        g = report["bucket_gts"][name]
        print(f"  {name:>6}: recall "
              + (f"{r:.1%}" if r is not None else "   n/a")
              + f"  ({g} gts)")
    print(f"  positives/image: {report['positives_per_image']}  "
          f"ignored/image: {report['ignored_per_image']}")
    if report["level_positive_share"]:
        share = " ".join(f"P{3 + i}:{s:.0%}"
                         for i, s in enumerate(report["level_positive_share"]))
        print(f"  positive split over levels: {share}")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True)
    p.add_argument("--split", default="val", choices=["val", "train"])
    p.add_argument("--data", default="",
                   help="tfrecord glob (overrides --split's pattern)")
    p.add_argument("--limit", type=int, default=0,
                   help="max images (0 = all)")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--json", default="", help="also write the report here")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)

    cfg = Config.load(args.config)
    report = analyze(cfg, args.split, args.limit, args.batch_size,
                     data_pattern=args.data, device=args.device)
    print_report(report, cfg)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.json}")
    return report


if __name__ == "__main__":
    main()
