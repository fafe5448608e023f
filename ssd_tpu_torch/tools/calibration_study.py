"""int8 calibration regimes against bf16 (the port's
``ssd_tpu/tools/calibration_study.py``).

Sweeps the calibration of the dense4 (flagship) stem variant with the
int8 neck on the crowded dense-scene task (``tools/crowded_validation``)
and reports each regime's int8 mAP against the bf16 mAP of the same
weights:

* calibration set size: ``--sizes`` (8 / 64 / 256 images);
* calibration distribution: train scenes against held-out val scenes;
* clipping: absmax against the ``--percentile`` (99.9) of ``|x|`` in each
  batch (``quant.calibrate``'s ``percentile``).

Every evaluation runs the serving path: ``Detector.predict`` on the raw
uint8 images (the exact-integer stem and the calibrated neck and head
scales), each regime on a fresh model of the same float weights (the
port's scales only widen across calibrations). The JAX tool's persistent
compile cache has no counterpart: eager PyTorch compiles nothing.

    python -m ssd_tpu_torch.tools.calibration_study --workdir /tmp/calib \\
        [--steps 2500] [--skip-train] [--sizes 8 64 256] \\
        [--percentile 99.9] [--out-json rows.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np


def _batches_from(pattern: str, cfg, n_images: int, batch: int = 8):
    """The first ``n_images`` raw uint8 images of a tfrecord pattern, as
    batches."""
    from ssd_tpu_torch.data.pipeline import Pipeline

    out, seen = [], 0
    for b in Pipeline(pattern, cfg, is_training=False, batch_size=batch):
        imgs = np.asarray(b["images"])[np.asarray(b["valid"]).astype(bool)]
        take = min(n_images - seen, imgs.shape[0])
        if take > 0:
            out.append(imgs[:take])
            seen += take
        if seen >= n_images:
            break
    if seen < n_images:
        raise ValueError(f"only {seen} images in {pattern}, need {n_images}")
    return out


def detector_map(det, val_pattern: str, max_images: int) -> float:
    """mAP of ``det.predict`` over the first ``max_images`` of a val set
    (batches of 16)."""
    from ssd_tpu_torch.data.pipeline import Pipeline
    from ssd_tpu_torch.eval.coco_map import DetectionEvaluator

    ev = DetectionEvaluator(det.cfg.num_classes)
    seen = 0
    for batch in Pipeline(val_pattern, det.cfg, is_training=False,
                          batch_size=16):
        if seen >= max_images:
            break
        out = det.predict(batch["images"])
        ev.add_batch(
            {k: getattr(out, k).cpu().numpy()
             for k in ("boxes", "scores", "labels", "num_boxes")},
            batch["boxes"], batch["labels"], batch["num_boxes"],
            valid=batch.get("valid"), orig_hw=batch.get("orig_hw"))
        seen += int(batch["valid"].sum())
    return float(ev.result()["mAP"])


def eval_map(cfg, state, val_pattern: str, max_images: int,
             device=None) -> float:
    """mAP of ``Detector(cfg, state).predict`` (the serving path) on a val
    set."""
    from ssd_tpu_torch.models.detector import Detector

    return detector_map(Detector(cfg, state, device=device), val_pattern,
                        max_images)


def int8_map(cfg, state, batches, clip: float | None, val_pattern: str,
             val_images: int, device=None) -> tuple[int, float]:
    """``cfg`` in int8 with the neck, a fresh model of the float ``state``
    calibrated on ``batches`` (``clip``: ``None`` absmax, else that
    percentile) -> (images seen, its mAP on the val set)."""
    from ssd_tpu_torch.models.detector import Detector
    from ssd_tpu_torch.quant import calibrate, int8_config

    det8 = Detector(int8_config(cfg, int8_neck=True), state, device=device)
    seen = calibrate(det8, batches, percentile=clip)
    return seen, detector_map(det8, val_pattern, val_images)


def sweep(cfg, state, train_path: str, val_path: str, val_images: int,
          sizes, percentile: float, device=None) -> list[dict]:
    """The rows: bf16, then each (distribution, size, clip) regime in int8
    with the neck, ``d_mAP`` against bf16."""
    bf16_map = eval_map(cfg, state, val_path, val_images, device)
    print(f"bf16 baseline mAP = {bf16_map:.4f}", flush=True)
    rows = [{"regime": "bf16 baseline", "mAP": bf16_map, "d_mAP": 0.0}]
    for dist, pattern in (("train", train_path), ("val", val_path)):
        for n in sizes:
            batches = _batches_from(pattern, cfg, n)
            for clip in (None, percentile):
                seen, m = int8_map(cfg, state, batches, clip, val_path,
                                   val_images, device)
                name = (f"int8 cal={dist} n={seen} "
                        f"clip={'absmax' if clip is None else f'p{clip:g}'}")
                rows.append({"regime": name, "mAP": m,
                             "d_mAP": m - bf16_map})
                print(f"{name}: mAP={m:.4f} ({m - bf16_map:+.4f})",
                      flush=True)
    return rows


def print_rows(rows: list[dict]) -> None:
    print("\n| regime | mAP | d_mAP vs bf16 |")
    print("|---|---|---|")
    for r in rows:
        print(f"| {r['regime']} | {r['mAP']:.4f} | {r['d_mAP']:+.4f} |")


def dense4_config(workdir: str, steps: int):
    """The crowded tool's config with the flagship's dense4 stem."""
    from ssd_tpu_torch.tools.crowded_validation import make_config

    cfg = make_config(workdir, steps)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, stem_schedule="dense4"))


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--workdir", required=True)
    p.add_argument("--steps", type=int, default=2500)
    p.add_argument("--train-images", type=int, default=2000)
    p.add_argument("--val-images", type=int, default=256)
    p.add_argument("--skip-train", action="store_true")
    p.add_argument("--sizes", type=int, nargs="*", default=[8, 64, 256])
    p.add_argument("--percentile", type=float, default=99.9)
    p.add_argument("--out-json", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)

    from ssd_tpu_torch.tools.crowded_validation import (prepare,
                                                        train_or_load)

    train_path, val_path = prepare(args.workdir, args.train_images,
                                   args.val_images)
    cfg = dense4_config(args.workdir, args.steps)
    state = train_or_load(cfg, args.workdir, args.steps, args.skip_train,
                          args.device)
    rows = sweep(cfg, state, train_path, val_path, args.val_images,
                 args.sizes, args.percentile, args.device)
    print_rows(rows)
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(rows, f, indent=2)
    return rows


if __name__ == "__main__":
    main()
