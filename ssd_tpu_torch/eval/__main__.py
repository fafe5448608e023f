"""Standalone evaluation CLI: an inference artifact + val tfrecords -> the
mAP table (the port's ``ssd_tpu/eval/__main__.py``).

    python -m ssd_tpu_torch.eval --export DIR_OR_FILE.npz \\
        [--val-pattern "data/val-*-of-*"] [--batch-size 16] [--limit N] \\
        [--dump-coco out.json] [--set key=val ...] [--tta] [--device cpu]

The val shards are read by the eval ``data.pipeline.Pipeline`` (padded
tail rows skipped, crowd boxes as ignore regions, areas at the original
size) and scored by ``eval.coco_map.DetectionEvaluator``: COCO-style mAP,
AP50/75, by area, AR and per-class AP50. ``--tta`` also predicts each
batch's horizontal flip and fuses the two views by weighted box fusion
(``tta.fuse_flip_batch``, on the device). ``--dump-coco`` writes
pycocotools results JSON (``image/source_id`` from the shards, labels
mapped back through ``<prefix>-category_ids.json`` where it is). The
artifact (``--export``, or its older name ``--npz``) is a directory
(``export.save_inference_artifact``) or a single-file ``.npz``. After the table, one JSON line:
the headline numbers, the images seen and the suppression kernel's
launches.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os

import numpy as np

from ssd_tpu_torch.export import (add_artifact_args,
                                  load_artifact_label_map,
                                  load_inference_artifact)

ROWS = (
    ("AP @[.50:.95] | area=   all | maxDets=100", "mAP"),
    ("AP @0.50      | area=   all | maxDets=100", "AP50"),
    ("AP @0.75      | area=   all | maxDets=100", "AP75"),
    ("AP @[.50:.95] | area= small | maxDets=100", "AP_small"),
    ("AP @[.50:.95] | area=medium | maxDets=100", "AP_medium"),
    ("AP @[.50:.95] | area= large | maxDets=100", "AP_large"),
    ("AR @[.50:.95] | area=   all | maxDets=  1", "AR@1"),
    ("AR @[.50:.95] | area=   all | maxDets= 10", "AR@10"),
    ("AR @[.50:.95] | area=   all | maxDets=100", "AR@100"),
    ("AR @[.50:.95] | area= small | maxDets=100", "AR_small"),
    ("AR @[.50:.95] | area=medium | maxDets=100", "AR_medium"),
    ("AR @[.50:.95] | area= large | maxDets=100", "AR_large"),
)
DET_KEYS = ("boxes", "scores", "labels", "num_boxes")


def category_ids_for(pattern: str) -> dict[int, int] | None:
    """The ``<prefix>-category_ids.json`` map ``create_tfrecords`` writes
    beside the shards of ``pattern``; else the one such map in their
    directory (the first, with a warning, if several)."""
    prefix = pattern.split("*")[0].split("?")[0].rstrip("-")
    exact = f"{prefix}-category_ids.json"
    if os.path.exists(exact):
        hits = [exact]
    else:
        hits = sorted(glob.glob(os.path.join(
            os.path.dirname(pattern) or ".", "*category_ids.json")))
        if len(hits) > 1:
            print(f"warning: no {exact}; multiple category-id maps found, "
                  f"using {hits[0]} (candidates: {hits})")
    if not hits:
        return None
    with open(hits[0]) as f:
        return {int(k): int(v) for k, v in json.load(f).items()}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    add_artifact_args(p)
    p.add_argument("--val-pattern", default=None,
                   help="override the config's data.val_file_pattern")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--limit", type=int, default=None,
                   help="at most this many batches (smoke runs)")
    p.add_argument("--dump-coco", default=None, metavar="OUT.json",
                   help="also write pycocotools results JSON")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                   help="config overrides for this eval only, e.g. "
                        "nms.method=soft_gaussian nms.score_threshold=0.01")
    p.add_argument("--tta", action="store_true",
                   help="flip test-time augmentation: fuse base and flipped "
                        "views per image with weighted box fusion")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)

    from ssd_tpu_torch.config import Config
    from ssd_tpu_torch.data.pipeline import Pipeline
    from ssd_tpu_torch.eval.coco_map import (DetectionEvaluator,
                                             detections_to_coco)
    from ssd_tpu_torch.models.detector import Detector
    from ssd_tpu_torch.ops import nms_cuda
    from ssd_tpu_torch.tools.bench_serve import apply_overrides
    from ssd_tpu_torch.tta import fuse_flip_batch

    cfg, state = load_inference_artifact(args.artifact)
    if args.val_pattern:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, val_file_pattern=args.val_pattern))
    if args.set:
        cfg = Config.from_dict(apply_overrides(json.loads(cfg.to_json()),
                                               args.set))
    detector = Detector(cfg, state, device=args.device)
    label_map = load_artifact_label_map(args.artifact)

    def predict(images: np.ndarray) -> dict:
        out = detector.predict(np.ascontiguousarray(images))
        return {k: getattr(out, k).cpu().numpy() for k in DET_KEYS}

    evaluator = DetectionEvaluator(cfg.num_classes)
    pipeline = Pipeline(cfg.data.val_file_pattern, cfg, is_training=False,
                        batch_size=args.batch_size)
    coco = [] if args.dump_coco else None
    category_ids = (category_ids_for(cfg.data.val_file_pattern)
                    if args.dump_coco else None)
    seen = 0
    for i, batch in enumerate(pipeline):
        if args.limit is not None and i >= args.limit:
            break
        out = predict(batch["images"])
        if args.tta:  # the flipped batch: the same shape and bucket
            out = fuse_flip_batch(
                out, predict(batch["images"][:, :, ::-1]),
                cfg.nms.iou_threshold, cfg.nms.max_boxes,
                device=detector.device)
        valid = batch.get("valid")
        evaluator.add_batch(out, batch["boxes"], batch["labels"],
                            batch["num_boxes"], valid=valid,
                            gt_is_crowd=batch.get("is_crowd"),
                            orig_hw=batch.get("orig_hw"))
        seen += int(valid.sum()) if valid is not None else len(
            batch["images"])
        if coco is not None:
            coco.extend(detections_to_coco(
                out, batch["source_ids"], batch["orig_hw"], valid=valid,
                category_ids=category_ids))

    if coco is not None:
        with open(args.dump_coco, "w") as f:
            json.dump(coco, f)
        print(f"wrote {len(coco)} COCO-format detections to "
              f"{args.dump_coco}")
    result = evaluator.result()
    print(f"\nevaluated {seen} images")
    for label, key in ROWS:
        print(f"  {label} = {result[key]:.4f}")
    print()
    for c, ap in enumerate(result["per_class_AP50"]):
        if not np.isnan(ap):
            print(f"  AP50[{(label_map or {}).get(c, str(c))}] = {ap:.4f}")
    result["images"] = seen
    head = {k: float(result[k]) for k in ("mAP", "AP50", "AP75")}
    print(json.dumps({"eval_done": True, "images": seen, "tta": args.tta,
                      **head, "kernel_launches": {"nms": nms_cuda.launches}}),
          flush=True)
    return result


if __name__ == "__main__":
    main()
