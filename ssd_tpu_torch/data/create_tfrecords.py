"""Offline dataset preparation: annotations + images -> sharded tfrecords.

The port's own copy of the JAX package's ``ssd_tpu/data/create_tfrecords.py``:
a COCO-style annotation JSON and an image directory become sharded
tfrecord files in the schema ``data/tfrecord.py`` defines (jpeg bytes,
normalized ymin/xmin/ymax/xmax, labels, crowd flags, the image id and
size), with ``<output>-label_map.json`` and ``<output>-category_ids.json``
beside them for a COCO file.

Usage:
    python -m ssd_tpu_torch.data.create_tfrecords \
        --annotations instances_train2017.json --images train2017/ \
        --output data/train --num-shards 64

Accepted annotation formats:
  * COCO instances JSON (``images`` / ``annotations`` / ``categories``);
  * a simple JSON list: ``[{"filename", "boxes" [[ymin,xmin,ymax,xmax]
    normalized], "labels" [int]}, ...]``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ssd_tpu_torch.data import native
from ssd_tpu_torch.data.tfrecord import RecordWriter, encode_detection_example


def load_coco(path: str) -> list[dict]:
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, list):  # simple format, already normalized
        return data
    images = {im["id"]: im for im in data["images"]}
    # map COCO category ids (non-contiguous) -> contiguous [0, C)
    cats = sorted(data["categories"], key=lambda c: c["id"])
    cat_map = {c["id"]: i for i, c in enumerate(cats)}
    load_coco.last_label_map = {  # exposed for the CLI to persist
        i: c.get("name", str(c["id"])) for i, c in enumerate(cats)
    }
    load_coco.last_category_ids = {  # contiguous label -> COCO category_id
        i: c["id"] for i, c in enumerate(cats)
    }
    per_image: dict[int, dict] = {}
    for ann in data["annotations"]:
        im = images[ann["image_id"]]
        h, w = im["height"], im["width"]
        x, y, bw, bh = ann["bbox"]
        box = [y / h, x / w, (y + bh) / h, (x + bw) / w]
        box = [min(max(v, 0.0), 1.0) for v in box]
        if box[2] <= box[0] or box[3] <= box[1]:
            continue
        entry = per_image.setdefault(
            ann["image_id"],
            {"filename": im["file_name"], "boxes": [], "labels": [],
             "is_crowd": [], "source_id": ann["image_id"],
             "height": h, "width": w},
        )
        entry["boxes"].append(box)
        entry["labels"].append(cat_map[ann["category_id"]])
        # crowd annotations are KEPT, flagged: the eval protocol treats
        # them as ignore regions (pycocotools semantics); the training
        # pipeline excludes them from target creation
        entry["is_crowd"].append(1 if ann.get("iscrowd") else 0)
    # include images with no annotations too (pure negatives)
    for iid, im in images.items():
        per_image.setdefault(
            iid, {"filename": im["file_name"], "boxes": [], "labels": [],
                  "is_crowd": [], "source_id": iid, "height": im["height"],
                  "width": im["width"]}
        )
    return [per_image[k] for k in sorted(per_image)]


def write_shards(entries: list[dict], image_dir: str, output_prefix: str,
                 num_shards: int) -> int:
    os.makedirs(os.path.dirname(os.path.abspath(output_prefix)) or ".",
                exist_ok=True)
    writers = [
        RecordWriter(f"{output_prefix}-{i:05d}-of-{num_shards:05d}.tfrecords")
        for i in range(num_shards)
    ]
    written = 0
    try:
        for n, entry in enumerate(entries):
            path = os.path.join(image_dir, entry["filename"])
            try:
                with open(path, "rb") as f:
                    jpeg = f.read()
            except FileNotFoundError:
                continue
            boxes = np.asarray(entry["boxes"], np.float32).reshape(-1, 4)
            labels = np.asarray(entry["labels"], np.int64)
            hw = (entry.get("height"), entry.get("width"))
            if hw[0] is None or hw[1] is None:
                # simple-format entries carry no dims: the JPEG header's
                hw = native.jpeg_dims(jpeg)
            writers[n % num_shards].write(
                encode_detection_example(
                    jpeg, boxes, labels,
                    source_id=entry.get("source_id", n),
                    image_hw=hw,
                    is_crowd=entry.get("is_crowd"))
            )
            written += 1
    finally:
        for w in writers:
            w.close()
    return written


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--annotations", required=True)
    p.add_argument("--images", required=True)
    p.add_argument("--output", required=True, help="output shard prefix")
    p.add_argument("--num-shards", type=int, default=32)
    args = p.parse_args(argv)

    entries = load_coco(args.annotations)
    n = write_shards(entries, args.images, args.output, args.num_shards)
    cat_ids = getattr(load_coco, "last_category_ids", None)
    if cat_ids:
        ids_path = f"{args.output}-category_ids.json"
        with open(ids_path, "w") as f:
            json.dump(cat_ids, f, indent=2)
        print(f"wrote category-id map to {ids_path}")
    label_map = getattr(load_coco, "last_label_map", None)
    if label_map:
        map_path = f"{args.output}-label_map.json"
        with open(map_path, "w") as f:
            json.dump(label_map, f, indent=2)
        print(f"wrote label map ({len(label_map)} classes) to {map_path}")
    print(f"wrote {n} examples to {args.output}-*-of-{args.num_shards:05d}")


if __name__ == "__main__":
    main()
