"""Crowded-scene accuracy of the candidate-selection and NMS variants (the
port's ``ssd_tpu/tools/crowded_validation.py``).

A synthetic stress task: 30-80 small objects (8-48 px at 256 px) of 40
classes a scene, told apart by colour, overlapping freely
(``data/synthetic.crowded_example``, the JAX package's scenes draw for
draw). The tool writes the train and val sets as tfrecords (JPEG quality
95: byte for byte the JAX tool's files), trains a detector on them through
``train.train``, then evaluates the same weights under each of the JAX
tool's 24 selection/NMS variants against the exact oracle (every anchor a
candidate, exact top-k, ``pre_nms_top_k`` 400) and reports mAP/AP50/AR@100
and the mAP delta:

* ``flat`` rows: ``postprocess.select_candidates`` over the flat logits,
  then ``run_nms``;
* ``cells`` rows: ``select_candidates_cells`` over the per-level maps,
  then ``run_nms``;
* the 21 hard-NMS rows run the suppression kernel (K1) on the card and
  its plain version on the CPU; the 3 Soft-NMS rows run the plain
  Soft-NMS anywhere, as the JAX package's always do.

The port's top-k is always exact, and off the TPU the JAX package's
``approx_max_k`` is exact too: each ``approx`` row equals its exact twin.

One forward a batch (``SSDModel.forward``, ``fpn.flatten_levels`` for the
flat rows) feeds every variant, so the deltas isolate the selection and
NMS. The numbers go to ``eval/coco_map.DetectionEvaluator``.

    python -m ssd_tpu_torch.tools.crowded_validation --workdir /tmp/crowd \\
        [--steps 2500] [--val-images 256] [--skip-train] \\
        [--set model.stem_schedule=dense4] [--only "q=1024"] \\
        [--out-json rows.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import os

import numpy as np
import torch

from ssd_tpu_torch.data.synthetic import (CROWDED_CLASSES, CROWDED_SIZE,
                                          crowded_example)
from ssd_tpu_torch.data.synthetic import _palette  # noqa: F401 (JAX's name)

SIZE = CROWDED_SIZE
NUM_CLASSES = CROWDED_CLASSES
JPEG_QUALITY = 95


def crowded_jpeg(rng: np.random.Generator, num_classes: int = NUM_CLASSES,
                 size: int = SIZE):
    """``crowded_example`` as the JAX tool returns it: ``(jpeg_bytes,
    boxes, labels)``, the JPEG by PIL at quality 95."""
    from PIL import Image

    img, boxes, labels = crowded_example(rng, num_classes, size)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=JPEG_QUALITY)
    return buf.getvalue(), boxes, labels


def write_dataset(path: str, n: int, seed: int,
                  num_classes: int = NUM_CLASSES) -> None:
    from ssd_tpu_torch.data.tfrecord import (RecordWriter,
                                             encode_detection_example)

    rng = np.random.default_rng(seed)
    with RecordWriter(path) as w:
        for _ in range(n):
            jpeg, boxes, labels = crowded_jpeg(rng, num_classes)
            w.write(encode_detection_example(
                jpeg, boxes, labels, image_hw=(SIZE, SIZE)))


def make_config(workdir: str, steps: int, num_classes: int = NUM_CLASSES,
                size: int = SIZE):
    from ssd_tpu_torch.config import (Config, DataConfig, LossConfig,
                                      ModelConfig, NMSConfig, TrainConfig)
    return Config(
        num_classes=num_classes,
        image_size=size,
        model=ModelConfig(backbone="mobilenet", width_multiplier=0.5,
                          fpn_channels=64, head_depth=2, bn_momentum=0.97),
        nms=NMSConfig(score_threshold=0.05, max_boxes=100,
                      num_candidates=1024, pre_nms_top_k=128),
        losses=LossConfig(weight_decay=1e-5),
        train=TrainConfig(batch_size=32, num_steps=steps, optimizer="adam",
                          learning_rate=1.5e-3, warmup_steps=100,
                          log_every=100, eval_every=0, checkpoint_every=1000),
        data=DataConfig(
            train_file_pattern=os.path.join(workdir, "train.tfrecords"),
            val_file_pattern=os.path.join(workdir, "val.tfrecords"),
            max_gt_boxes=100, crop_probability=0.0,
            color_jitter_probability=0.0, flip_probability=0.5,
        ),
    )


# ------------------------------------------------------------------ sweep

def variant_postprocessors(det, cfg) -> list:
    """``(name, kind, fn)`` for every variant, the JAX tool's names in its
    order: ``kind`` ``"flat"`` takes ``fn(logits, deltas)``, ``"cells"``
    ``fn(raw_levels)``; each returns ``Detections``."""
    from ssd_tpu_torch.ops.postprocess import (run_nms, select_candidates,
                                               select_candidates_cells)

    nms = cfg.nms
    anchors = det.anchors
    variants = []

    def flat_fn(nms_cfg):
        def fn(logits, deltas):
            return run_nms(*select_candidates(logits, deltas, anchors,
                                              nms_cfg), nms_cfg)
        return fn

    def cells_fn(nms_cfg):
        def fn(raw):
            return run_nms(*select_candidates_cells(
                raw, anchors, cfg.num_classes, nms_cfg), nms_cfg)
        return fn

    a_total = anchors.shape[0]
    variants.append(("oracle(full-anchors,exact)", "flat",
                     flat_fn(dataclasses.replace(
                         nms, num_candidates=a_total, pre_nms_top_k=400,
                         approx_class_topk=False))))
    for q in (256, 512, 1024, 2048):
        vq = dataclasses.replace(nms, num_candidates=q,
                                 approx_class_topk=False,
                                 cell_overprovision=1.0,
                                 approx_cell_topk=False)
        variants.append((f"anchors-exact q={q}", "flat", flat_fn(vq)))
        variants.append((f"anchors-approx q={q}", "flat", flat_fn(vq)))
        variants.append((f"cells q={q}", "cells", cells_fn(vq)))
    # two-stage cell selection: overprovisioned cells, exact anchor refine
    for q, over in ((1024, 2.0), (1024, 3.0), (2048, 2.0)):
        vr = dataclasses.replace(nms, num_candidates=q,
                                 approx_class_topk=False,
                                 cell_overprovision=over,
                                 approx_cell_topk=False)
        variants.append((f"cells q={q} refine-x{over:g}", "cells",
                         cells_fn(vr)))
    for approx in ("class", "cell"):
        variants.append((
            f"cells q=1024 refine-x2 +approx-{approx}-topk", "cells",
            cells_fn(dataclasses.replace(
                nms, num_candidates=1024,
                approx_class_topk=approx == "class",
                cell_overprovision=2.0, approx_cell_topk=approx == "cell"))))
    for topk in (64, 256, 400):
        vt = dataclasses.replace(nms, num_candidates=1024,
                                 pre_nms_top_k=topk,
                                 approx_class_topk=False,
                                 cell_overprovision=1.0,
                                 approx_cell_topk=False)
        variants.append((f"cells q=1024 pre_nms_top_k={topk}", "cells",
                         cells_fn(vt)))
    # Soft-NMS on the default two-stage cell path (plain everywhere)
    for meth, sigma in (("soft_linear", None), ("soft_gaussian", 0.25),
                        ("soft_gaussian", 0.5)):
        kw = {"method": meth}
        if sigma is not None:
            kw["soft_sigma"] = sigma
        vs = dataclasses.replace(nms, num_candidates=1024,
                                 approx_class_topk=False,
                                 cell_overprovision=2.0,
                                 approx_cell_topk=False, **kw)
        label = meth if sigma is None else f"{meth} sigma={sigma:g}"
        variants.append((f"cells q=1024 refine-x2 {label}", "cells",
                         cells_fn(vs)))
    return variants


def _numpy(out) -> dict:
    return {k: getattr(out, k).cpu().numpy()
            for k in ("boxes", "scores", "labels", "num_boxes")}


def run_sweep(cfg, state, val_pattern: str, max_images: int | None,
              batch_size: int = 16, only: str = "", device=None,
              on_batch=None) -> list[dict]:
    """Every variant over the first ``max_images`` of ``val_pattern``:
    rows ``{variant, images, mAP, AP50, AR@100, d_mAP}``, ``d_mAP`` against
    the oracle (the first row, kept whatever ``only`` filters).
    ``on_batch(images, raw, outputs)``, if given, sees each batch's raw
    maps and every variant's detections (``{name: Detections}``)."""
    from ssd_tpu_torch.data.pipeline import Pipeline
    from ssd_tpu_torch.eval.coco_map import DetectionEvaluator
    from ssd_tpu_torch.models.detector import Detector
    from ssd_tpu_torch.models.fpn import flatten_levels

    det = Detector(cfg, state, device=device)
    variants = variant_postprocessors(det, cfg)
    if only:
        variants = [v for i, v in enumerate(variants)
                    if i == 0 or only in v[0]]
    evaluators = {name: DetectionEvaluator(cfg.num_classes)
                  for name, _, _ in variants}

    seen = 0
    for batch in Pipeline(val_pattern, cfg, is_training=False,
                          batch_size=batch_size):
        if max_images is not None and seen >= max_images:
            break
        with torch.inference_mode():
            raw = det.model.eval()(det.as_input(batch["images"]))
            logits, deltas = flatten_levels(raw, cfg.num_classes)
            outputs = {name: (fn(logits, deltas) if kind == "flat"
                              else fn(raw))
                       for name, kind, fn in variants}
        if on_batch is not None:
            on_batch(batch["images"], raw, outputs)
        for name, out in outputs.items():
            evaluators[name].add_batch(
                _numpy(out), batch["boxes"], batch["labels"],
                batch["num_boxes"], valid=batch.get("valid"),
                orig_hw=batch.get("orig_hw"))
        seen += int(batch["valid"].sum())

    rows = []
    oracle = None
    for name, _, _ in variants:
        r = evaluators[name].result()
        row = {"variant": name, "images": seen, "mAP": r["mAP"],
               "AP50": r["AP50"], "AR@100": r["AR@100"]}
        if oracle is None:
            oracle = r
            row["d_mAP"] = 0.0
        else:
            row["d_mAP"] = r["mAP"] - oracle["mAP"]
        rows.append(row)
    return rows


def print_table(rows: list[dict]) -> None:
    print(f"\ncrowded-scene sweep over {rows[0]['images']} images "
          f"(30-80 objects each, {NUM_CLASSES} classes; the port's top-k "
          "is exact, so each approx row equals its exact twin):\n")
    print("| variant | mAP | AP50 | AR@100 | dmAP vs oracle |")
    print("|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['variant']} | {r['mAP']:.4f} | {r['AP50']:.4f} "
              f"| {r['AR@100']:.4f} | {r['d_mAP']:+.4f} |")


def prepare(workdir: str, train_images: int, val_images: int) -> tuple:
    """Writes the train (seed 0) and val (seed 1) sets if absent; returns
    their paths."""
    os.makedirs(workdir, exist_ok=True)
    train_path = os.path.join(workdir, "train.tfrecords")
    val_path = os.path.join(workdir, "val.tfrecords")
    if not os.path.exists(train_path):
        print("writing crowded train set...", flush=True)
        write_dataset(train_path, train_images, seed=0)
    if not os.path.exists(val_path):
        write_dataset(val_path, val_images, seed=1)
    return train_path, val_path


def train_or_load(cfg, workdir: str, steps: int, skip_train: bool,
                  device=None) -> dict:
    """Trains ``cfg`` into ``workdir/run`` (unless ``skip_train``) and
    returns the state of ``workdir/run/export``."""
    from ssd_tpu_torch.export import load_inference_artifact

    rundir = os.path.join(workdir, "run")
    if not skip_train:
        from ssd_tpu_torch.train import train
        train(cfg, rundir, max_steps=steps, device=device)
    _, state = load_inference_artifact(os.path.join(rundir, "export"))
    return state


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--workdir", required=True)
    p.add_argument("--steps", type=int, default=2500)
    p.add_argument("--train-images", type=int, default=2000)
    p.add_argument("--val-images", type=int, default=256)
    p.add_argument("--skip-train", action="store_true",
                   help="reuse workdir/run/export from a previous run")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                   help="config overrides, e.g. model.stem_schedule=dense4")
    p.add_argument("--only", default="",
                   help="substring filter on variant names (oracle kept)")
    p.add_argument("--out-json", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)

    _, val_path = prepare(args.workdir, args.train_images, args.val_images)
    cfg = make_config(args.workdir, args.steps)
    if args.set:
        from ssd_tpu_torch.config import Config
        from ssd_tpu_torch.tools.bench_train import apply_overrides
        cfg = Config.from_dict(
            apply_overrides(json.loads(cfg.to_json()), args.set))
    state = train_or_load(cfg, args.workdir, args.steps, args.skip_train,
                          args.device)
    rows = run_sweep(cfg, state, val_path, args.val_images, only=args.only,
                     device=args.device)
    print_table(rows)
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(rows, f, indent=2)
    return rows


if __name__ == "__main__":
    main()
