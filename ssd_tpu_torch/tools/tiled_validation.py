"""Tiled inference against resize on large scenes of small objects (the
port's ``ssd_tpu/tools/tiled_validation.py``).

The crowded-scene task (``tools/crowded_validation``): a detector trained
at 256 px on dense scenes of 8-48 px objects, evaluated on val scenes
drawn at ``--hires-size`` (default 1024) with the same object sizes in
pixels, so that the resize path sees the objects shrunk 4x while the
tiler sees them at the training scale. Variants, on the same images and
weights, scored by the 12-metric COCO evaluator:

* ``resize``: the plain ``Predictor`` (the reference's behaviour);
* ``tiled``: ``tiling.TiledPredictor`` with the shipped defaults (IoS
  merge, edge penalty 0.5, full-image pass, overlap 0.25);
* with ``--ablate``: no edge penalty, IoU merge, no full-image pass.

The scenes are JPEGs (quality 95) decoded by ``data/native.decode_jpeg``.
Each variant is timed after its own warm-up on a throwaway scene, each
time ending in the readback of the detections.

    python -m ssd_tpu_torch.tools.tiled_validation --workdir /tmp/tiled \\
        [--steps 2500] [--val-images 64] [--hires-size 1024] \\
        [--skip-train] [--ablate] [--out-json rows.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ssd_tpu_torch.tools.crowded_validation import (NUM_CLASSES, crowded_jpeg,
                                                    make_config, prepare,
                                                    train_or_load)


def hires_scenes(n: int, seed: int, size: int):
    """Val scenes at ``size`` px with the training task's object sizes in
    pixels: ``(jpeg, boxes, labels)``."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield crowded_jpeg(rng, NUM_CLASSES, size=size)


def evaluate_variants(state, cfg, args, device=None) -> list[dict]:
    """The rows of the module docstring; ``args`` carries ``ablate``,
    ``hires_size`` and ``val_images``."""
    from ssd_tpu_torch.data import native
    from ssd_tpu_torch.eval.coco_map import DetectionEvaluator
    from ssd_tpu_torch.predictor import Predictor
    from ssd_tpu_torch.tiling import TiledPredictor

    predictor = Predictor(cfg, state, device=device)
    variants: dict[str, object] = {
        "resize (reference behavior)": predictor,
        "tiled (shipped defaults)": TiledPredictor(predictor),
    }
    if args.ablate:
        variants["tiled, no edge penalty"] = TiledPredictor(
            predictor, edge_penalty=1.0)
        variants["tiled, iou merge"] = TiledPredictor(
            predictor, merge_metric="iou")
        variants["tiled, no full-image pass"] = TiledPredictor(
            predictor, full_image_pass=False)

    evaluators = {name: DetectionEvaluator(cfg.num_classes)
                  for name in variants}
    timings = {name: 0.0 for name in variants}
    s = args.hires_size
    # a throwaway scene, so that each variant's first calls stay untimed
    warm_jpeg, _, _ = next(iter(hires_scenes(1, seed=99, size=s)))
    warm = native.decode_jpeg(warm_jpeg)
    for var in variants.values():
        var.predict(warm)
    for jpeg, gt_boxes, gt_labels in hires_scenes(
            args.val_images, seed=7, size=s):
        image = native.decode_jpeg(jpeg)
        for name, var in variants.items():
            t0 = time.monotonic()
            out = var.predict(image)  # numpy: ends in the readback
            timings[name] += time.monotonic() - t0
            n = int(np.asarray(out["num_boxes"]).reshape(())[()])
            evaluators[name].add_image(
                np.asarray(out["boxes"])[:n], np.asarray(out["scores"])[:n],
                np.asarray(out["labels"])[:n], gt_boxes, gt_labels,
                image_hw=(s, s))

    rows = []
    for name in variants:
        r = evaluators[name].result()
        rows.append({
            "variant": name, "images": args.val_images,
            "mAP": round(r["mAP"], 4), "AP50": round(r["AP50"], 4),
            "AP_small": round(r["AP_small"], 4),
            "AR@100": round(r["AR@100"], 4),
            "ms_per_image": round(timings[name] / args.val_images * 1e3, 1),
        })
    return rows


def print_rows(rows: list[dict]) -> None:
    w = max(len(r["variant"]) for r in rows)
    print(f"\n{'variant':<{w}}  {'mAP':>7} {'AP50':>7} {'AP_s':>7} "
          f"{'AR@100':>7} {'ms/img':>7}")
    for r in rows:
        print(f"{r['variant']:<{w}}  {r['mAP']:>7.4f} {r['AP50']:>7.4f} "
              f"{r['AP_small']:>7.4f} {r['AR@100']:>7.4f} "
              f"{r['ms_per_image']:>7.1f}")


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--workdir", required=True)
    p.add_argument("--steps", type=int, default=2500)
    p.add_argument("--train-images", type=int, default=2000)
    p.add_argument("--val-images", type=int, default=64)
    p.add_argument("--hires-size", type=int, default=1024)
    p.add_argument("--skip-train", action="store_true",
                   help="reuse workdir/run/export from a previous run")
    p.add_argument("--ablate", action="store_true",
                   help="also run edge-penalty/merge-metric/full-pass "
                        "ablations")
    p.add_argument("--out-json", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)

    prepare(args.workdir, args.train_images, 64)
    cfg = make_config(args.workdir, args.steps)
    state = train_or_load(cfg, args.workdir, args.steps, args.skip_train,
                          args.device)
    rows = evaluate_variants(state, cfg, args, args.device)
    print_rows(rows)
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(rows, f, indent=2)
    return rows


if __name__ == "__main__":
    main()
