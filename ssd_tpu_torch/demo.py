"""Demo: load an exported detector and draw its detections on an image (the
port's ``demo/try_detector.py``).

With no artifact it runs a seeded model of the default config (80 classes,
640 px, weights seeded from 0): the full predict path still runs end to
end, the suppression kernel included, which makes it a smoke test.

    python -m ssd_tpu_torch.demo --image photo.jpg [--export runs/r1/export]
    python -m ssd_tpu_torch.demo --selftest   # a seeded image, no files
    (add --device cpu off the card)

The JAX package's notebook ``demo/try_detector.ipynb`` has no copy: its
steps are the train CLI (``python -m ssd_tpu_torch.train``),
``train.evaluate``, ``predictor.Predictor`` and ``draw_detections``.
"""

from __future__ import annotations

import argparse

import numpy as np


def draw_detections(image: np.ndarray, out: dict,
                    class_names: list[str] | None = None) -> np.ndarray:
    """Boxes drawn on an RGB uint8 image, 3 px red frames (numpy, no
    fonts; ``class_names`` is taken for the JAX signature and unused)."""
    img = image.copy()
    h, w = img.shape[:2]
    n = int(out["num_boxes"])
    for i in range(n):
        y0, x0, y1, x1 = out["boxes"][i]
        y0, x0 = int(y0 * h), int(x0 * w)
        y1, x1 = int(y1 * h), int(x1 * w)
        color = np.array([255, 64, 64], np.uint8)
        img[y0:y1 + 1, x0:x0 + 3] = color
        img[y0:y1 + 1, max(x1 - 2, 0):x1 + 1] = color
        img[y0:y0 + 3, x0:x1 + 1] = color
        img[max(y1 - 2, 0):y1 + 1, x0:x1 + 1] = color
    return img


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--image", help="input image path")
    p.add_argument("--export", help="inference artifact, a directory or "
                                    ".npz (optional)")
    p.add_argument("--output", default="detections.png")
    p.add_argument("--selftest", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    if not args.selftest and not args.image:
        p.error("give --image or --selftest")

    from PIL import Image

    from ssd_tpu_torch.predictor import Predictor

    if args.export:
        predictor = Predictor.from_checkpoint(args.export, device=args.device)
    else:
        from ssd_tpu_torch.config import Config
        print("no --export given: using seeded weights (smoke-test mode)")
        predictor = Predictor(Config(num_classes=80, image_size=640), None,
                              device=args.device)

    if args.selftest:
        image = np.random.default_rng(0).integers(
            0, 255, (480, 640, 3)).astype(np.uint8)
    else:
        image = np.asarray(Image.open(args.image).convert("RGB"))

    out = predictor(image)
    print(f"detections: {int(out['num_boxes'])}")
    for i in range(int(out["num_boxes"])):
        print(f"  label={int(out['labels'][i]):3d} "
              f"score={float(out['scores'][i]):.3f} "
              f"box={np.round(out['boxes'][i], 3).tolist()}")

    Image.fromarray(draw_detections(image, out)).save(args.output)
    print(f"wrote {args.output}")
    return out


if __name__ == "__main__":
    main()
