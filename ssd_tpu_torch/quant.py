"""Post-training int8 quantization: calibration and artifact conversion
(the port's ``ssd_tpu/quant.py``).

The scheme (``models/layers.QuantConv``): the f32 weights are unchanged and
quantize per output channel when a conv runs; activations quantize per
tensor, on the static ReLU6 bound in the backbone and on calibrated scales
in the FPN and head, whose inputs are unbounded sums. A scale is keyed by
the conv's input shape, so the shared head subnets hold one per pyramid
level. Depthwise convs, norms, activations and postprocess stay bf16/f32.

Calibration is a few forward passes in calibration mode
(``layers.calibrating``): every ``QuantConv`` runs the plain bf16 conv and
max-accumulates ``max|x| / 127`` (or the ``percentile`` of ``|x|``, per
batch) into its scale. The backbone's convs record theirs too, so a
calibrated model serves its backbone on calibrated scales as well.

    python -m ssd_tpu_torch.quant --export DIR_OR_FILE.npz \\
        --output DIR \\
        --data "data/val-*.tfrecords" | --images a.jpg b.jpg ... \\
        [--batch-size 8] [--batches 8] [--percentile 99.9] \\
        [--backbone-only] [--device cpu]

Every backbone quantizes; all but MobileNet-v1 only with ``int8_neck``,
calibrated (``--backbone-only`` is MobileNet-v1's alone, as in the JAX
package: the other backbones' activations are not all ReLU6-bounded).

``--data`` draws the calibration batches from a tfrecord glob through the
input pipeline in eval mode (``data.pipeline.Pipeline``), at the model's
image size.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ssd_tpu_torch.export import (add_artifact_args,
                                  load_artifact_label_map,
                                  load_inference_artifact,
                                  save_inference_artifact)
from ssd_tpu_torch.models.detector import Detector, check_supported
from ssd_tpu_torch.models.layers import calibrating


def calibrate(det: Detector, batches, percentile: float | None = None) -> int:
    """Observe activation ranges over ``batches`` (uint8 ``(N, H, W, 3)`` at
    the model's image size) and fold them into ``det``'s scales; returns
    the number of images seen. Scales only widen, across batches and
    calls: calibrating again, on other data, refreshes by ``max``.

    ``percentile``: ``None`` clips at the observed absmax; a float (say
    99.9) at that percentile of ``|x|`` in each batch, trading the extreme
    tail for a finer grid on the bulk.
    """
    seen = 0
    model = det.model.eval()
    with torch.no_grad(), calibrating(model, percentile):
        for images in batches:
            images = det.as_input(images)
            model(images)
            seen += images.shape[0]
    if not seen:
        raise ValueError("calibrate() got no batches")
    return seen


def int8_config(cfg, int8_neck: bool = True):
    """``cfg`` with ``compute_dtype="int8"`` and ``int8_neck``; a backbone
    other than MobileNet-v1 without ``int8_neck`` raises
    (``models.detector.check_supported``)."""
    qcfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="int8", int8_neck=int8_neck))
    check_supported(qcfg)
    return qcfg


def quantize_artifact(src: str, dst: str, batches, int8_neck: bool = True,
                      percentile: float | None = None, device=None) -> dict:
    """bf16/f32 inference artifact (a directory or a ``.npz``) -> int8
    artifact directory ``dst``, with the source's label map; returns its
    state.

    With ``int8_neck`` the model is calibrated on ``batches`` (on
    ``device``, ``None``: the card). Without, it is a pure config flip: the
    backbone's static scales need no state, and the artifact carries none.
    """
    cfg, state = load_inference_artifact(src)
    qcfg = int8_config(cfg, int8_neck)
    seen = 0
    if int8_neck:
        det = Detector(qcfg, state, device=device)
        seen = calibrate(det, batches, percentile)
        state = {k: v.cpu() for k, v in det.model.state_dict().items()}
    save_inference_artifact(dst, qcfg, state, load_artifact_label_map(src))
    print(f"calibrated on {seen} images -> {dst}")
    return state


def batches_from_tfrecords(pattern: str, cfg, batch_size: int,
                           max_batches: int):
    """uint8 batches of a tfrecord glob, decoded at the model size by the
    eval pipeline (its padded tail batch included); at most
    ``max_batches``."""
    from ssd_tpu_torch.data.pipeline import Pipeline

    pipeline = Pipeline(pattern, cfg, is_training=False,
                        batch_size=batch_size)
    for n, batch in enumerate(pipeline):
        if n >= max_batches:
            break
        yield batch["images"]


def batches_from_images(paths: list[str], image_hw, batch_size: int,
                        max_batches: int | None = None):
    """Image files -> uint8 batches at ``image_hw``, resized by PIL as the
    JAX package's CLI does; a short last batch repeats its final image."""
    from PIL import Image

    ih, iw = image_hw
    imgs = [np.asarray(Image.open(p).convert("RGB").resize((iw, ih)),
                       np.uint8) for p in paths]
    for n, i in enumerate(range(0, len(imgs), batch_size)):
        if max_batches is not None and n >= max_batches:
            break
        chunk = imgs[i:i + batch_size]
        chunk += [chunk[-1]] * (batch_size - len(chunk))
        yield np.stack(chunk)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_artifact_args(p)
    p.add_argument("--output", required=True,
                   help="destination directory of the int8 artifact")
    p.add_argument("--data", default="",
                   help="tfrecord glob of calibration images")
    p.add_argument("--images", nargs="*", default=[],
                   help="alternative: image files for calibration")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--batches", type=int, default=8,
                   help="at most this many calibration batches")
    p.add_argument("--backbone-only", action="store_true",
                   help="quantize only the backbone (calibration-free "
                        "static ReLU6 scales; FPN/head stay bf16)")
    p.add_argument("--percentile", type=float, default=None,
                   help="clip calibration at this percentile of |x| per "
                        "batch instead of absmax (e.g. 99.9)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    if not args.data and not args.images and not args.backbone_only:
        p.error("calibration needs --data or --images "
                "(or pass --backbone-only)")
    src = args.artifact
    cfg, _ = load_inference_artifact(src)
    if args.data:
        batches = batches_from_tfrecords(args.data, cfg, args.batch_size,
                                         args.batches)
    else:
        batches = batches_from_images(args.images, cfg.image_hw(),
                                      args.batch_size, args.batches)
    quantize_artifact(src, args.output, batches,
                      int8_neck=not args.backbone_only,
                      percentile=args.percentile, device=args.device)


if __name__ == "__main__":
    main()
