"""The sanity artifact's mAP, scored on the card or the CPU without JAX (the
port's ``ssd_tpu/eval/sanity.py`` ``evaluate_artifact_map``).

``assets/sanity_v1.npz`` holds the JAX package's committed sanity artifact
(a trained dense4 MobileNet-v1, 8 classes, 128 px) as the port's state
dict. Its 32 held-out scenes are re-derived from their seed by the port's
own generator (``data/synthetic.sanity_batches``, bit-identical to the JAX
package's), served by ``Predictor``, and scored by the port's COCO
evaluator. The int8 variant converts the same weights through
``quant.calibrate`` on the first batch of 8 training scenes (seed 7), as
the reference does.
"""

from __future__ import annotations

import os

from ssd_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                  NMSConfig, TrainConfig)
from ssd_tpu_torch.data.synthetic import (SANITY_CLASSES, SANITY_SEED_TRAIN,
                                          SANITY_SIZE, sanity_batches)
from ssd_tpu_torch.eval.coco_map import DetectionEvaluator
from ssd_tpu_torch.export import load_inference_artifact
from ssd_tpu_torch.predictor import Predictor
from ssd_tpu_torch.quant import calibrate, int8_config

SANITY_SEED_VAL = 1234
SANITY_VAL_IMAGES = 32
SANITY_NPZ = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "sanity_v1.npz")


def sanity_config() -> Config:
    """The sanity task's config (the JAX package's ``sanity_config``): a
    flagship-shaped dense4 MobileNet-v1 at x0.25, 8 classes, 128 px, bf16,
    trained with adam at b16 (``tools/make_bench_artifact.py``)."""
    return Config(
        num_classes=SANITY_CLASSES,
        image_size=SANITY_SIZE,
        model=ModelConfig(backbone="mobilenet", width_multiplier=0.25,
                          fpn_channels=32, head_depth=1,
                          stem_schedule="dense4", bn_momentum=0.9),
        nms=NMSConfig(),
        train=TrainConfig(batch_size=16, optimizer="adam",
                          learning_rate=1.5e-3, warmup_steps=50),
        data=DataConfig(max_gt_boxes=32),
    )


def sanity_predictor(npz: str = SANITY_NPZ, int8: bool = False,
                     device=None) -> Predictor:
    """The artifact's predictor (an artifact directory or ``.npz``); with
    ``int8``, converted (``int8_neck``) and calibrated on the seed-7 batch
    of 8."""
    cfg, state = load_inference_artifact(npz)
    if not int8:
        return Predictor(cfg, state, device=device)
    pred = Predictor(int8_config(cfg), state, device=device)
    calibrate(pred.detector, [next(sanity_batches(8, SANITY_SEED_TRAIN))[0]])
    return pred


def evaluate_predictor(pred: Predictor) -> dict:
    """``pred`` on the 32 val scenes, scored: the evaluator's result dict."""
    ev = DetectionEvaluator(pred.cfg.num_classes)
    for imgs, boxes, labels, nb, valid in sanity_batches(
            SANITY_VAL_IMAGES, SANITY_SEED_VAL):
        ev.add_batch(pred.predict(imgs), boxes, labels, nb, valid=valid)
    return ev.result()


def evaluate_map(npz: str = SANITY_NPZ, int8: bool = False,
                 device=None) -> float:
    """mAP of the sanity artifact on its seed-derived val set (``device``
    ``None``: the card)."""
    pred = sanity_predictor(npz, int8, device)
    return float(evaluate_predictor(pred)["mAP"])
