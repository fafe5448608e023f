"""Declarative configuration, shared in form with the JAX package.

The port keeps its own copy of the JAX package's dataclasses so that both
read the same ``config.json`` files (``configs/*.json`` and the ``config.json``
of an inference artifact) without the port importing the JAX package. Every
field is kept, including those the port does not act on yet, so a config that
loads strictly there loads strictly here.

Fields that select a TPU lowering have no effect in the port:

* ``NMSConfig.use_pallas``: the suppression backend follows the tensors'
  device instead (CUDA tensors run the hand-written kernel in
  ``ops/nms_cuda.py``, CPU tensors its plain version).
* ``NMSConfig.approx_class_topk`` and ``NMSConfig.approx_cell_topk``: the
  JAX package lowers these to an exact top-k off the TPU, and the port's
  top-k is always exact, with the lower index first among equal values.
* ``MatcherConfig.use_pallas``: matching follows the tensors' device too
  (``ops/matching_cuda.py``: the hand-written kernel on CUDA tensors, its
  plain version on CPU tensors).
* ``ModelConfig.remat_early``: eager PyTorch keeps every activation.

Training fields the port's loop does not act on yet (``ROADMAP.md``):
``TrainConfig.eval_every``, ``init_from``, ``distill_*``,
``param_sharding``, ``multiscale``/``multiscale_every`` (the input
pipeline's job), and every ``DataConfig`` field but ``max_gt_boxes``.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Any, Sequence


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """RetinaNet-style dense anchor grid over FPN levels.

    Per level ``l`` (stride ``2**l``), anchors at every cell:
    ``scales_per_octave`` octave scales x ``aspect_ratios``, with base size
    ``anchor_scale * stride``.
    """

    min_level: int = 3
    max_level: int = 7
    anchor_scale: float = 4.0
    scales_per_octave: int = 3
    aspect_ratios: Sequence[float] = (1.0, 2.0, 0.5)

    @property
    def num_anchors_per_cell(self) -> int:
        return self.scales_per_octave * len(self.aspect_ratios)

    @property
    def strides(self) -> tuple[int, ...]:
        return tuple(2 ** l for l in range(self.min_level, self.max_level + 1))


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    backbone: str = "mobilenet"  # the port builds mobilenet (v1) only
    width_multiplier: float = 1.0
    fpn_channels: int = 128
    head_depth: int = 4  # number of 3x3 convs in each subnet
    head_channels: int = 0  # 0 -> same as fpn_channels
    head_final_kernel: int = 3  # the port builds 3 only
    # Conv compute dtype: bfloat16 | float32 (int8 is not ported yet).
    compute_dtype: str = "bfloat16"
    int8_neck: bool = False
    norm: str = "batch"  # the port builds "batch" only
    bn_momentum: float = 0.997
    stem_space_to_depth: bool = False
    remat_early: str = "none"
    # "dense4": space-to-depth(4) stem straight to stride 4; "reference":
    # the MobileNet table (stem at stride 2, ds1, ds2).
    stem_schedule: str = "reference"


@dataclasses.dataclass(frozen=True)
class LossConfig:
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    smooth_l1_delta: float = 1.0
    box_loss: str = "smooth_l1"
    localization_weight: float = 1.0
    classification_weight: float = 1.0
    weight_decay: float = 1e-4
    use_ohem: bool = False
    ohem_neg_ratio: float = 3.0
    ohem_min_negatives: int = 16
    per_level: bool = True


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    matching_threshold: float = 0.5
    negative_threshold: float = 0.4
    force_match_for_each_gt: bool = True
    use_pallas: bool | str = "auto"


@dataclasses.dataclass(frozen=True)
class NMSConfig:
    score_threshold: float = 0.05
    iou_threshold: float = 0.5
    max_boxes: int = 100  # final padded detections per image
    num_candidates: int = 1024  # anchors kept per image before NMS
    pre_nms_top_k: int = 128  # per-class candidates entering suppression
    use_pallas: bool | str = "auto"  # no effect in the port (see above)
    method: str = "hard"  # the port builds "hard" only
    soft_sigma: float = 0.5
    # "cells": cell-major candidate selection (the port's path);
    # "anchors": flat top-Q anchors (not ported yet).
    select: str = "cells"
    approx_class_topk: bool = True  # exact in the port (see above)
    # Two-stage cell selection: prefilter
    # ceil(num_candidates * cell_overprovision / K) cells, then keep the
    # top num_candidates anchors among them. 1.0 disables the refine stage.
    cell_overprovision: float = 2.0
    approx_cell_topk: bool = True  # exact in the port (see above)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 64
    num_steps: int = 90_000
    optimizer: str = "momentum"
    momentum: float = 0.9
    learning_rate: float = 0.08
    lr_schedule: str = "cosine"
    lr_boundaries: Sequence[int] = (60_000, 80_000)
    lr_rates: Sequence[float] = (1.0, 0.1, 0.01)
    warmup_steps: int = 500
    gradient_clip_norm: float = 10.0
    checkpoint_every: int = 1000
    keep_checkpoints: int = 5
    log_every: int = 100
    eval_every: int = 5000
    seed: int = 0
    ema_decay: float = 0.0
    init_from: str = ""
    freeze: str = ""
    distill_from: str = ""
    distill_weight: float = 1.0
    distill_temperature: float = 2.0
    distill_box_weight: float = 1.0
    grad_accum_steps: int = 1
    param_sharding: str = "replicated"
    multiscale: Sequence[int] = ()
    multiscale_every: int = 10


@dataclasses.dataclass(frozen=True)
class DataConfig:
    train_file_pattern: str = "data/train-*.tfrecords"
    val_file_pattern: str = "data/val-*.tfrecords"
    max_gt_boxes: int = 100
    num_workers: int = 8
    crop_min_ious: Sequence[float] = (0.1, 0.3, 0.5, 0.7, 0.9)
    crop_probability: float = 0.85
    flip_probability: float = 0.5
    color_jitter_probability: float = 0.5
    mosaic_probability: float = 0.0


_SECTIONS = {
    "model": ModelConfig, "anchors": AnchorConfig, "losses": LossConfig,
    "matcher": MatcherConfig, "nms": NMSConfig, "train": TrainConfig,
    "data": DataConfig,
}


@dataclasses.dataclass(frozen=True)
class Config:
    num_classes: int = 80  # foreground classes (sigmoid heads, no background)
    # A square int or an explicit (height, width) pair.
    image_size: int | Sequence[int] = 640
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    anchors: AnchorConfig = dataclasses.field(default_factory=AnchorConfig)
    losses: LossConfig = dataclasses.field(default_factory=LossConfig)
    matcher: MatcherConfig = dataclasses.field(default_factory=MatcherConfig)
    nms: NMSConfig = dataclasses.field(default_factory=NMSConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)

    def __post_init__(self):
        if not isinstance(self.image_size, int):
            object.__setattr__(
                self, "image_size",
                tuple(int(s) for s in self.image_size))

    def image_hw(self) -> tuple[int, int]:
        """Input resolution as (height, width), square or not."""
        if isinstance(self.image_size, int):
            return (self.image_size, self.image_size)
        h, w = self.image_size
        return (h, w)

    def feature_map_sizes(self) -> tuple[tuple[int, int], ...]:
        """Spatial size of each FPN level for this image size."""
        ih, iw = self.image_hw()
        return tuple((-(-ih // s), -(-iw // s)) for s in self.anchors.strides)

    def num_anchors(self) -> int:
        """Total number of anchors A for this image size."""
        k = self.anchors.num_anchors_per_cell
        return sum(h * w * k for h, w in self.feature_map_sizes())

    # ---------------------------------------------------------------- JSON io

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(dataclasses.asdict(self), indent=indent)

    @classmethod
    def from_dict(cls, d: dict[str, Any], strict: bool = True) -> "Config":
        """``strict=True`` rejects unknown keys; ``strict=False`` skips them
        with a warning (artifacts written by other versions)."""
        def build(dc_cls, sub):
            names = {f.name for f in dataclasses.fields(dc_cls)}
            kwargs = {}
            for key, value in sub.items():
                if key not in names:
                    if strict:
                        raise KeyError(
                            f"Unknown config key: {dc_cls.__name__}.{key}")
                    warnings.warn(f"ignoring unknown config key "
                                  f"{dc_cls.__name__}.{key}")
                    continue
                if dc_cls is Config and key in _SECTIONS:
                    kwargs[key] = build(_SECTIONS[key], value)
                elif isinstance(value, list):
                    kwargs[key] = tuple(value)
                else:
                    kwargs[key] = value
            return dc_cls(**kwargs)

        return build(cls, d)

    @classmethod
    def from_json(cls, text: str, strict: bool = True) -> "Config":
        return cls.from_dict(json.loads(text), strict=strict)

    @classmethod
    def load(cls, path: str, strict: bool = True) -> "Config":
        with open(path) as f:
            return cls.from_json(f.read(), strict=strict)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
