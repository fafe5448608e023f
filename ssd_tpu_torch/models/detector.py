"""Detector: backbone -> FPN -> heads, the training loss, and prediction.

``SSDModel`` maps raw images (NHWC uint8, or for dense4 the packed ``(N,
H/4, W/4, 48)`` s8 feed) to the per-level raw head maps. ``Detector``
holds the model and the anchors on a device and runs

* ``loss``: the model in train mode (batch-statistics BN, running stats
  updated), target creation with the matching kernel, the per-level (or
  flat) focal + box loss and L2, and with a teacher the distillation term
  -> ``(total, metrics)``;
* ``predict``: the model in eval mode, candidate selection and class-wise
  NMS, returning the public contract ``Detections(boxes, scores, labels,
  num_boxes)``. The dispatch is the JAX package's: a 1x1 final head conv
  (``head_final_kernel=1``) takes the fused head (``ops/fused_head.py``),
  else ``nms.select="cells"`` the cell-major selection, else the flat
  logits and anchor-wise selection.

Backbones (``model.backbone``): MobileNet-v1 (``mobilenet``, either stem
schedule), MobileNet-v2, EfficientNet-lite, ShuffleNet-v2 and ResNet-50;
``model.norm`` is ``"batch"`` or ``"group"``.

``compute_dtype="int8"`` is an inference lowering of the same weights: the
backbone's dense convs run int8, on static ReLU6 scales unless calibrated,
and with ``int8_neck`` the FPN and head too, on calibrated scales
(``quant.py``) that the state dict carries beside the weights. Without
``int8_neck`` the FPN and head run bf16. Every backbone but MobileNet-v1
needs ``int8_neck``, a calibrated model: their activations are not all
ReLU6-bounded (the JAX package's rule).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.constants import MEAN_RGB, STD_RGB
from ssd_tpu_torch.device import resolve_device
from ssd_tpu_torch.models.efficientnet import EfficientNetLite
from ssd_tpu_torch.models.fpn import FPN, RetinaHead, flatten_levels
from ssd_tpu_torch.models.layers import (BatchNorm, Conv, GroupNorm,
                                         QuantConv, compute_dtype,
                                         space_to_depth)
from ssd_tpu_torch.models.mobilenet import FoldedS2DConv, MobileNetV1
from ssd_tpu_torch.models.mobilenet_v2 import MobileNetV2
from ssd_tpu_torch.models.resnet import ResNet50
from ssd_tpu_torch.models.shufflenet import ShuffleNetV2
from ssd_tpu_torch.ops import losses
from ssd_tpu_torch.ops.distill import distillation_loss
from ssd_tpu_torch.ops.anchors import generate_anchors
from ssd_tpu_torch.ops.fused_head import fused_head_candidates
from ssd_tpu_torch.ops.nms import Detections
from ssd_tpu_torch.ops.postprocess import (run_nms, select_candidates,
                                           select_candidates_cells)
from ssd_tpu_torch.ops.targets import create_targets

BACKBONES = ("mobilenet", "mobilenet_v2", "efficientnet_lite", "shufflenet",
             "resnet50")


def normalize_images(images: torch.Tensor, mean: torch.Tensor | None = None,
                     std: torch.Tensor | None = None) -> torch.Tensor:
    """uint8 NHWC -> ImageNet-normalized bf16 NHWC, computed in f32 and
    rounded once (the JAX package's ``normalize_images``). ``mean`` and
    ``std``: the RGB constants already on the images' device (a model's
    buffers), so that no call copies them from the host, which would wait
    for the stream."""
    if mean is None:
        mean = torch.from_numpy(MEAN_RGB).to(images.device)
        std = torch.from_numpy(STD_RGB).to(images.device)
    return ((images.float() - mean) / std).to(torch.bfloat16)


def check_supported(cfg: Config) -> None:
    """Raise on a configuration the JAX package refuses (its
    ``build_backbone``): among them uncalibrated int8 off MobileNet-v1."""
    m = cfg.model
    if m.backbone not in BACKBONES:
        raise ValueError(f"unknown backbone: {m.backbone}")
    if m.norm not in ("batch", "group"):
        raise ValueError(f"unknown norm {m.norm!r}")
    if m.compute_dtype not in ("bfloat16", "float32", "int8"):
        raise NotImplementedError(
            f"model.compute_dtype={m.compute_dtype!r}: the port builds "
            "bfloat16, float32 and int8")
    if m.stem_schedule not in ("dense4", "reference"):
        raise ValueError(f"unknown stem_schedule {m.stem_schedule!r}")
    if m.stem_schedule != "reference" and m.backbone != "mobilenet":
        raise ValueError(
            f"stem_schedule={m.stem_schedule!r} is mobilenet-v1 only")
    if m.stem_schedule == "dense4" and m.stem_space_to_depth:
        raise ValueError(
            "stem_schedule='dense4' already space-to-depth-packs the stem; "
            "stem_space_to_depth must stay False")
    if (m.compute_dtype == "int8" and m.backbone != "mobilenet"
            and not m.int8_neck):
        raise ValueError(
            "uncalibrated int8 relies on ReLU6-bounded activations; only "
            "the mobilenet backbone supports it. Other backbones need a "
            "calibrated artifact: set model.int8_neck=true and run "
            "python -m ssd_tpu_torch.quant")


def build_backbone(cfg: Config) -> nn.Module:
    """The backbone ``cfg.model`` names (the JAX package's
    ``build_backbone``); each has ``out_channels`` (c3, c4, c5) and
    ``forward(images, dtype) -> {"c3", "c4", "c5"}``."""
    check_supported(cfg)
    m = cfg.model
    kw = dict(bn_momentum=m.bn_momentum, norm=m.norm,
              stem_stride=1 if m.stem_space_to_depth else 2,
              int8=m.compute_dtype == "int8")
    if m.backbone == "mobilenet":
        return MobileNetV1(m.width_multiplier, m.stem_schedule,
                           stem_fold_normalize=True,
                           remat_early=m.remat_early, **kw)
    if m.backbone == "mobilenet_v2":
        return MobileNetV2(m.width_multiplier, **kw)
    if m.backbone == "efficientnet_lite":
        return EfficientNetLite(m.width_multiplier, **kw)
    if m.backbone == "shufflenet":
        return ShuffleNetV2(m.width_multiplier, **kw)
    return ResNet50(**kw)


class SSDModel(nn.Module):
    """Backbone + FPN + shared subnets.

    dense4: the normalize affine is folded into the stem conv, so the model
    takes the raw uint8 image (or the packed s8 feed) and the normalized
    full-resolution image never exists. reference: a raw uint8 batch is
    normalized to bf16 first, whatever the compute dtype (f32 convs then
    widen the bf16 pixels, as in the JAX package); ``raw_input=False`` takes
    an already normalized float batch as it is.
    """

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        m = cfg.model
        self.backbone = build_backbone(cfg)
        neck = m.compute_dtype == "int8" and m.int8_neck
        self.fpn = FPN(self.backbone.out_channels, m.fpn_channels, neck)
        self.head = RetinaHead(
            m.fpn_channels, cfg.num_classes, cfg.anchors.num_anchors_per_cell,
            m.head_depth, m.head_channels or m.fpn_channels,
            m.head_final_kernel, neck)
        for name, mod in self.named_modules():
            if isinstance(mod, QuantConv):
                mod.path = name
        self.register_buffer("mean_rgb", torch.from_numpy(MEAN_RGB),
                             persistent=False)
        self.register_buffer("std_rgb", torch.from_numpy(STD_RGB),
                             persistent=False)

    def backbone_input(self, images: torch.Tensor,
                       raw_input: bool = True) -> torch.Tensor:
        """What the backbone takes: for the reference schedule the
        normalized (and, with ``stem_space_to_depth``, space-to-depth(2)
        packed) NHWC image; for dense4 the raw image as it is."""
        m = self.cfg.model
        if m.stem_schedule == "dense4":
            if not raw_input:
                raise ValueError("the dense4 stem folds the normalization: "
                                 "it takes the raw image")
            return images
        if raw_input:
            images = normalize_images(images, self.mean_rgb, self.std_rgb)
        if m.stem_space_to_depth:
            images = space_to_depth(images, 2)
        return images

    def forward(self, images: torch.Tensor, raw_input: bool = True,
                trunk_only: bool = False):
        """images NHWC (uint8 or, for dense4, packed s8; normalized floats
        with ``raw_input=False``) -> ``[(cls (N, H, W, K*C), box (N, H, W,
        K*4)), ...]`` in the compute dtype; with ``trunk_only`` the head's
        ``(cls_trunk, box_trunk)``, each ``(N, cells, channels)``."""
        dtype = compute_dtype(self.cfg.model.compute_dtype)
        feats = self.backbone(self.backbone_input(images, raw_input), dtype)
        pyramid = self.fpn(feats)
        return self.head.trunks(pyramid) if trunk_only else self.head(pyramid)

    def reset_parameters(self, seed: int) -> None:
        """Seeded init in the JAX package's scheme: conv kernels normal with
        std ``1/sqrt(fan_in)`` (prediction convs 0.01), zero biases, the
        class prior on the class-head bias, identity batch norm. The draws
        come from a CPU generator, so a seed gives the same weights on any
        device."""
        gen = torch.Generator(device="cpu").manual_seed(seed)
        with torch.no_grad():
            for name, mod in self.named_modules():
                if isinstance(mod, FoldedS2DConv):
                    mod.weight.copy_(torch.empty(mod.weight.shape).normal_(
                        0.0, 1.0 / math.sqrt(48 * 9), generator=gen))
                elif isinstance(mod, Conv):
                    if name.endswith(".predict"):
                        bias = (self.head.class_net.final_bias_init
                                if ".class_net." in name else 0.0)
                        mod.reset_parameters(gen, std=0.01, bias_value=bias)
                    else:
                        mod.reset_parameters(gen)
                elif isinstance(mod, BatchNorm):
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()
                    mod.running_mean.zero_()
                    mod.running_var.fill_(1.0)
                elif isinstance(mod, GroupNorm):
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()


class Detector:
    """Model, anchors, ``loss`` and ``predict`` on one device (``None`` ->
    CUDA).

    ``state``: a state dict (``convert.convert_variables``) loaded strictly;
    without one the weights are seeded from 0. ``model``: an existing
    ``SSDModel`` on ``device`` to share instead (a second resolution of the
    same weights: only the anchors differ).
    """

    def __init__(self, cfg: Config, state: dict | None = None, device=None,
                 model: SSDModel | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if model is None:
            model = SSDModel(cfg)
            if state is None:
                model.reset_parameters(seed=0)
            else:
                model.load_state_dict(state, strict=True)
            model = model.to(self.device).eval()
            if self.device.type == "cuda":
                model.to(memory_format=torch.channels_last)
        elif state is not None:
            raise ValueError("pass a state or a model, not both")
        self.model = model
        anchors = generate_anchors(cfg.image_size, cfg.anchors)
        assert anchors.shape[0] == cfg.num_anchors()
        self.anchors = torch.from_numpy(anchors).to(self.device)

    def as_input(self, images) -> torch.Tensor:
        """numpy or tensor images -> a tensor on this detector's device."""
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(np.ascontiguousarray(images))
        return images.to(self.device, non_blocking=True)

    def loss(self, batch: dict, teacher: "Detector | None" = None,
             l2: bool = True) -> tuple[torch.Tensor, dict]:
        """The training loss of one batch, with gradients.

        ``batch``: ``images`` uint8 ``(N, H, W, 3)``, ``boxes (N, M, 4)``,
        ``labels (N, M)`` int, ``num_boxes (N,)`` int (numpy or tensors).
        Runs the model in train mode, which updates the BN running
        statistics in place. ``teacher``: a trained ``Detector`` of the same
        head geometry on this device; its eval-mode forward on the same
        images, without gradients, adds ``train.distill_weight`` times the
        distillation loss (``ops/distill.py``), logged as ``distill_loss``.
        Returns ``(total, metrics)``; the metrics are detached scalars on
        the device.

        ``l2``: add the L2 term to ``total`` and report it as
        ``regularization_loss``; ``False`` leaves it out (a data-parallel
        step adds its gradient once, after summing the ranks').
        """
        cfg = self.cfg
        # OHEM ranks per-anchor losses, which only the flat loss forms
        per_level = cfg.losses.per_level and not cfg.losses.use_ohem
        self.model.train()
        images = self.as_input(batch["images"])
        raw = self.model(images)
        targets = create_targets(
            self.anchors, self.as_input(batch["boxes"]),
            self.as_input(batch["labels"]), self.as_input(batch["num_boxes"]),
            cfg.num_classes, cfg.matcher, class_onehot=not per_level)
        if per_level:
            ld = losses.detection_loss_levels(raw, targets, cfg.num_classes,
                                              cfg.losses, anchors=self.anchors)
        else:
            logits, deltas = flatten_levels(raw, cfg.num_classes)
            ld = losses.detection_loss(logits, deltas, targets, cfg.losses,
                                       anchors=self.anchors)
        metrics = {"loss": None, "classification_loss": ld.classification,
                   "localization_loss": ld.localization}
        total = ld.total
        if l2:
            reg = losses.l2_regularization(self.model.parameters(),
                                           cfg.losses.weight_decay)
            total = total + reg
            metrics["regularization_loss"] = reg
        metrics["loss"] = total
        metrics["num_positives"] = ld.num_positives
        if teacher is not None:
            with torch.no_grad():
                t_raw = teacher.model.eval()(images)
            if per_level:
                s_out = raw
            else:
                s_out = (logits, deltas)
                t_raw = flatten_levels(t_raw, cfg.num_classes)
            dd = distillation_loss(
                s_out, t_raw, cfg.num_classes,
                temperature=cfg.train.distill_temperature,
                box_weight=cfg.train.distill_box_weight)
            total = total + cfg.train.distill_weight * dd.total
            metrics["loss"] = total
            metrics["distill_loss"] = dd.total
        return total, {k: v.detach() for k, v in metrics.items()}

    @torch.inference_mode()
    def raw(self, images) -> list:
        """Per-level raw head maps for uint8 (or packed s8) images."""
        return self.model.eval()(self.as_input(images))

    @torch.inference_mode()
    def candidates(self, images) -> tuple[torch.Tensor, torch.Tensor]:
        """uint8 NHWC images (or the packed s8 feed) -> the candidates that
        enter NMS, ``boxes (N, Q, 4)`` and ``scores (N, Q, C)``
        (``select_for_nms``)."""
        return select_for_nms(self.model.eval(), self.anchors, self.cfg,
                              self.as_input(images))

    @torch.inference_mode()
    def predict(self, images) -> Detections:
        """uint8 NHWC images (or the packed s8 feed) -> NMS'd detections:
        ``candidates``, then hard NMS with the suppression kernel on the
        card (its plain version on the CPU) or Soft-NMS
        (``postprocess.run_nms``)."""
        return run_nms(*self.candidates(images), self.cfg.nms)


def select_for_nms(model: SSDModel, anchors: torch.Tensor, cfg: Config,
                   images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``model`` (in eval mode) on device ``images`` -> the candidates that
    enter NMS, selected as the JAX package's ``Detector.predict``
    dispatches: the fused head (``head_final_kernel=1``), else the cells
    selection (``nms.select="cells"``), else the flat anchor-wise one. No
    grad mode of its own, so that ``torch.export`` traces it (``export.py``)."""
    if cfg.model.head_final_kernel == 1:
        cls_trunk, box_trunk = model(images, trunk_only=True)
        return fused_head_candidates(
            cls_trunk, box_trunk, model.head, anchors, cfg.num_classes,
            cfg.anchors.num_anchors_per_cell, cfg.nms)
    raw = model(images)
    if cfg.nms.select == "cells":
        return select_candidates_cells(raw, anchors, cfg.num_classes, cfg.nms)
    logits, deltas = flatten_levels(raw, cfg.num_classes)
    return select_candidates(logits, deltas, anchors, cfg.nms)
