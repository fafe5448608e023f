"""Detector: backbone -> FPN -> heads, the training loss, and prediction.

``SSDModel`` maps raw images (NHWC uint8, or for dense4 the packed ``(N,
H/4, W/4, 48)`` s8 feed) to the per-level raw head maps. ``Detector``
holds the model and the anchors on a device and runs

* ``loss``: the model in train mode (batch-statistics BN, running stats
  updated), target creation with the matching kernel, the per-level (or
  flat) focal + box loss and L2 -> ``(total, metrics)``;
* ``predict``: the model in eval mode, cell-major candidate selection and
  class-wise hard NMS, returning the public contract ``Detections(boxes,
  scores, labels, num_boxes)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.constants import MEAN_RGB, STD_RGB
from ssd_tpu_torch.device import resolve_device
from ssd_tpu_torch.models.fpn import FPN, RetinaHead, flatten_levels
from ssd_tpu_torch.models.layers import (BatchNorm, Conv, compute_dtype,
                                         space_to_depth)
from ssd_tpu_torch.models.mobilenet import FoldedS2DConv, MobileNetV1
from ssd_tpu_torch.ops import losses
from ssd_tpu_torch.ops.anchors import generate_anchors
from ssd_tpu_torch.ops.nms import Detections
from ssd_tpu_torch.ops.postprocess import postprocess_cells
from ssd_tpu_torch.ops.targets import create_targets


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> ImageNet-normalized bf16 NHWC, computed in f32 and
    rounded once (the JAX package's ``normalize_images``)."""
    mean = torch.from_numpy(MEAN_RGB).to(images.device)
    std = torch.from_numpy(STD_RGB).to(images.device)
    return ((images.float() - mean) / std).to(torch.bfloat16)


def check_supported(cfg: Config) -> None:
    """Raise on a configuration the port does not build yet."""
    m, n = cfg.model, cfg.nms
    if m.stem_schedule == "dense4" and m.stem_space_to_depth:
        raise ValueError(
            "stem_schedule='dense4' already space-to-depth-packs the stem; "
            "stem_space_to_depth must stay False")
    unsupported = [
        (m.backbone != "mobilenet", f"model.backbone={m.backbone!r}"),
        (m.stem_schedule not in ("dense4", "reference"),
         f"model.stem_schedule={m.stem_schedule!r}"),
        (m.norm != "batch", f"model.norm={m.norm!r}"),
        (m.compute_dtype not in ("bfloat16", "float32"),
         f"model.compute_dtype={m.compute_dtype!r}"),
        (m.head_final_kernel != 3,
         f"model.head_final_kernel={m.head_final_kernel}"),
        (n.select != "cells", f"nms.select={n.select!r}"),
        (n.method != "hard", f"nms.method={n.method!r}"),
    ]
    for bad, what in unsupported:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported yet (see ROADMAP.md)")


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
        check_supported(cfg)
        self.cfg = cfg
        m = cfg.model
        self.backbone = MobileNetV1(m.width_multiplier, m.stem_schedule,
                                    stem_fold_normalize=True,
                                    bn_momentum=m.bn_momentum,
                                    stem_stride=1 if m.stem_space_to_depth
                                    else 2)
        self.fpn = FPN(self.backbone.out_channels, m.fpn_channels)
        self.head = RetinaHead(
            m.fpn_channels, cfg.num_classes, cfg.anchors.num_anchors_per_cell,
            m.head_depth, m.head_channels or m.fpn_channels,
            m.head_final_kernel)

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
            images = normalize_images(images)
        if m.stem_space_to_depth:
            images = space_to_depth(images, 2)
        return images

    def forward(self, images: torch.Tensor, raw_input: bool = True) -> list:
        """images NHWC (uint8 or, for dense4, packed s8; normalized floats
        with ``raw_input=False``) -> ``[(cls (N, H, W, K*C), box (N, H, W,
        K*4)), ...]`` in the compute dtype."""
        dtype = compute_dtype(self.cfg.model.compute_dtype)
        feats = self.backbone(self.backbone_input(images, raw_input), dtype)
        return self.head(self.fpn(feats))

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

    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """The training loss of one batch, with gradients.

        ``batch``: ``images`` uint8 ``(N, H, W, 3)``, ``boxes (N, M, 4)``,
        ``labels (N, M)`` int, ``num_boxes (N,)`` int (numpy or tensors).
        Runs the model in train mode, which updates the BN running
        statistics in place. Returns ``(total, metrics)``; the metrics are
        detached scalars on the device.
        """
        cfg = self.cfg
        # OHEM ranks per-anchor losses, which only the flat loss forms
        per_level = cfg.losses.per_level and not cfg.losses.use_ohem
        self.model.train()
        raw = self.model(self.as_input(batch["images"]))
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
        reg = losses.l2_regularization(self.model.parameters(),
                                       cfg.losses.weight_decay)
        total = ld.total + reg
        metrics = {"loss": total, "classification_loss": ld.classification,
                   "localization_loss": ld.localization,
                   "regularization_loss": reg,
                   "num_positives": ld.num_positives}
        return total, {k: v.detach() for k, v in metrics.items()}

    @torch.inference_mode()
    def raw(self, images) -> list:
        """Per-level raw head maps for uint8 (or packed s8) images."""
        return self.model.eval()(self.as_input(images))

    @torch.inference_mode()
    def predict(self, images) -> Detections:
        """uint8 NHWC images (or the packed s8 feed) -> NMS'd detections."""
        return postprocess_cells(self.raw(images), self.anchors,
                                 self.cfg.num_classes, self.cfg.nms)
