"""Detector: backbone -> FPN -> heads, and prediction.

``SSDModel`` maps raw images (NHWC uint8, or the packed ``(N, H/4, W/4,
48)`` s8 feed) to the per-level raw head maps. ``Detector`` holds the model
and the anchors on a device and runs ``predict``: the model, cell-major
candidate selection and class-wise hard NMS, returning the public contract
``Detections(boxes, scores, labels, num_boxes)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.device import resolve_device
from ssd_tpu_torch.models.fpn import FPN, RetinaHead
from ssd_tpu_torch.models.layers import BatchNorm, Conv, compute_dtype
from ssd_tpu_torch.models.mobilenet import FoldedS2DConv, MobileNetV1
from ssd_tpu_torch.ops.anchors import generate_anchors
from ssd_tpu_torch.ops.nms import Detections
from ssd_tpu_torch.ops.postprocess import postprocess_cells


def check_supported(cfg: Config) -> None:
    """Raise on a configuration this slice of the port does not build."""
    m, n = cfg.model, cfg.nms
    unsupported = [
        (m.backbone != "mobilenet", f"model.backbone={m.backbone!r}"),
        (m.stem_schedule != "dense4", f"model.stem_schedule={m.stem_schedule!r}"),
        (m.stem_space_to_depth, "model.stem_space_to_depth=true"),
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
    """Backbone + FPN + shared subnets on raw input.

    The normalize affine is folded into the dense4 stem conv, so the model
    takes the raw uint8 image (or the packed s8 feed) and the normalized
    full-resolution image never exists.
    """

    def __init__(self, cfg: Config):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        m = cfg.model
        self.backbone = MobileNetV1(m.width_multiplier, m.stem_schedule,
                                    stem_fold_normalize=True)
        self.fpn = FPN(self.backbone.out_channels, m.fpn_channels)
        self.head = RetinaHead(
            m.fpn_channels, cfg.num_classes, cfg.anchors.num_anchors_per_cell,
            m.head_depth, m.head_channels or m.fpn_channels,
            m.head_final_kernel)

    def forward(self, images: torch.Tensor) -> list:
        """images NHWC uint8 or packed s8 -> ``[(cls (N, H, W, K*C), box (N,
        H, W, K*4)), ...]`` in the compute dtype."""
        dtype = compute_dtype(self.cfg.model.compute_dtype)
        feats = self.backbone(images, dtype)
        return self.head(self.fpn(feats))

    def reset_parameters(self, seed: int) -> None:
        """Seeded init in the JAX package's scheme: conv kernels normal with
        std ``1/sqrt(fan_in)`` (prediction convs 0.01), zero biases, the
        class prior on the class-head bias, identity batch norm."""
        gen = torch.Generator(device="cpu").manual_seed(seed)
        with torch.no_grad():
            for name, mod in self.named_modules():
                if isinstance(mod, FoldedS2DConv):
                    mod.weight.normal_(0.0, 1.0 / math.sqrt(48 * 9),
                                       generator=gen)
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
    """Model, anchors and ``predict`` on one device (``None`` -> CUDA).

    ``state``: a state dict (``convert.convert_variables``) loaded strictly;
    without one the weights are seeded from 0.
    """

    def __init__(self, cfg: Config, state: dict | None = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        model = SSDModel(cfg)
        if state is None:
            model.reset_parameters(seed=0)
        else:
            model.load_state_dict(state, strict=True)
        self.model = model.to(self.device).eval()
        if self.device.type == "cuda":
            self.model.to(memory_format=torch.channels_last)
        anchors = generate_anchors(cfg.image_size, cfg.anchors)
        assert anchors.shape[0] == cfg.num_anchors()
        self.anchors = torch.from_numpy(anchors).to(self.device)

    def as_input(self, images) -> torch.Tensor:
        """numpy or tensor images -> a tensor on this detector's device."""
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(np.ascontiguousarray(images))
        return images.to(self.device, non_blocking=True)

    @torch.inference_mode()
    def raw(self, images) -> list:
        """Per-level raw head maps for uint8 (or packed s8) images."""
        return self.model(self.as_input(images))

    @torch.inference_mode()
    def predict(self, images) -> Detections:
        """uint8 NHWC images (or the packed s8 feed) -> NMS'd detections."""
        return postprocess_cells(self.raw(images), self.anchors,
                                 self.cfg.num_classes, self.cfg.nms)
