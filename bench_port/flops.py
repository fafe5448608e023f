"""The work per image that ``mfu`` divides by, counted once over the
reference at a cell's shapes, on the meta device (shapes only, no data).

``torch.utils.flop_counter.FlopCounterMode`` counts every convolution and
matrix product, forward and backward. Its formula for a grouped conv's
weight gradient ignores ``groups`` and counts it ``groups`` times over, so
that term is counted again here per group (as
``ssd_tpu_torch/tools/summarize.py`` corrects it). Training counts the
forward and the backward once each, no recomputation.

    python3 -m bench_port.flops   # prints each configuration's counts
"""

from __future__ import annotations

import json
import os

import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port.reference.model import Model


def _params(cfg: dict, grad: bool) -> dict:
    from bench_port.reference.shapes import param_shapes
    return {k: torch.zeros(s, device="meta", requires_grad=grad
                           and not k.endswith(("running_mean",
                                               "running_var")))
            for k, s in param_shapes(cfg).items()}


def _depthwise_wgrad_excess(model_params: dict, cfg: dict, batch: int
                            ) -> int:
    """What FlopCounterMode over-counts in the depthwise weight gradients
    of a MobileNet-v1 step: ``(groups - 1) / groups`` of its count."""
    if cfg["model"]["backbone"] != "mobilenet":
        return 0
    from bench_port.reference.model import MOBILENET_TABLE
    size = cfg["image_size"] // 2  # the stem's stride
    excess = 0
    for name, _, stride in MOBILENET_TABLE:
        w = model_params[f"backbone.{name}.depthwise.conv.weight"]
        c = w.shape[0]
        out = -(-size // stride)
        # counted 2 N Ho Wo C (C 9), right 2 N Ho Wo C 9
        excess += 2 * batch * out * out * c * 9 * (c - 1)
        size = out
    return excess


def per_image(cfg: dict, train: bool = False, batch: int = 2) -> int:
    """Conv and matmul FLOPs an image: the forward (eval mode), or with
    ``train`` the train-mode forward and its backward."""
    params = _params(cfg, train)
    model = Model(cfg, params)
    model.training = train
    size = cfg["image_size"]
    images = torch.zeros((batch, size, size, 3), dtype=torch.uint8,
                         device="meta")
    counter = FlopCounterMode(display=False)
    with counter:
        if train:
            raw = model(images)
            loss = sum(c.sum() + b.sum() for c, b in raw)
            loss.backward()
        else:
            with torch.no_grad():
                model(images)
    total = counter.get_total_flops()
    if train:
        total -= _depthwise_wgrad_excess(params, cfg, batch)
    return total // batch


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    for name in sorted(os.listdir(os.path.join(here, "configs"))):
        with open(os.path.join(here, "configs", name)) as f:
            cfg = json.load(f)["config"]
        print(name, {"serve": per_image(cfg),
                     "train": per_image(cfg, train=True)})


if __name__ == "__main__":
    main()
