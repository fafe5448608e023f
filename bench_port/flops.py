"""The work per image that ``mfu`` divides by, counted once over the
reference at a cell's shapes, on the meta device (shapes only, no data).

``torch.utils.flop_counter.FlopCounterMode`` counts every convolution and
matrix product, forward and backward. Its formula for a grouped conv's
weight gradient ignores ``groups`` and counts it ``groups`` times over, so
the reference module takes that excess off (its ``wgrad_excess``, as
``ssd_tpu_torch/tools/summarize.py`` corrects it). Training counts the
forward and the backward once each, no recomputation.

    python3 -m bench_port.flops   # prints each configuration's counts
"""

from __future__ import annotations

import json
import os

import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port.reference import for_config


def _params(ref, cfg: dict, grad: bool) -> dict:
    return {k: torch.zeros(s, device="meta", requires_grad=grad
                           and not k.endswith(("running_mean",
                                               "running_var")))
            for k, s in ref.param_shapes(cfg).items()}


def per_image(conf: dict, train: bool = False, batch: int = 2) -> int:
    """Conv and matmul FLOPs an image of the configuration ``conf`` (a
    configuration file's object), counted over its own reference
    (``reference.for_config``): the forward (eval mode), or with ``train``
    the train-mode forward and its backward."""
    ref = for_config(conf)
    cfg = conf["config"]
    params = _params(ref, cfg, train)
    model = ref.Model(cfg, params)
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
    if train and hasattr(ref, "wgrad_excess"):
        total -= ref.wgrad_excess(params, cfg, batch)
    return total // batch


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    for name in sorted(os.listdir(os.path.join(here, "configs"))):
        with open(os.path.join(here, "configs", name)) as f:
            conf = json.load(f)
        print(name, {"serve": per_image(conf),
                     "train": per_image(conf, train=True)})


if __name__ == "__main__":
    main()
