"""Micro-benchmark: the fused ds1+ds2 kernel against the model's own ds1 and
ds2 modules, on the card.

    python -m ssd_tpu_torch.tools.bench_fused_early [--batch 32] [--size 320]
        [--iters 20] [--seed 0]

Counterpart of ``ssd_tpu/tools/bench_fused_early.py``. The weights are the
port's reference-schedule MobileNet-v1 x1.0, seeded
(``SSDModel.reset_parameters``); the input is a seeded normal draw of shape
``(batch, 32, size, size)``, bf16 in ``channels_last``: what the stem hands
ds1 at 640 px when ``size`` is 320. Prints one JSON line: the largest
absolute difference between the kernel and the modules (cuDNN in bf16, each
conv rounded to bf16), and the CUDA-event time of each after warm-up. Runs
on the card and raises without one.

``chip_smoke.py`` calls ``reference_backbone``, ``randomize_early_bn`` and
``run`` on the served model's weights and its stem output.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.device import resolve_device
from ssd_tpu_torch.models.detector import SSDModel
from ssd_tpu_torch.ops.fused_early import fold_early_params
from ssd_tpu_torch.ops.fused_early_cuda import fused_ds1_ds2


def reference_backbone(width: float = 1.0, seed: int = 0, device=None):
    """A seeded reference-schedule MobileNet-v1 in eval mode on ``device``
    (``None``: the card), in ``channels_last`` there."""
    dev = resolve_device(device)
    cfg = Config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, width_multiplier=width, stem_schedule="reference"))
    model = SSDModel(cfg)
    model.reset_parameters(seed)
    backbone = model.backbone.to(dev).eval()
    if dev.type == "cuda":
        backbone.to(memory_format=torch.channels_last)
    return backbone


def randomize_early_bn(backbone, seed: int, gain: float = 1.0) -> None:
    """ds1/ds2 batch norm as ``tests/test_fused_early.py`` draws it: scale
    U(0.5, 1.5) (times ``gain`` for the pointwise ones), bias and mean
    N(0, 0.3), variance U(0.5, 2)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for ds in ("ds1", "ds2"):
            for part in ("depthwise", "pointwise"):
                bn = getattr(getattr(backbone, ds), part).bn
                c = bn.weight.shape[0]
                g = gain if part == "pointwise" else 1.0
                for t, v in ((bn.weight, rng.uniform(0.5, 1.5, c) * g),
                             (bn.bias, rng.normal(0, 0.3, c)),
                             (bn.running_mean, rng.normal(0, 0.3, c)),
                             (bn.running_var, rng.uniform(0.5, 2.0, c))):
                    t.copy_(torch.from_numpy(v.astype(np.float32)))


def make_input(batch: int, size: int, channels: int, seed: int = 0,
               device=None) -> torch.Tensor:
    """A seeded standard-normal ``(batch, channels, size, size)`` bf16 batch
    in ``channels_last``, drawn NHWC with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, size, size, channels), dtype=np.float32)
    x = torch.from_numpy(x).to(resolve_device(device)).to(torch.bfloat16)
    return x.permute(0, 3, 1, 2)  # NHWC bytes: channels_last


def unfused(backbone, x: torch.Tensor) -> torch.Tensor:
    """The model's own ds1 and ds2 modules."""
    return backbone.ds2(backbone.ds1(x))


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean CUDA-event milliseconds of ``fn()`` over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@torch.inference_mode()
def run(backbone, x: torch.Tensor, iters: int = 20) -> dict:
    """The kernel (the plain version on CPU tensors) against the modules on
    ``x``; with ``iters > 0`` also the time of each, which needs the card."""
    folded = fold_early_params(backbone)
    got = fused_ds1_ds2(x, folded)
    want = unfused(backbone, x)
    row = {"shape_in": list(x.shape), "shape_out": list(got.shape),
           "max_abs_diff": float((got.float() - want.float()).abs().max())}
    if iters > 0:
        if x.device.type != "cuda":
            raise RuntimeError("timing needs the card: pass CUDA tensors")
        row["fused_ms"] = cuda_ms(lambda: fused_ds1_ds2(x, folded), iters)
        row["unfused_ms"] = cuda_ms(lambda: unfused(backbone, x), iters)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=int, default=320,
                    help="height and width of ds1's input (the stem output)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    backbone = reference_backbone(seed=args.seed)
    c1 = backbone.ds1.depthwise.conv.weight.shape[0]
    x = make_input(args.batch, args.size, c1, args.seed)
    row = run(backbone, x, args.iters)
    row["device"] = torch.cuda.get_device_name(x.device)
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
