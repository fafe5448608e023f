"""Model cost summary: parameters, FLOPs, bytes and an H100 roofline (the
port's ``ssd_tpu/tools/summarize.py``).

The planning companion of the measuring tools (``bench_serve`` and
``bench_train`` measure; this predicts). The JAX tool reads XLA's cost
analysis of the compiled programs; eager PyTorch compiles no program, so
this one counts what the predict (``Detector.predict``) and one train step
(``train_step.make_train_step``: forward, backward and the optimizer) run,
op by op, under a ``TorchDispatchMode``:

* FLOPs: every convolution (forward and backward) and matrix product by
  ``torch.utils.flop_counter``'s formulas, split into classes by the peak
  that serves them: ``bf16`` (bf16/f16 convs and products), ``f32`` (f32
  ones: the port turns TF32 off), ``depthwise`` (grouped convs, which no
  tensor core serves) and ``int8`` (``torch._int_mm`` and the int8 conv's
  operator ``ssd_tpu_torch::conv_s8``, K4 on the card, each 2 M K N with
  K the conv's unpadded depth). The total
  is ``FlopCounterMode``'s for the same call, but for one term: that
  formula ignores ``groups`` in a grouped conv's weight gradient, counting
  it ``groups`` times over (C times for a depthwise conv), and this one
  counts it once. These count every tap of a padded border; XLA's cost
  analysis counts only the taps inside the image, so on small maps this
  count is the larger.
* Bytes: the tensor inputs and outputs of every op that is not a view, as
  eager moves them with no fusion: an upper estimate of the traffic.

The hand-written kernels (K1's suppression, K2's matching) launch through
ctypes, below the dispatcher: their work is in neither count.

Roofline (the H100 SXM data sheet): time is the larger of compute, the sum
over the classes of FLOPs over their peak (bf16 dense 989e12, int8
1979e12, f32 and depthwise 67e12 a second), and memory, bytes over
3.35e12 B/s. The counts do not depend on the device; it runs on the card
by default and on the CPU with ``--device cpu``.

    python -m ssd_tpu_torch.tools.summarize --config cfg.json [--batch 32] \\
        [--train] [--json out.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import conv_flop_count, flop_registry

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.ops import conv_s8_cuda  # noqa: F401  (the operator)

# H100 SXM data sheet: HBM rate, f32 (non-tensor-core) peak, dense bf16 and
# int8 tensor-core peaks
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_TENSOR_FLOP_PER_S = 989e12
INT8_TENSOR_OP_PER_S = 1979e12
PEAKS = {"bf16": BF16_TENSOR_FLOP_PER_S, "f32": F32_FLOP_PER_S,
         "depthwise": F32_FLOP_PER_S, "int8": INT8_TENSOR_OP_PER_S}
CHIP = "H100 SXM"

_aten = torch.ops.aten
_CONV_S8 = torch.ops.ssd_tpu_torch.conv_s8
_CONVS = {_aten.convolution: 8, _aten.convolution_backward: 9}  # groups arg
_SKIP_BYTES = {_aten.empty, _aten.empty_like, _aten.empty_strided,
               _aten.detach, _aten.lift_fresh}


def _dtype_class(dtype: torch.dtype) -> str:
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype in (torch.int8, torch.uint8):
        return "int8"
    return "f32"


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def _grouped_wgrad_excess(grad_out, x, weight, _bias, _stride, _padding,
                          _dilation, transposed, _output_padding, groups,
                          output_mask) -> int:
    """What ``flop_registry``'s ``convolution_backward`` formula counts
    beyond the true weight gradient of a grouped conv: it ignores
    ``groups`` there, counting that product ``groups`` times over."""
    if not output_mask[1] or transposed:
        return 0

    def t(shape):
        return [shape[1], shape[0]] + list(shape[2:])
    wgrad = conv_flop_count(t(x.shape), t(grad_out.shape), t(weight.shape))
    return wgrad - wgrad // groups


class CostCounter(TorchDispatchMode):
    """FLOPs by class and bytes of every op run under it (the module
    docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = collections.Counter()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet not in flop_registry and packet not in (_aten._int_mm,
                                                          _CONV_S8):
            # a composite op (conv2d under inference mode, linear) runs as
            # its parts, so that the counted ops below it are seen, as
            # FlopCounterMode does
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if packet is _aten._int_mm:
            (m, k), n = args[0].shape, args[1].shape[1]
            self.flops["int8"] += 2 * m * k * n
        elif packet is _CONV_S8:  # x, w, geometry: O, C, kh, kw ... Ho, Wo
            o, c, kh, kw = args[2][:4]
            m = args[0].shape[0] * args[2][-2] * args[2][-1]
            self.flops["int8"] += 2 * m * (kh * kw * c) * o
        elif packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            first = next(t for t in tree_flatten(args)[0]
                         if isinstance(t, torch.Tensor))
            cls = _dtype_class(first.dtype)
            if packet in _CONVS and args[_CONVS[packet]] > 1:
                cls = "depthwise"
                if packet is _aten.convolution_backward:
                    n -= _grouped_wgrad_excess(*args)
            self.flops[cls] += n
        if not func.is_view and packet not in _SKIP_BYTES:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out

    def cost(self) -> dict:
        return {"flops": float(sum(self.flops.values())),
                "bytes": float(self.bytes),
                "flops_by_class": {k: float(v) for k, v in
                                   sorted(self.flops.items())}}


def _roofline(cost: dict, batch: int) -> dict:
    t_compute = sum(n / PEAKS[c] for c, n in cost["flops_by_class"].items())
    t_memory = cost["bytes"] / HBM_BYTES_PER_S
    t = max(t_compute, t_memory)
    return {
        "arithmetic_intensity": round(
            cost["flops"] / max(cost["bytes"], 1.0), 1),
        "bound": "compute" if t_compute >= t_memory else "bandwidth",
        "roofline_ms": round(t * 1e3, 3),
        "roofline_img_per_s": round(batch / t, 1) if t else None,
    }


def _measured(fn, batch: int) -> dict:
    with CostCounter() as counter:
        fn()
    cost = counter.cost()
    cost.update(_roofline(cost, batch))
    cost["flops_per_image_g"] = round(cost["flops"] / batch / 1e9, 2)
    return cost


def summarize(cfg: Config, batch: int = 32, train: bool = False,
              device=None) -> dict:
    """The report: ``image_size``, ``batch``, ``params`` (total, MB in f32,
    by top-level module) and ``serve`` (and with ``train`` also ``train``),
    each with ``flops``, ``bytes``, ``flops_by_class``,
    ``arithmetic_intensity``, ``bound``, ``roofline_ms``,
    ``roofline_img_per_s`` and ``flops_per_image_g``. Weights seeded from
    0; ``device=None`` is the card."""
    from ssd_tpu_torch.models.detector import Detector

    det = Detector(cfg, device=device)
    ih, iw = cfg.image_hw()
    report: dict = {"image_size": [ih, iw], "batch": batch}

    per_module = {}
    for mod, sub in det.model.named_children():
        ps = list(sub.parameters())
        if ps:
            n = sum(p.numel() for p in ps)
            per_module[mod] = {"params": n, "mb": round(n * 4 / 2**20, 2)}
    n_total = sum(p["params"] for p in per_module.values())
    report["params"] = {"total": n_total,
                        "mb": round(n_total * 4 / 2**20, 2),
                        "by_module": per_module}

    images = torch.zeros((batch, ih, iw, 3), dtype=torch.uint8,
                         device=det.device)
    report["serve"] = _measured(lambda: det.predict(images), batch)

    if train:
        from ssd_tpu_torch.tools.bench_train import synthetic_batch
        from ssd_tpu_torch.train import DeviceFeed
        from ssd_tpu_torch.train_step import (Optimizer, create_train_state,
                                              make_train_step)

        tcfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, batch_size=batch))
        opt = Optimizer(tcfg)
        state = create_train_state(det, opt, tcfg.train.ema_decay)
        step = make_train_step(det, opt, tcfg.train.ema_decay,
                               tcfg.train.grad_accum_steps)
        data = DeviceFeed(det.device)(synthetic_batch(tcfg, batch))
        report["train"] = _measured(lambda: step(state, data), batch)
    return report


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--train", action="store_true",
                   help="also count one train step")
    p.add_argument("--json", default="")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)

    cfg = Config.load(args.config)
    r = summarize(cfg, args.batch, args.train, args.device)
    r["analysis_device"] = str(torch.device(args.device or "cuda"))

    pm = r["params"]
    mods = "  ".join(f"{k}:{v['params']/1e6:.2f}M" for k, v in
                     pm["by_module"].items())
    print(f"params: {pm['total']/1e6:.2f}M ({pm['mb']} MB f32)  [{mods}]")
    for name in ("serve", "train"):
        if name not in r:
            continue
        s = r[name]
        print(f"{name} @b{r['batch']}: {s['flops_per_image_g']} GFLOP/img, "
              f"AI {s['arithmetic_intensity']} flop/byte ({s['bound']}-bound)"
              f" -> {CHIP} roofline {s['roofline_ms']} ms/batch"
              f" = {s['roofline_img_per_s']} img/s")
    print("(bytes: every op's inputs and outputs with no fusion, an upper "
          "estimate; FLOPs count padded taps, NMS and matching not counted)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(r, f, indent=2)
        print(f"wrote {args.json}")
    return r


if __name__ == "__main__":
    main()
