"""K4, the int8 dense conv (``csrc/conv_s8.cu``), on the card.

    python -m ssd_tpu_torch.tools.bench_conv_s8 [--config C] [--batch 32] \\
        [--iters 20] [--cases-only] [--models]

Prints one JSON line a part:

1. ``conv_case``: every case of ``tools/kernel_cases.conv_cases`` through
   the kernel and through its plain version (``layers.conv_s8_plain``),
   both on the card, bit for bit;
2. ``conv_forward``: the config's int8 forward (``int8_neck``, seeded
   weights, calibrated on a seeded batch of 8) at ``batch``: K4's launches
   against the int8 dense convs it ran, ``torch._int_mm`` calls (none) and
   weight preparations after the first forward (none);
3. ``conv_shape``: each distinct conv shape of that forward on seeded
   inputs, K4 bit-equal to the plain version there, how often it runs,
   K4's time (CUDA events), its bound (the larger of 2 M K N at the
   int8 peak and its bytes, the input read once, the weights and the
   output written once, at the HBM rate), the plain composition's time and
   ``torch._int_mm``'s alone on the shape's im2col (the library call the
   port no longer makes);
4. ``conv_host``: one conv's host cost through the operator
   ``ssd_tpu_torch::conv_s8`` and through the wrapper alone;
5. ``conv_model`` (``--models``): the config's int8 forward at ``batch``,
   then each shipped config's at 2, with K4 against the same forward with
   every conv in its plain composition on the card, raw maps bit for bit
   (``model_equal``).

``--config`` takes a config file or a benchmark configuration (its
``config`` key); the default is the flagship's. ``chip_smoke.py``'s
``conv_s8`` phase runs ``main``. Runs on the card and raises without one.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.models import layers
from ssd_tpu_torch.models.mobilenet import Int8FoldedS2DConv
from ssd_tpu_torch.ops import conv_s8_cuda
from ssd_tpu_torch.parallel.spatial import same_pad
from ssd_tpu_torch.predictor import Predictor
from ssd_tpu_torch.tools import bench_serve, kernel_cases
from ssd_tpu_torch.tools.bench_fused_early import cuda_ms
from ssd_tpu_torch.tools.bench_kernels import kernel_ms
from ssd_tpu_torch.tools.summarize import (HBM_BYTES_PER_S,
                                           INT8_TENSOR_OP_PER_S)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FLAGSHIP = os.path.join(ROOT, "configs", "coco_mobilenet_640_flagship.json")
ACT_RANGE = 6.0  # the static scale's bound, as QuantConv's default


def strip_geometry(h: int, k: int, s: int, strip) -> tuple:
    """``(first row, last row + 1, (pad_top, pad_bottom), out_h)`` of the
    input a SAME conv over ``h`` rows reads for the output rows of the
    strip ``[r0, r1)`` (``parallel.spatial.Strips.halo``'s arithmetic), or
    of the whole map."""
    if strip is None:
        return 0, h, same_pad(h, k, s), -(-h // s)
    r0, r1 = strip
    o0, o1 = -(-r0 // s), -(-r1 // s)
    before = same_pad(h, k, s)[0]
    a, b = s * o0 - before, s * (o1 - 1) - before + k
    return max(a, 0), min(b, h), (max(0, -a), max(0, b - h)), o1 - o0


def case_inputs(case: kernel_cases.ConvCase, device) -> dict:
    """``conv_s8``'s arguments for ``case`` on ``device``, drawn from its
    seed."""
    rng = np.random.default_rng(case.seed)
    h, w = case.hw
    if case.dtype == "s8":
        nhwc = torch.from_numpy(rng.integers(
            -127, 128, (case.n, h, w, case.c), dtype=np.int8))
    else:
        nhwc = torch.from_numpy(rng.normal(
            0.0, 2.0, (case.n, h, w, case.c)).astype(np.float32)).to(
                torch.bfloat16)
    x = nhwc.to(device).permute(0, 3, 1, 2)
    if case.layout == "nchw":
        x = x.contiguous()
    lo, hi, pads_h, ho = strip_geometry(h, case.k, case.stride, case.strip)
    x = x[:, :, lo:hi]
    weight = rng.normal(0.0, 0.05, (case.o, case.c, case.k, case.k))
    weight[0] = 0.0  # an all-zero channel: k_scale floored at 1e-8
    k_q, k_scale = layers.quantize_weight(
        torch.from_numpy(weight.astype(np.float32)).to(device))
    args = {"x": x, "w": conv_s8_cuda.pack_weight(k_q),
            "geometry": [case.o, case.c, case.k, case.k, case.stride,
                         *pads_h, *same_pad(w, case.k, case.stride), ho,
                         -(-w // case.stride)],
            "k_scale": None, "bias": None, "a_scale": None,
            "reciprocal": None}
    if case.dtype == "bf16":
        args["k_scale"] = k_scale
        static = np.float32(ACT_RANGE / layers.INT8_MAX)
        scale = static if case.scale is None else np.float32(case.scale)
        args["a_scale"] = torch.tensor(scale, device=device)
        if case.scale is None:
            args["reciprocal"] = torch.tensor(np.float32(1.0) / static,
                                              device=device)
        if case.bias:
            args["bias"] = torch.from_numpy(rng.normal(
                0.0, 0.5, case.o).astype(np.float32)).to(device)
    return args


def equal_to_plain(args: dict, name: str) -> tuple:
    """K4 and the plain version (``layers.conv_s8_plain``) on the card on
    ``args``: raises unless they are equal bit for bit; returns both."""
    got = conv_s8_cuda.conv_s8_cuda(**args)
    want = layers.conv_s8_plain(**args)
    torch.cuda.synchronize(got.device)
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"conv {name}: {got.dtype} "
                             f"{tuple(got.shape)}, plain {want.dtype} "
                             f"{tuple(want.shape)}")
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    diff = got.view(bits) != want.view(bits)
    if bool(diff.any()):
        first = [int(i) for i in diff.nonzero()[0]]
        raise AssertionError(
            f"conv {name}: {int(diff.sum())} of {diff.numel()} outputs "
            f"differ from the plain version, the first at {first}: "
            f"{got[tuple(first)].item()} against {want[tuple(first)].item()}")
    return got, want


@torch.inference_mode()
def check_case(case: kernel_cases.ConvCase, device) -> dict:
    """The kernel against the plain version on ``case``: raises unless
    they are equal bit for bit."""
    args = case_inputs(case, device)
    got, want = equal_to_plain(args, case.name)
    x = args["x"]
    return {"case": case.name, "x": list(x.shape), "stride_x": list(
        x.stride()), "dtype": str(x.dtype), "geometry": args["geometry"],
        "out": list(got.shape), "out_dtype": str(got.dtype),
        "bit_equal": True,
        "nonzero_share": float((want != 0).float().mean())}


# ------------------------------------------------------------- the forward

def int8_predictor(config: str, device) -> Predictor:
    """The config's model in int8 with ``int8_neck``, seeded weights,
    calibrated on the seeded batch of 8."""
    with open(config) as f:
        raw = json.load(f)
    cfg = Config.from_dict(raw.get("config", raw))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="int8", int8_neck=True))
    pred = Predictor(cfg, None, device=device)
    bench_serve.calibrate_seeded(pred)
    return pred


class _IntMMCount(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.int_mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._overloadpacket is torch.ops.aten._int_mm:
            self.int_mm += 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def conv_calls(model: torch.nn.Module):
    """Within: a one-item list, the count of int8 dense convs ``model``
    runs (``QuantConv`` and ``Int8FoldedS2DConv`` calls, by forward
    hooks)."""
    count = [0]
    hooks = [m.register_forward_hook(lambda *_: count.__setitem__(
        0, count[0] + 1)) for m in model.modules()
        if isinstance(m, (layers.QuantConv, Int8FoldedS2DConv))]
    try:
        yield count
    finally:
        for hook in hooks:
            hook.remove()


@torch.inference_mode()
def forward_shapes(pred: Predictor, batch: int) -> tuple[dict, list]:
    """One forward at ``batch``: the counts, and every kernel call's
    arguments in order."""
    model = pred.detector.model
    h, w = pred.cfg.image_hw()
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (batch, h, w, 3), dtype=np.uint8)).to(pred.device)
    model(images)  # weights prepared here
    torch.cuda.synchronize(pred.device)
    calls = []
    kernel = conv_s8_cuda.conv_s8_cuda

    def recording(*args, **kwargs):
        calls.append((args, kwargs))
        return kernel(*args, **kwargs)

    conv_s8_cuda.launches = conv_s8_cuda.preparations = 0
    conv_s8_cuda.conv_s8_cuda = recording
    try:
        with _IntMMCount() as mode, conv_calls(model) as convs:
            model(images)
        torch.cuda.synchronize(pred.device)
    finally:
        conv_s8_cuda.conv_s8_cuda = kernel
    counts = {"phase": "conv_forward", "batch": batch,
              "launches": conv_s8_cuda.launches,
              "int8_dense_convs": convs[0],
              "int_mm_calls": mode.int_mm,
              "preparations_after_first_batch": conv_s8_cuda.preparations}
    if counts["launches"] != convs[0] or mode.int_mm or \
            conv_s8_cuda.preparations:
        raise AssertionError(f"the int8 forward left K4's path: {counts}")
    return counts, calls


def _signature(args: tuple, kwargs: dict) -> tuple:
    x, w, geometry, k_scale, bias, a_scale, reciprocal = (
        list(args) + [None] * 7)[:7]
    bias = kwargs.get("bias", bias)
    reciprocal = kwargs.get("reciprocal", reciprocal)
    return (tuple(x.shape), tuple(x.stride()), str(x.dtype).split(".")[-1],
            tuple(geometry), bias is not None, reciprocal is not None)


def shape_inputs(sig: tuple, device) -> dict:
    """Seeded tensors of one recorded call's shape, strides and kind."""
    shape, stride, dtype, geometry, has_bias, has_recip = sig
    g = dict(zip(conv_s8_cuda.GEOMETRY, geometry))
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.empty_strided(shape, stride, device=device,
                            dtype=getattr(torch, dtype))
    if x.dtype == torch.int8:
        x.copy_(torch.randint(-127, 128, shape, generator=gen,
                              device=device, dtype=torch.int8))
    else:
        x.copy_(torch.randn(shape, generator=gen, device=device))
    weight = torch.randn((g["out_ch"], g["in_ch"], g["kh"], g["kw"]),
                         generator=gen, device=device) * 0.05
    k_q, k_scale = layers.quantize_weight(weight)
    args = {"x": x, "w": conv_s8_cuda.pack_weight(k_q),
            "geometry": list(geometry), "k_scale": None, "bias": None,
            "a_scale": None, "reciprocal": None}
    if x.dtype != torch.int8:
        args["k_scale"] = k_scale
        args["a_scale"] = torch.tensor(0.05, device=device)
        if has_recip:
            args["reciprocal"] = torch.tensor(20.0, device=device)
        if has_bias:
            args["bias"] = torch.randn(g["out_ch"], generator=gen,
                                       device=device)
    return args


@torch.inference_mode()
def time_shape(sig: tuple, count: int, device, iters: int) -> dict:
    """One recorded call's shape on seeded inputs: K4 held bit-equal to the
    plain version, then K4, the plain version and ``torch._int_mm`` on the
    im2col timed, beside the bound."""
    args = shape_inputs(sig, device)
    equal_to_plain(args, f"{list(sig[0])} {list(sig[3])}")
    x, g = args["x"], dict(zip(conv_s8_cuda.GEOMETRY, sig[3]))
    m = x.shape[0] * g["out_h"] * g["out_w"]
    k = g["kh"] * g["kw"] * g["in_ch"]
    n = g["out_ch"]
    out_bytes = 4 if x.dtype == torch.int8 else 2
    nbytes = x.numel() * x.element_size() + n * k + m * n * out_bytes
    t_ops = 2 * m * k * n / INT8_TENSOR_OP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    k4 = kernel_ms(lambda: conv_s8_cuda.conv_s8_cuda(**args))
    plain_ms = cuda_ms(lambda: layers.conv_s8_plain(**args),
                       max(iters // 4, 2))
    # the library yardstick: torch._int_mm alone on the im2col, padded to
    # its limits (M > 16, K and N multiples of 8) beforehand
    if x.dtype == torch.int8:
        x_q = x.permute(0, 2, 3, 1)
    else:
        x_q = layers.quantize_activation(x, args["a_scale"],
                                         args["reciprocal"])
    cols = layers.im2col_padded(
        x_q, g["kh"], g["kw"], g["stride"],
        (g["pad_top"], g["pad_bottom"], g["pad_left"], g["pad_right"]),
        (g["out_h"], g["out_w"])).reshape(m, k)
    w2d = conv_s8_cuda.unpack_weight(args["w"], n, g["in_ch"], g["kh"],
                                     g["kw"])
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    a = torch.nn.functional.pad(cols, (0, kp - k, 0, max(m, 17) - m))
    b = torch.nn.functional.pad(w2d, (0, kp - k, 0, np_ - n)).t()
    int_mm_ms = cuda_ms(lambda: torch._int_mm(a, b), iters)
    del cols, a
    return {"phase": "conv_shape", "x": list(sig[0]), "dtype": sig[2],
            "channels_last": x.is_contiguous(
                memory_format=torch.channels_last),
            "kernel": g["kh"], "stride": g["stride"], "M": m, "K": k,
            "N": n, "count": count, "bit_equal": True, **k4,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "roofline_share": max(t_ops, t_bytes) / k4["ms"],
            "plain_ms": plain_ms, "library_ms": int_mm_ms,
            "library": "torch._int_mm on the im2col"}


def host_cost(sig: tuple, device, calls: int = 200) -> dict:
    """Host microseconds a call of the operator and of the wrapper alone
    (small shape: the card keeps up with the launches)."""
    args = shape_inputs(sig, device)
    out = {"phase": "conv_host", "x": list(sig[0])}
    with torch.inference_mode():
        for name, fn in (("op_us", conv_s8_cuda.conv_s8),
                         ("wrapper_us", conv_s8_cuda.conv_s8_cuda)):
            for _ in range(10):
                fn(**args)
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(**args)
            out[name] = (time.perf_counter() - t0) / calls * 1e6
            torch.cuda.synchronize(device)
    return out


def _plain_on_card(x, w, geometry, k_scale=None, bias=None, a_scale=None,
                   reciprocal=None, lib=None):
    """``conv_s8_cuda.conv_s8_cuda``'s arguments through the plain
    composition, on the card."""
    conv_s8_cuda.check_args(x, w, geometry, k_scale, bias, a_scale,
                            reciprocal)
    return layers.conv_s8_plain(x, w, geometry, k_scale, bias, a_scale,
                                reciprocal)


@torch.inference_mode()
def model_equal(config: str, device, batch: int = 2) -> dict:
    """``config``'s int8 forward (``int8_neck``, seeded, calibrated) on a
    seeded uint8 batch, with K4 and with the plain composition in its
    place: raises unless every raw map is equal bit for bit."""
    pred = int8_predictor(config, device)
    h, w = pred.cfg.image_hw()
    images = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (batch, h, w, 3), dtype=np.uint8)).to(device)
    model = pred.detector.model
    conv_s8_cuda.launches = 0
    got = model(images)
    launches = conv_s8_cuda.launches
    kernel = conv_s8_cuda.conv_s8_cuda
    conv_s8_cuda.conv_s8_cuda = _plain_on_card
    try:
        want = model(images)
    finally:
        conv_s8_cuda.conv_s8_cuda = kernel
    pairs = [(a, b) for la, lb in zip(got, want) for a, b in zip(la, lb)]
    equal = all(torch.equal(a, b) for a, b in pairs)
    row = {"phase": "conv_model", "config": os.path.basename(config),
           "batch": batch, "image_hw": [h, w], "launches": launches,
           "maps": len(pairs), "bit_equal": equal}
    if not equal or launches == 0:
        raise AssertionError(f"K4 and the plain composition differ: {row}")
    return row


MODEL_CONFIGS = ("coco_mobilenet_640_flagship.json", "coco_mobilenet_640.json",
                 "coco_retinanet_resnet50_640.json",
                 "coco_mobilenet_v2_640.json",
                 "coco_efficientnet_lite0_640.json",
                 "coco_shufflenet_512.json", "streaming_1024.json")


def main(argv=None, emit=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default=FLAGSHIP)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--cases-only", action="store_true")
    p.add_argument("--models", action="store_true",
                   help="also --config's forward at --batch and each "
                        "shipped config's at 2 against the plain "
                        "composition (MODEL_CONFIGS)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_conv_s8 runs on the card")
    device = torch.device("cuda")
    emit = emit or (lambda row: print(json.dumps(row), flush=True))
    for case in kernel_cases.conv_cases():
        emit({"phase": "conv_case", **check_case(case, device)})
    if args.cases_only:
        return {}
    pred = int8_predictor(args.config, device)
    counts, calls = forward_shapes(pred, args.batch)
    emit(counts)
    seen = collections.Counter(_signature(a, k) for a, k in calls)
    total_ms, bound_ms = 0.0, 0.0
    rows = []
    for sig, count in seen.items():
        row = time_shape(sig, count, device, args.iters)
        emit(row)
        rows.append(row)
        total_ms += row["ms"] * count
        bound_ms += row["bound_ms"] * count
    smallest = min(seen, key=lambda s: int(np.prod(s[0])))
    emit(host_cost(smallest, device))
    summary = {"phase": "conv_summary", "launches": counts["launches"],
               "distinct_shapes": len(seen), "forward_k4_ms": total_ms,
               "forward_bound_ms": bound_ms,
               "device": torch.cuda.get_device_name(device)}
    emit(summary)
    models = []
    if args.models:
        models.append(model_equal(args.config, device, args.batch))
        emit(models[-1])
        for name in MODEL_CONFIGS:
            models.append(model_equal(os.path.join(ROOT, "configs", name),
                                      device))
            emit(models[-1])
    return {"counts": counts, "shapes": rows, "summary": summary,
            "models": models}


if __name__ == "__main__":
    main(sys.argv[1:])
