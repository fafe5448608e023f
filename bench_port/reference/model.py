"""Plain reference of the two benchmarked detectors, in float32.

A frozen, functional copy of what ``ssd_tpu_torch`` computes, written from
the published architectures and the port's plain code, importing nothing
of the port: MobileNet-v1 as published (a 3x3 conv to 32 channels at
stride 2 on the normalized image, then ds1-ds13), or ResNet-50 v1.5; an FPN P3-P7 (1x1 laterals, nearest 2x top-down adds, 3x3
smoothing, P6 a stride-2 conv on C5, P7 one on ReLU(P6)); RetinaNet's shared
class and box subnets. Layout NCHW; SAME padding split as XLA splits it
(``same_pad``); batch norm in flax's order with its fast variance.

Departures from the port, each deliberate:

* everything runs in float32 with TF32 off (the port computes in bf16,
  and rounds the normalized image to bf16 before either stem);
* ``Quant`` emulates integer convolution: activations per tensor, weights
  per output channel, symmetric, ``bits`` wide; the integer products are
  summed in float64, which is exact for these sizes. At 8 bits with the
  scales calibrated on the same batch it is the port's int8 scheme; at 4
  bits it is the control below it.

Parameters are a dict of tensors under the port's state-dict names, so the
one seeded state dict feeds both.

This is the default reference of a configuration (``reference/__init__.py``):
it exports ``Model``, ``param_shapes`` and ``wgrad_excess``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench_port.reference.collective import all_reduce_sum

MEAN_RGB = (0.485 * 255.0, 0.456 * 255.0, 0.406 * 255.0)
STD_RGB = (0.229 * 255.0, 0.224 * 255.0, 0.225 * 255.0)
BN_EPS = 1e-3
MOBILENET_STEM = 32  # the stem conv's channels, at stride 2
MOBILENET_TABLE = [("ds1", 64, 1), ("ds2", 128, 2), ("ds3", 128, 1),
                   ("ds4", 256, 2), ("ds5", 256, 1), ("ds6", 512, 2)] + [
    (f"ds{7 + i}", 512, 1) for i in range(5)] + [
    ("ds12", 1024, 2), ("ds13", 1024, 1)]
RESNET_STAGES = (("s1", 64, 3, 1), ("s2", 128, 4, 2), ("s3", 256, 6, 2),
                 ("s4", 512, 3, 2))


def precise() -> None:
    """Full float32 in every conv and matrix product on the card."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def same_pad(size: int, kernel: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Quant:
    """Fake-quantized dense convs. ``bits``: 8 (the port's int8) or 4 (the
    control). ``calibrate()`` switches to recording ``max|x|`` of each
    conv's input, keyed by conv and input size (the shared head convs hold
    one a pyramid level); ``dynamic`` takes each call's own ``max|x|``
    instead (training's control). ``ste``: the rounding passes gradients
    straight through."""

    def __init__(self, bits: int = 8, dynamic: bool = False,
                 ste: bool = False):
        self.qmax = float(2 ** (bits - 1) - 1)
        self.dynamic = dynamic
        self.ste = ste
        self.absmax: dict = {}
        self.recording = False

    def _round(self, x: torch.Tensor) -> torch.Tensor:
        q = torch.clamp(torch.round(x), -self.qmax, self.qmax)
        return x + (q - x).detach() if self.ste else q

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """Per output channel: ``(w_q, scale (O,))``."""
        scale = torch.clamp_min(w.detach().abs().amax(dim=(1, 2, 3))
                                / self.qmax, 1e-8)
        return self._round(w / scale.view(-1, 1, 1, 1)), scale

    def conv(self, key: str, x: torch.Tensor, w: torch.Tensor,
             stride: int, padding) -> torch.Tensor | None:
        """The quantized conv without bias, or ``None`` while recording
        (the caller then runs the float conv)."""
        k = (key, x.shape[-2], x.shape[-1])
        if self.recording:
            m = x.detach().abs().amax().float()
            self.absmax[k] = torch.maximum(self.absmax[k], m) \
                if k in self.absmax else m
            return None
        m = x.detach().abs().amax().float() if self.dynamic \
            else self.absmax[k]
        a_scale = torch.clamp_min(m / self.qmax, 1e-8)
        x_q = self._round(x / a_scale)
        w_q, w_scale = self.weight(w)
        if self.ste:  # float arithmetic, differentiable
            y = F.conv2d(x_q, w_q, None, stride, padding)
        else:
            y = F.conv2d(x_q.double(), w_q.double(), None, stride,
                         padding).float()
        return y * (a_scale * w_scale).view(1, -1, 1, 1)


class Model:
    """The reference network over a params dict. ``cfg``: the repo
    config as a dict. ``quant``: a ``Quant`` for the dense convs, or
    ``None`` for float32. ``group``: in training, the process group over
    whose ranks (each its own rows, as many each) batch norm takes its
    two means, so that they are the global batch's; ``None``: this
    process's rows alone."""

    def __init__(self, cfg: dict, params: dict, quant: Quant | None = None):
        self.cfg = cfg
        self.p = params
        self.quant = quant
        self.training = False
        self.group = None
        self.backbone = cfg["model"]["backbone"]
        if self.backbone not in ("mobilenet", "resnet50"):
            raise ValueError(f"no reference for {self.backbone}")
        if self.backbone == "mobilenet" and (
                cfg["model"].get("stem_schedule") != "reference"
                or cfg["model"].get("stem_space_to_depth")):
            raise ValueError("the reference MobileNet-v1 has the published "
                             "stem (stem_schedule 'reference')")

    # ------------------------------------------------------------ layers

    def conv(self, name: str, x: torch.Tensor, stride: int = 1,
             groups: int = 1, quant: bool = True) -> torch.Tensor:
        w = self.p[name + ".weight"]
        b = self.p.get(name + ".bias")
        k = w.shape[-1]
        ph = same_pad(x.shape[-2], k, stride)
        pw = same_pad(x.shape[-1], k, stride)
        if ph[0] != ph[1] or pw[0] != pw[1]:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            padding = 0
        else:
            padding = (ph[0], pw[0])
        y = None
        if self.quant is not None and quant and groups == 1:
            y = self.quant.conv(name, x, w, stride, padding)
        if y is None:
            y = F.conv2d(x, w, None, stride, padding, 1, groups)
        return y if b is None else y + b.view(1, -1, 1, 1)

    def bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w, b = self.p[name + ".weight"], self.p[name + ".bias"]
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            mean_sq = x.square().mean(dim=(0, 2, 3))
            if self.group is not None:
                both = all_reduce_sum(torch.stack([mean, mean_sq]),
                                      self.group)
                mean, mean_sq = (both / torch.distributed.get_world_size(
                    self.group)).unbind(0)
            var = torch.clamp_min(mean_sq - mean.square(), 0.0)
        else:
            mean = self.p[name + ".running_mean"]
            var = self.p[name + ".running_var"]
        mul = torch.rsqrt(var + BN_EPS) * w
        return (x - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) \
            + b.view(1, -1, 1, 1)

    def conv_bn(self, name: str, x: torch.Tensor, stride: int = 1,
                groups: int = 1, act: str | None = "relu6") -> torch.Tensor:
        y = self.bn(name + ".bn", self.conv(name + ".conv", x, stride,
                                            groups))
        if act == "relu6":
            return F.relu6(y)
        return F.relu(y) if act == "relu" else y

    # ---------------------------------------------------------- backbones

    def normalized(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC -> the normalized image, NCHW float32."""
        mean = images.new_tensor(MEAN_RGB, dtype=torch.float32)
        std = images.new_tensor(STD_RGB, dtype=torch.float32)
        return ((images.float() - mean) / std).permute(0, 3, 1, 2)

    def mobilenet(self, images: torch.Tensor) -> dict:
        x = self.conv_bn("backbone.stem", self.normalized(images), 2)
        taps = {}
        for name, _, stride in MOBILENET_TABLE:
            x = self.conv_bn(f"backbone.{name}.depthwise", x, stride,
                             groups=x.shape[1])
            x = self.conv_bn(f"backbone.{name}.pointwise", x)
            if name in ("ds5", "ds11", "ds13"):
                taps[{"ds5": "c3", "ds11": "c4", "ds13": "c5"}[name]] = x
        return taps

    def resnet_stem(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC -> normalized, the 7x7/2 conv, norm, ReLU and the
        SAME 3x3/2 max-pool (padded with -inf)."""
        x = self.conv_bn("backbone.stem", self.normalized(images), 2,
                         act="relu")
        ph, pw = same_pad(x.shape[-2], 3, 2), same_pad(x.shape[-1], 3, 2)
        return F.max_pool2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1]),
                                  value=-math.inf), 3, 2)

    def resnet(self, images: torch.Tensor, run=None) -> dict:
        """``run(fn, *args)``: how each block is called (an activation
        checkpoint in training's reference); by default directly."""
        run = run or (lambda fn, *a: fn(*a))
        x = run(self.resnet_stem, images)
        taps = {}
        for (prefix, _, blocks, stride), tap in zip(
                RESNET_STAGES, (None, "c3", "c4", "c5")):
            for i in range(blocks):
                x = run(self.bottleneck, f"backbone.{prefix}_b{i}", x,
                        stride if i == 0 else 1)
            if tap:
                taps[tap] = x
        return taps

    def bottleneck(self, name: str, x: torch.Tensor,
                   stride: int) -> torch.Tensor:
        res = (self.conv_bn(name + ".proj", x, stride, act=None)
               if name + ".proj.conv.weight" in self.p else x)
        y = self.conv_bn(name + ".conv1", x, act="relu")
        y = self.conv_bn(name + ".conv2", y, stride, act="relu")
        y = self.conv_bn(name + ".conv3", y, act=None)
        return F.relu(y + res)

    # -------------------------------------------------------- FPN, heads

    def fpn(self, feats: dict) -> list:
        c3, c4, c5 = feats["c3"], feats["c4"], feats["c5"]

        def up(x, like):
            return F.interpolate(x, size=like.shape[-2:], mode="nearest-exact")

        p5 = self.conv("fpn.lateral5.conv", c5)
        p4 = self.conv("fpn.lateral4.conv", c4) + up(p5, c4)
        p3 = self.conv("fpn.lateral3.conv", c3) + up(p4, c3)
        p3 = self.conv("fpn.smooth3.conv", p3)
        p4 = self.conv("fpn.smooth4.conv", p4)
        p5 = self.conv("fpn.smooth5.conv", p5)
        p6 = self.conv("fpn.p6.conv", c5, 2)
        p7 = self.conv("fpn.p7.conv", F.relu(p6), 2)
        return [p3, p4, p5, p6, p7]

    def subnet(self, name: str, x: torch.Tensor) -> torch.Tensor:
        depth = self.cfg["model"]["head_depth"]
        for i in range(depth):
            x = F.relu(self.conv(f"head.{name}.conv{i}", x))
        return self.conv(f"head.{name}.predict", x)

    def level(self, p: torch.Tensor) -> tuple:
        """One pyramid level -> ``(cls (N, H, W, K*C), box (N, H, W,
        K*4))``."""
        return (self.subnet("class_net", p).permute(0, 2, 3, 1),
                self.subnet("box_net", p).permute(0, 2, 3, 1))

    def features(self, images: torch.Tensor, run=None) -> dict:
        """The backbone's taps ``c3``-``c5``. ``run(fn, *args)``: how each
        ResNet block is called (an activation checkpoint in training's
        reference); MobileNet-v1's layers are called directly."""
        if self.backbone == "mobilenet":
            return self.mobilenet(images)
        return self.resnet(images, run)

    def pyramid(self, images: torch.Tensor) -> list:
        return self.fpn(self.features(images))

    def __call__(self, images: torch.Tensor) -> list:
        """uint8 NHWC images -> the per-level raw maps."""
        return [self.level(p) for p in self.pyramid(images)]

    def calibrate(self, images: torch.Tensor) -> None:
        """Records every quantized conv's input range on ``images`` (the
        port's absmax calibration, its conv run in float32 here)."""
        self.quant.recording = True
        try:
            with torch.no_grad():
                self(images)
        finally:
            self.quant.recording = False


def flatten_levels(raw: list, num_classes: int):
    """Per-level maps -> ``(logits (N, A, C), deltas (N, A, 4))`` in
    (level, row, col, anchor) order."""
    n = raw[0][0].shape[0]
    return (torch.cat([c.reshape(n, -1, num_classes) for c, _ in raw], 1),
            torch.cat([b.reshape(n, -1, 4) for _, b in raw], 1))


def _conv_bn(out: dict, name: str, cin: int, cout: int, k: int,
             groups: int = 1) -> None:
    out[name + ".conv.weight"] = (cout, cin // groups, k, k)
    for p in ("weight", "bias", "running_mean", "running_var"):
        out[f"{name}.bn.{p}"] = (cout,)


def param_shapes(cfg: dict) -> dict:
    """The reference's parameters by state-dict name and shape, from a
    config alone: the published layer tables, under the port's names."""
    m = cfg["model"]
    if m.get("width_multiplier", 1.0) != 1.0:
        raise ValueError("the reference holds the published widths")
    out: dict = {}
    if m["backbone"] == "mobilenet":
        _conv_bn(out, "backbone.stem", 3, MOBILENET_STEM, 3)
        cin = MOBILENET_STEM
        for name, ch, _ in MOBILENET_TABLE:
            _conv_bn(out, f"backbone.{name}.depthwise", cin, cin, 3, cin)
            _conv_bn(out, f"backbone.{name}.pointwise", cin, ch, 1)
            cin = ch
        taps = (256, 512, 1024)
    else:
        _conv_bn(out, "backbone.stem", 3, 64, 7)
        cin = 64
        for prefix, width, blocks, stride in RESNET_STAGES:
            for i in range(blocks):
                name = f"backbone.{prefix}_b{i}"
                if cin != 4 * width or (stride != 1 and i == 0):
                    _conv_bn(out, name + ".proj", cin, 4 * width, 1)
                _conv_bn(out, name + ".conv1", cin, width, 1)
                _conv_bn(out, name + ".conv2", width, width, 3)
                _conv_bn(out, name + ".conv3", width, 4 * width, 1)
                cin = 4 * width
        taps = (512, 1024, 2048)
    f = m["fpn_channels"]
    for lvl, c in zip((3, 4, 5), taps):
        out[f"fpn.lateral{lvl}.conv.weight"] = (f, c, 1, 1)
        out[f"fpn.lateral{lvl}.conv.bias"] = (f,)
    for lvl in (3, 4, 5):
        out[f"fpn.smooth{lvl}.conv.weight"] = (f, f, 3, 3)
        out[f"fpn.smooth{lvl}.conv.bias"] = (f,)
    out["fpn.p6.conv.weight"] = (f, taps[2], 3, 3)
    out["fpn.p6.conv.bias"] = (f,)
    out["fpn.p7.conv.weight"] = (f, f, 3, 3)
    out["fpn.p7.conv.bias"] = (f,)
    a = cfg["anchors"]
    k = a["scales_per_octave"] * len(a["aspect_ratios"])
    h = m.get("head_channels") or f
    fk = m.get("head_final_kernel", 3)
    for net, outs in (("class_net", k * cfg["num_classes"]),
                      ("box_net", k * 4)):
        cin = f
        for i in range(m["head_depth"]):
            out[f"head.{net}.conv{i}.weight"] = (h, cin, 3, 3)
            out[f"head.{net}.conv{i}.bias"] = (h,)
            cin = h
        out[f"head.{net}.predict.weight"] = (outs, cin, fk, fk)
        out[f"head.{net}.predict.bias"] = (outs,)
    return out


def wgrad_excess(params: dict, cfg: dict, batch: int) -> int:
    """What ``FlopCounterMode`` over-counts in the depthwise weight
    gradients of a MobileNet-v1 step (its formula ignores ``groups``):
    ``(groups - 1) / groups`` of its count; 0 for ResNet-50, which has no
    grouped conv."""
    if cfg["model"]["backbone"] != "mobilenet":
        return 0
    size = cfg["image_size"] // 2  # the stem's stride
    excess = 0
    for name, _, stride in MOBILENET_TABLE:
        w = params[f"backbone.{name}.depthwise.conv.weight"]
        c = w.shape[0]
        out = -(-size // stride)
        # counted 2 N Ho Wo C (C 9), right 2 N Ho Wo C 9
        excess += 2 * batch * out * out * c * 9 * (c - 1)
        size = out
    return excess
