"""The reference's parameters by name and shape, from a config alone: the
published layer tables, under the port's state-dict names."""

from __future__ import annotations

from bench_port.reference.model import (MOBILENET_STEM, MOBILENET_TABLE,
                                        RESNET_STAGES)


def _conv_bn(out: dict, name: str, cin: int, cout: int, k: int,
             groups: int = 1) -> None:
    out[name + ".conv.weight"] = (cout, cin // groups, k, k)
    for p in ("weight", "bias", "running_mean", "running_var"):
        out[f"{name}.bn.{p}"] = (cout,)


def param_shapes(cfg: dict) -> dict:
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
