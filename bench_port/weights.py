"""Seeded weights, made on the device in a few large draws.

One state dict feeds the program and the reference alike. Conv kernels are
normal with std ``sqrt(2 / fan_in)`` (He's, so that ReLU stacks neither
vanish nor blow up at random init) and the prediction convs ``1 /
sqrt(fan_in)``, so that logits spread around their bias (or a fixed
``predict_std``);
conv biases are 0 but the class head's, which is ``class_bias``; batch
norms get scales and shifts near identity and running statistics near
(0, 1), so that eval-mode norms do some work. All kernels come from one
normal draw and all norm vectors from another, on ``device``, from a
generator seeded with ``seed``.
"""

from __future__ import annotations

import math

import torch

CLASS_BIAS_KEY = "head.class_net.predict.bias"


def seeded_state(shapes: dict, seed: int, device: torch.device,
                 class_bias: float, predict_std: float | None = None
                 ) -> dict:
    """``shapes``: state-dict name -> shape (the program's ``state_dict``
    names). ``predict_std``: the prediction convs' std where it is fixed
    (RetinaNet's 0.01 for training from scratch). Returns f32 tensors on
    ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    kernels = {k: s for k, s in shapes.items() if len(s) == 4}
    norms = {k: s for k, s in shapes.items() if ".bn." in k}
    out = {}
    total = sum(math.prod(s) for s in kernels.values())
    flat = torch.randn(total, generator=gen, device=device)
    off = 0
    for k, s in kernels.items():
        n = math.prod(s)
        fan_in = math.prod(s[1:])
        if not k.endswith(".predict.weight"):
            std = math.sqrt(2.0 / fan_in)
        else:
            std = predict_std or 1.0 / math.sqrt(fan_in)
        out[k] = flat[off:off + n].view(s) * std
        off += n
    total = sum(math.prod(s) for s in norms.values())
    flat = torch.randn(total, generator=gen, device=device) * 0.1
    off = 0
    for k, s in norms.items():
        n = math.prod(s)
        v = flat[off:off + n].view(s)
        off += n
        if k.endswith(".weight"):
            v = 1.0 + v
        elif k.endswith(".running_var"):
            v = 1.0 + v.abs()
        out[k] = v
    for k, s in shapes.items():
        if k not in out:  # conv biases
            out[k] = torch.full(s, class_bias if k == CLASS_BIAS_KEY
                                else 0.0, device=device)
    return out
