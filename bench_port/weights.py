"""Seeded weights, made on the device in a few large draws.

One state dict feeds the program and the reference alike. Conv kernels are
normal with std ``sqrt(2 / fan_in)`` (He's, so that ReLU stacks neither
vanish nor blow up at random init) and the prediction convs ``1 /
sqrt(fan_in)``, so that logits spread around their bias (or a fixed
``predict_std``);
conv biases are 0 but the class head's, which is ``class_bias``; batch
norms get scales and shifts near identity and running statistics near
(0, 1), so that eval-mode norms do some work; a parameter that a
reference's ``seed_means`` names (one neither a kernel nor a norm vector,
such as a fusion weight) is its source's starting value plus ``0.1 N(0,
1)``. All kernels come from one normal draw, all norm vectors from a
second and the named parameters from a third, on ``device``, from a
generator seeded with ``seed``: a state that names none is the two draws'
alone.

Where the configuration keeps an EMA of the parameters, it starts apart
from them (``ema_start``), as an EMA carried over from earlier training
does: each step then moves it by ``(1 - decay) (p - e)``, hundreds of
float32 steps of ``e``, and not by the rounding of its formula alone.
"""

from __future__ import annotations

import math

import torch

CLASS_BIAS_KEY = "head.class_net.predict.bias"
EMA_SALT = 0x454D41 << 32  # the EMA's generator: ``seed`` with these bits
STATISTICS = ("running_mean", "running_var")


def reference_state(reference, cfg: dict, seed: int, device: torch.device,
                    class_bias: float, predict_std: float | None = None
                    ) -> dict:
    """The seeded state of ``cfg`` under its reference module
    (``reference.for_config``): its ``param_shapes``, and the starting
    values of its optional ``seed_means``."""
    means = getattr(reference, "seed_means", None)
    return seeded_state(reference.param_shapes(cfg), seed, device,
                        class_bias, predict_std,
                        means(cfg) if means else None)


def seeded_state(shapes: dict, seed: int, device: torch.device,
                 class_bias: float, predict_std: float | None = None,
                 means: dict | None = None) -> dict:
    """``shapes``: state-dict name -> shape (the program's ``state_dict``
    names). ``predict_std``: the prediction convs' std where it is fixed
    (RetinaNet's 0.01 for training from scratch). ``means``: state-dict
    name -> the value a parameter that is neither a 4-d kernel nor a norm
    vector starts from. Returns f32 tensors on ``device``."""
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
    means = means or {}
    bad = [k for k in means if k not in shapes or k in out]
    if bad:
        raise ValueError("seed_means names what is no parameter, or a "
                         f"kernel or a norm vector: {bad}")
    named = {k: s for k, s in shapes.items() if k in means}
    if named:
        total = sum(math.prod(s) for s in named.values())
        flat = torch.randn(total, generator=gen, device=device) * 0.1
        off = 0
        for k, s in named.items():
            n = math.prod(s)
            out[k] = flat[off:off + n].view(s) + float(means[k])
            off += n
    for k, s in shapes.items():
        if k not in out:  # conv biases
            out[k] = torch.full(s, class_bias if k == CLASS_BIAS_KEY
                                else 0.0, device=device)
    return out


def ema_start(params: dict, seed: int, device: torch.device) -> dict:
    """Where the EMA of ``params`` (state-dict name -> tensor, the running
    statistics aside) starts: each parameter plus ``0.1 max(rms, 0.01)
    N(0, 1)``, its rms read on the host, in one normal draw on ``device``
    from a generator of its own seeded from ``seed``. The same ``params``
    and ``seed`` give the same bits, so that the program's EMA and the
    reference's start alike. Returns f32 tensors on ``device``."""
    keys = [k for k in params if not k.endswith(STATISTICS)]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) ^ EMA_SALT)
    flat = torch.randn(sum(params[k].numel() for k in keys), generator=gen,
                       device=device)
    out, off = {}, 0
    for k in keys:
        p = params[k].detach().float()
        rms = float(p.cpu().square().mean().sqrt())
        n = p.numel()
        out[k] = (p.to(device) + flat[off:off + n].view(p.shape)
                  * (0.1 * max(rms, 0.01)))
        off += n
    return out
