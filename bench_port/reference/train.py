"""Plain reference of one RetinaNet training step, in float32.

A frozen copy of the port's plain training arithmetic that imports
nothing of the port: IoU-argmax matching (positive at >= 0.5, ignored in
[0.4, 0.5), each gt forced onto its best anchor, the later gt winning a
shared one), box targets encoded against the anchors, the sigmoid focal
loss and the smooth-L1 (or GIoU) box loss summed over the levels and
divided by the positives, the L2 term ``0.5 wd sum w^2`` over kernels,
clipping by the global norm, and momentum SGD in optax's Nesterov form
(``t = g + mu t``, step ``g + mu t``) under the linear warm-up and cosine
schedule, whose first update has learning rate 0, and where the
configuration's ``train.ema_decay`` is above 0 the EMA of the parameters
after each update, by the port's formula in float32 (``e = e d + p (1 -
d)``, ``d`` and ``1 - d`` rounded to float32), from the start it is
given.

The backbone's blocks and each pyramid level's subnets and loss run under
activation checkpoints, which recompute the same float32 arithmetic: at
b64/640 the plain step would not fit the card otherwise.

Data-parallel (``group``): each rank follows the step on its own rows of
the global batch, with batch norm's two means and the positive count
summed over the ranks (``collective.all_reduce_sum``), so that they are
the global batch's; each rank's loss is then its rows' share, and the
gradients and the loss are summed over the ranks before the L2 term, the
clip and the update, which every rank applies alike: the one-process step
at the global batch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from bench_port.reference import detect
from bench_port.reference import model as default_reference

NEGATIVE, IGNORE = -1, -2


def match(anc: torch.Tensor, gt: torch.Tensor, num: torch.Tensor,
          matcher: dict, chunk: int = 8) -> torch.Tensor:
    """``(N, A)`` matches: gt index, -1 negative, -2 ignored."""
    out = []
    for lo in range(0, gt.shape[0], chunk):
        g, nb = gt[lo:lo + chunk], num[lo:lo + chunk]
        m = g.shape[1]
        ious = detect.iou(anc[None], g)  # (n, A, M)
        valid = torch.arange(m, device=g.device)[None, None] < nb[:, None,
                                                                   None]
        ious = torch.where(valid, ious, ious.new_full((), -1.0))
        best_gt = ious.argmax(-1)
        best_iou = ious.gather(-1, best_gt[..., None])[..., 0]
        best_anchor = ious.argmax(1)  # (n, M)
        del ious
        mt = torch.where(best_iou >= matcher["matching_threshold"], best_gt,
                         best_gt.new_full((), NEGATIVE))
        band = ((best_iou >= matcher["negative_threshold"])
                & (best_iou < matcher["matching_threshold"]))
        mt = torch.where(band, mt.new_full((), IGNORE), mt)
        if matcher["force_match_for_each_gt"]:
            n, a = mt.shape
            gv = torch.arange(m, device=g.device)[None] < nb[:, None]
            idx = torch.where(gv, best_anchor, torch.full_like(best_anchor,
                                                               a))
            forced = torch.full((n, a + 1), NEGATIVE, dtype=torch.long,
                                device=g.device)
            forced.scatter_reduce_(1, idx, torch.arange(
                m, device=g.device).expand(n, m), reduce="amax")
            forced = forced[:, :a]
            mt = torch.where(forced >= 0, forced, mt)
        out.append(mt)
    return torch.cat(out)


def targets(anc: torch.Tensor, batch: dict, matcher: dict) -> dict:
    gt = batch["boxes"].float()
    mt = match(anc, gt, batch["num_boxes"].long(), matcher)
    pos = mt >= 0
    idx = mt.clamp_min(0)
    boxes = torch.gather(gt, 1, idx[..., None].expand(*idx.shape, 4))
    reg = torch.where(pos[..., None], detect.encode(boxes, anc[None]), 0.0)
    labels = torch.gather(batch["labels"].long(), 1, idx)
    return {"reg": reg, "labels": torch.where(pos, labels, -1),
            "cls_w": (mt != IGNORE).float(), "reg_w": pos.float()}


def focal(logits: torch.Tensor, t: torch.Tensor, alpha: float,
          gamma: float) -> torch.Tensor:
    bce = (torch.clamp_min(logits, 0.0) - logits * t
           + torch.log1p(torch.exp(-logits.abs())))
    p = torch.sigmoid(logits)
    p_t = p * t + (1 - p) * (1 - t)
    a_t = alpha * t + (1 - alpha) * (1 - t)
    return a_t * (1 - p_t) ** gamma * bce


def box_loss(deltas, reg, anc, losses: dict) -> torch.Tensor:
    """Per-anchor box loss ``(N, A)``."""
    kind = losses.get("box_loss", "smooth_l1")
    if kind == "smooth_l1":
        d = (deltas - reg).abs()
        delta = losses["smooth_l1_delta"]
        return torch.where(d < delta, 0.5 * d * d / delta,
                           d - 0.5 * delta).sum(-1)
    if kind != "giou":
        raise ValueError(f"no reference for box_loss {kind!r}")
    p = detect.decode(deltas, anc, clip=False)
    t = detect.decode(reg, anc, clip=False)
    ih = (torch.minimum(p[..., 2], t[..., 2])
          - torch.maximum(p[..., 0], t[..., 0])).clamp_min(0)
    iw = (torch.minimum(p[..., 3], t[..., 3])
          - torch.maximum(p[..., 1], t[..., 1])).clamp_min(0)
    inter = ih * iw
    union = detect.area(p) + detect.area(t) - inter
    eh = torch.maximum(p[..., 2], t[..., 2]) - torch.minimum(p[..., 0],
                                                             t[..., 0])
    ew = torch.maximum(p[..., 3], t[..., 3]) - torch.minimum(p[..., 1],
                                                             t[..., 1])
    c = (eh * ew).clamp_min(1e-8)
    return 1 - inter / union.clamp_min(1e-8) + (c - union) / c


def lr_at(count: int, t: dict) -> float:
    """optax's warm-up then cosine, evaluated in float32."""
    f = np.float32
    lr, ws = f(t["learning_rate"]), t["warmup_steps"]
    if count < ws:
        return float(-lr * (f(1) - f(count) / f(ws)) + lr)
    if t["lr_schedule"] != "cosine":
        raise ValueError("the reference follows the cosine schedule")
    decay = f(max(t["num_steps"] - ws, 1))
    c = min(f(count - ws), decay)
    return float(lr * (f(0.5) * (f(1) + np.cos(f(np.pi) * c / decay))))


class Trainer:
    """Follows the port's step from the same parameters on the same
    batches. ``params``: float32 tensors by state-dict name (BN running
    statistics are not needed: train mode normalizes by the batch's).
    ``ema``: where the configuration keeps an EMA, the EMA's start by
    name (by default the parameters); ``self.ema`` is ``None`` where it
    keeps none.
    ``reference``: the configuration's reference module
    (``reference.for_config``), by default ``model``. ``group``: the
    process group of a data-parallel step, each rank its own rows, or
    ``None``."""

    def __init__(self, cfg: dict, params: dict, quant=None, reference=None,
                 group=None, ema: dict | None = None):
        if cfg["train"]["optimizer"] != "momentum":
            raise ValueError("the reference follows momentum SGD")
        self.cfg = cfg
        self.group = group
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in params.items()
                       if not k.endswith(("running_mean", "running_var"))}
        self.model = (reference or default_reference).Model(
            cfg, self.params, quant)
        self.model.training = True
        self.model.group = group
        self.trace = {k: torch.zeros_like(v) for k, v in self.params.items()}
        decay = np.float32(cfg["train"].get("ema_decay", 0.0))
        self.ema_decay = float(decay)
        self.ema_keep = float(np.float32(1) - decay)
        start = self.params if ema is None else ema
        self.ema = ({k: start[k].detach().clone() for k in self.params}
                    if decay > 0 else None)
        self.count = 0
        self.anchors = None

    def loss(self, batch: dict) -> torch.Tensor:
        cfg, m = self.cfg, self.model
        if self.anchors is None:
            self.anchors = torch.from_numpy(detect.anchors(
                cfg["image_size"], cfg["anchors"])).to(batch["images"].device)
        tg = targets(self.anchors, batch, cfg["matcher"])
        num_pos = tg["reg_w"].sum()
        if self.group is not None:
            dist.all_reduce(num_pos, group=self.group)
        num_pos = torch.clamp_min(num_pos, 1.0)
        feats = m.features(batch["images"], run=lambda fn, *a: checkpoint(
            fn, *a, use_reentrant=False))
        pyramid = checkpoint(m.fpn, feats, use_reentrant=False)
        lc = cfg["losses"]
        cls_sum = loc_sum = 0.0
        off = 0
        for p in pyramid:
            anc = cfg["anchors"]
            a = (p.shape[-2] * p.shape[-1] * anc["scales_per_octave"]
                 * len(anc["aspect_ratios"]))
            sl = slice(off, off + a)
            c, b = checkpoint(self._level_loss, p, tg["labels"][:, sl],
                              tg["cls_w"][:, sl], tg["reg"][:, sl],
                              tg["reg_w"][:, sl], self.anchors[sl],
                              use_reentrant=False)
            cls_sum, loc_sum = cls_sum + c, loc_sum + b
            off += a
        return (lc["classification_weight"] * cls_sum / num_pos
                + lc["localization_weight"] * loc_sum / num_pos)

    def _level_loss(self, p, labels, cls_w, reg, reg_w, anc):
        cfg = self.cfg
        cls_map, box_map = self.model.level(p)
        n = p.shape[0]
        c = cfg["num_classes"]
        logits = cls_map.reshape(n, -1, c)
        t = (labels[..., None] == torch.arange(c, device=p.device)).float()
        lc = cfg["losses"]
        cls = (focal(logits, t, lc["focal_alpha"], lc["focal_gamma"])
               * cls_w[..., None]).sum()
        deltas = box_map.reshape(n, -1, 4)
        loc = (box_loss(deltas, reg, anc, lc) * reg_w).sum()
        return cls, loc

    def step(self, batch: dict) -> dict:
        """One step in place -> ``{"loss", "grad"}``: the loss with its L2
        term, and the gradient as the optimizer takes it (after the L2
        term and the clip)."""
        for v in self.params.values():
            v.grad = None
        loss = self.loss(batch)
        loss.backward()
        wd = self.cfg["losses"]["weight_decay"]
        t = self.cfg["train"]
        with torch.no_grad():
            raw = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                   for k, v in self.params.items()}
            loss = loss.detach()
            if self.group is not None:  # the ranks' shares, summed
                flat = torch.cat([g.reshape(-1) for g in raw.values()]
                                 + [loss.reshape(1)])
                dist.all_reduce(flat, group=self.group)
                off = 0
                for k, g in raw.items():
                    raw[k] = flat[off:off + g.numel()].view_as(g)
                    off += g.numel()
                loss = flat[off]
            kernels = [v for v in self.params.values() if v.dim() >= 2]
            l2 = 0.5 * wd * sum(v.square().sum() for v in kernels)
            grads = {k: raw[k] + (v * wd if v.dim() >= 2 else 0.0)
                     for k, v in self.params.items()}
            norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
            clip = t["gradient_clip_norm"]
            if clip > 0 and float(norm) >= clip:
                grads = {k: g / norm * clip for k, g in grads.items()}
            lr = lr_at(self.count, t)
            mu = t["momentum"]
            for k, g in grads.items():
                tr = self.trace[k]
                tr.copy_(g + tr * mu)
                self.params[k].add_((g + tr * mu) * -lr)
            if self.ema is not None:
                for k, e in self.ema.items():
                    e.copy_(e * self.ema_decay
                            + self.params[k] * self.ema_keep)
            self.count += 1
        return {"loss": float(loss + l2), "grad": grads}
