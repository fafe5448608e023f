"""Training steps through the step ``train_step.make_train_step`` returns,
fed by ``train.DeviceFeed`` (pinned staging, asynchronous uploads).

Set-up: the configuration's model with seeded weights (the RetinaNet
init: prediction convs of std ``predict_std``, the class prior on the
class bias), the optimizer and train state as ``train.train`` makes them,
and ``pool_batches`` seeded COCO-like batches cycled, so that the matching
kernel sees other boxes every step. The first ``followed`` steps run
through the same step and feed in the set-up (they warm up every shape);
their losses, the momentum trace after the first (the first gradient as
the optimizer takes it) and the parameters after the last are kept.

Window: steps back to back on the following batches, the host enqueueing
as the feed's staging allows; the window closes with the device idle
after the first step issued past ``seconds``. ``train_img_per_s`` is the
batch size times the steps, over the window.

Check: the reference (``reference/train.py``) from the same initial
parameters on the same batches (``judge.train_gaps``).
"""

from __future__ import annotations

import gc
import time

import torch

from bench_port import generator, judge, peaks
from bench_port.harness import per_layer_metrics
from bench_port.reference.model import precise
from bench_port.reference.train import Trainer
from bench_port.weights import seeded_state


def batches(cell, cfg: dict) -> list:
    t = cell.traffic
    hw = (cfg["image_size"],) * 2
    return [generator.scene_batch(cell.seed, i, cfg["train"]["batch_size"],
                                hw, cfg["num_classes"], t["scenes"],
                                cell.device)
            for i in range(t["pool_batches"])]


def _host(tensors: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def build(cell, cfg_dict: dict):
    t = cell.traffic
    state = seeded_state(cell.reference.param_shapes(cfg_dict), cell.seed,
                         cell.device, t["class_bias"], t.get("predict_std"))
    init = _host(state)
    ts, step, feed = program(cfg_dict, state, cell.device)
    return ts, step, feed, init


def program(cfg_dict: dict, state: dict, device, mesh=None):
    """The port's detector from ``state``, its optimizer and train state as
    ``train.train`` makes them, the step (data-parallel over ``mesh``) and
    the feed -> (train state, step, feed). Empties ``state`` once the
    detector holds its copy, so that the seeded weights are freed before
    the train state is made."""
    from ssd_tpu_torch.config import Config
    from ssd_tpu_torch.models.detector import Detector
    from ssd_tpu_torch.train import DeviceFeed
    from ssd_tpu_torch.train_step import (Optimizer, create_train_state,
                                          make_train_step)

    cfg = Config.from_dict(cfg_dict)
    det = Detector(cfg, state, device=device)
    state.clear()
    opt = Optimizer(cfg)
    ts = create_train_state(det, opt, ema_decay=cfg.train.ema_decay)
    step = make_train_step(det, opt, ema_decay=cfg.train.ema_decay,
                           mesh=mesh)
    return ts, step, DeviceFeed(device)


def free(device) -> None:
    """Returns what the dropped program held to the device."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(cell) -> dict:
    cfg = cell.repo_config
    t = cell.traffic
    ts, step, feed, init = build(cell, cfg)
    pool = batches(cell, cfg)
    followed = t["followed"]
    losses = []
    for i in range(followed):
        _, metrics = step(ts, feed(pool[i % len(pool)]))
        losses.append(metrics["loss"])
        if i == 0:
            first_grad = _host(ts.opt_state["trace"])
    after = _host(ts.params)
    losses = [float(v) for v in losses]
    cell.setup_done()
    n = cfg["train"]["batch_size"]
    i = followed
    with cell.window() as w:
        end = w.start + w.seconds
        steps = 0
        while True:
            step(ts, feed(pool[i % len(pool)]))
            i += 1
            steps += 1
            if time.perf_counter() >= end:
                cell.sync()
                w.close(steps, steps * n)
                break
    memory = (torch.cuda.max_memory_allocated(cell.device)
              if cell.device.type == "cuda" else 0)
    k2_bound = [peaks.k2_bound_s(n, anchor_count(cfg), b["boxes"].shape[1],
                                 int(b["num_boxes"].sum()))
                for b in pool]
    del ts, step, feed
    free(cell.device)
    precise()
    gaps = follow(cell, cfg, init, pool, followed, losses, first_grad, after)
    metrics = {}
    if cell.trace:
        metrics = per_layer_metrics(cell, {
            "k2_bound_s": sum(k2_bound) / len(k2_bound),
            "flops_per_image": cell.config["flops_per_image"]["train"],
            "peak_flops": peaks.DENSE_PEAK[cfg["model"]["compute_dtype"]]})
    else:
        metrics["train_img_per_s"] = {"value": cell.images / cell.window_s,
                                      "unit": "img/s"}
    checks = cell.checks(gaps)
    return {"attempted": (followed + cell.units) * n, "failed": 0,
            "checks": checks, "metrics": metrics,
            "memory_peak_bytes": memory}


def anchor_count(cfg: dict) -> int:
    a = cfg["anchors"]
    k = a["scales_per_octave"] * len(a["aspect_ratios"])
    size = cfg["image_size"]
    return sum((-(-size // 2 ** lvl)) ** 2 * k
               for lvl in range(a["min_level"], a["max_level"] + 1))


def reference_steps(cell, cfg, init, pool, followed, quant=None,
                    group=None):
    """The reference's first ``followed`` steps from ``init`` on the pool's
    batches -> (losses, the first gradient as the optimizer takes it, each
    leaf's change), on the cell's device; with ``group``, data-parallel
    over its ranks, each on its own batches (``Trainer``)."""
    dev = cell.device
    ref = Trainer(cfg, {k: v.to(dev) for k, v in init.items()}, quant,
                  cell.reference, group=group)
    losses = []
    for i in range(followed):
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in pool[i % len(pool)].items()}
        losses.append(ref.step(b)["loss"])
        if i == 0:
            first = {k: v.detach().clone() for k, v in ref.trace.items()}
    change = {k: ref.params[k].detach() - init[k].to(dev)
              for k in ref.params}
    return losses, first, change


def follow(cell, cfg, init, pool, followed, losses, first_grad,
           after) -> dict:
    """The program's readings against the reference's."""
    dev = cell.device
    ref_losses, ref_grad, ref_change = reference_steps(cell, cfg, init, pool,
                                                       followed)
    change = {k: after[k].to(dev) - init[k].to(dev) for k in ref_change}
    grad = {k: first_grad[k].to(dev) for k in ref_change}
    return judge.train_gaps(losses, ref_losses, grad, ref_grad, change,
                            ref_change)
