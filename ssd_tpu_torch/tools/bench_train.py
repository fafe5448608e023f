"""Training-step benchmark: the steady step time on a synthetic batch that
lives on the device (the port's ``ssd_tpu/tools/bench_train.py``).

Builds the config's ``Detector`` (weights seeded from 0), its optimizer
and ``make_train_step`` (forward, target creation with the matching
kernel, the loss, backward, clip, update, BN statistics and EMA), uploads
one seeded synthetic batch once, and times ``--steps`` steps chained on it
after ``--warmup`` steps, ending in one synchronisation: the step alone,
without the input pipeline (``data.pipeline`` is timed on its own). On the
CPU the same protocol runs the plain versions.

    python -m ssd_tpu_torch.tools.bench_train \\
        --config configs/coco_mobilenet_640_flagship.json [--batch 64] \\
        [--steps 20] [--warmup 5] [--set model.width_multiplier=0.5 ...] \\
        [--profile DIR] [--device cpu]
    torchrun --nproc-per-node N -m ssd_tpu_torch.tools.bench_train ...

Under ``torchrun`` the step is data-parallel over the ranks (the JAX
tool's 1-D data mesh): ``--batch`` is the global batch, each rank steps
on its own ``batch / N`` rows of the one synthetic batch
(``train.param_sharding``, settable with ``--set``, picks replicated or
FSDP state), and rank 0 prints the global img/s. ``--model-parallelism
M`` splits the convs' channels over M ranks besides
(``parallel.mesh.model_sharded``): the ranks of a model group step on the
same rows, ``batch / (N / M)`` of them.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.models.detector import Detector
from ssd_tpu_torch.ops import matching_cuda
from ssd_tpu_torch.parallel import mesh as mesh_lib
from ssd_tpu_torch.tools.bench_serve import apply_overrides, sync
from ssd_tpu_torch.train import DeviceFeed
from ssd_tpu_torch.train_step import (Optimizer, create_train_state,
                                      make_train_step)


def synthetic_batch(cfg: Config, batch: int, seed: int = 0) -> dict:
    """Random uint8 images and plausible boxes and labels, padded to
    ``data.max_gt_boxes`` (the JAX package's ``synthetic_batch``, draw for
    draw)."""
    rng = np.random.RandomState(seed)
    ih, iw = cfg.image_hw()
    m = cfg.data.max_gt_boxes
    images = rng.randint(0, 256, (batch, ih, iw, 3), np.uint8)
    num = rng.randint(1, min(m, 12) + 1, (batch,)).astype(np.int32)
    ymin = rng.uniform(0.0, 0.6, (batch, m))
    xmin = rng.uniform(0.0, 0.6, (batch, m))
    h = rng.uniform(0.05, 0.4, (batch, m))
    w = rng.uniform(0.05, 0.4, (batch, m))
    boxes = np.stack(
        [ymin, xmin, np.minimum(ymin + h, 1.0), np.minimum(xmin + w, 1.0)],
        -1).astype(np.float32)
    labels = rng.randint(0, cfg.num_classes, (batch, m)).astype(np.int32)
    mask = np.arange(m)[None, :] < num[:, None]
    boxes *= mask[..., None]
    labels = np.where(mask, labels, 0)
    return {"images": images, "boxes": boxes, "labels": labels,
            "num_boxes": num}


def run(cfg: Config, batch: int, steps: int, warmup: int, device=None,
        profile: str = "", backend: str | None = None,
        save: str = "", model_parallelism: int = 1) -> dict:
    """The protocol of the module docstring; ``save``: a file for the
    final state (whole tensors: the model's state dict and the EMA) and
    each step's metrics, written by rank 0 (a collective under FSDP), by
    every rank when the name holds ``{rank}``."""
    mesh = (mesh_lib.create_mesh(model_parallelism=model_parallelism)
            if mesh_lib.initialize_distributed(device, backend=backend)
            else None)
    rank, world = mesh_lib.rank_and_world()
    data_index, data_size = mesh_lib.data_index_and_size(mesh)
    if batch % data_size:
        raise ValueError(f"--batch {batch} must divide by the {data_size} "
                         "data ranks")
    det = Detector(cfg, device=device if mesh is None else mesh.device)
    device = det.device
    split = mesh_lib.model_sharded(mesh, det.model) if mesh else []
    if mesh is not None and cfg.train.param_sharding == "fsdp":
        mesh_lib.fsdp_sharded(mesh, det.model, base=split or None)
    optimizer = Optimizer(cfg)
    state = create_train_state(det, optimizer, cfg.train.ema_decay)
    step = make_train_step(det, optimizer, cfg.train.ema_decay,
                           cfg.train.grad_accum_steps, mesh=mesh)
    local = batch // data_size
    rows = {k: v[data_index * local:(data_index + 1) * local]
            for k, v in synthetic_batch(cfg, batch).items()}
    dev_batch = DeviceFeed(device)(rows)
    sync(device)
    t0 = time.perf_counter()
    state, metrics = step(state, dev_batch)
    loss = float(metrics["loss"])  # waits for the first step
    first_s = time.perf_counter() - t0
    kept = [{k: float(v) for k, v in metrics.items()}] if save else None
    for _ in range(warmup):
        state, metrics = step(state, dev_batch)
        if save:
            kept.append({k: float(v) for k, v in metrics.items()})
    sync(device)
    prof = None
    if profile:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            *([torch.profiler.ProfilerActivity.CUDA]
              if device.type == "cuda" else [])])
        prof.__enter__()
    matching_cuda.launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step(state, dev_batch)
    loss = float(metrics["loss"])
    dt = time.perf_counter() - t0
    launches = matching_cuda.launches
    if prof is not None:
        prof.__exit__(None, None, None)
        os.makedirs(profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile, "trace.json"))
    ms = dt / steps * 1e3
    cuda = device.type == "cuda"
    if save:
        kept.append({k: float(v) for k, v in metrics.items()})
        whole = {k: mesh_lib.full_tensor(v.detach()).cpu()
                 for k, v in det.model.state_dict().items()}
        ema = ({k: mesh_lib.full_tensor(v.detach()).cpu()
                for k, v in state.ema_params.items()}
               if state.ema_params is not None else None)
        if rank == 0 or "{rank}" in save:
            torch.save({"model": whole, "ema": ema, "metrics": kept,
                        "world_size": world, "match_launches": launches},
                       save.format(rank=rank))
    return {"batch": batch, "world_size": world,
            "model_parallelism": model_parallelism,
            "model_split_leaves": len(split),
            "param_sharding": cfg.train.param_sharding if mesh else None,
            "image_size": cfg.image_size,
            "dtype": cfg.model.compute_dtype,
            "grad_accum_steps": cfg.train.grad_accum_steps,
            "step_ms": ms, "img_per_s": batch / ms * 1e3,
            "first_step_s": first_s, "loss": loss,
            "match_launches": launches,
            "peak_mem_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                             if cuda else None),
            "device": torch.cuda.get_device_name(device) if cuda else "cpu",
            **({"profile": os.path.join(profile, "trace.json")}
               if profile else {})}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", default="configs/coco_mobilenet_640.json")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                   help="config override, e.g. model.width_multiplier=0.5")
    p.add_argument("--profile", default="", metavar="DIR",
                   help="write a torch.profiler trace of the timed window")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    p.add_argument("--backend", default=None,
                   help="process group backend under torchrun (default: "
                        "NCCL on the card, gloo on the CPU; gloo on the "
                        "card runs several ranks on one card)")
    p.add_argument("--model-parallelism", type=int, default=1, metavar="M",
                   help="split the convs' channels over M ranks (channel "
                        "tensor parallelism; the rest of the ranks are "
                        "the data axis)")
    p.add_argument("--save", default="", metavar="FILE",
                   help="write the final state and each step's metrics "
                        "(every step's when --steps 1); a FILE holding "
                        "{rank} is written by every rank")
    args = p.parse_args(argv)
    with open(args.config) as f:
        cfg = Config.from_dict(apply_overrides(json.load(f), args.set),
                               strict=False)
    try:
        result = {"config": args.config,
                  **run(cfg, args.batch, args.steps, args.warmup,
                        args.device, args.profile, args.backend,
                        args.save, args.model_parallelism)}
        if mesh_lib.rank_and_world()[0] == 0:
            print(json.dumps(result))
    finally:
        mesh_lib.shutdown_distributed()
    return result


if __name__ == "__main__":
    main()
