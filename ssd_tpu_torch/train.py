"""The training loop, on one device or data-parallel over several.

Counterpart of ``ssd_tpu/train.py``:

    python -m ssd_tpu_torch.train --config configs/coco_mobilenet_640.json \\
        --workdir runs/t1 [--max-steps N] [--no-resume] [--profile N] \\
        [--device cpu]
    torchrun --nproc-per-node N -m ssd_tpu_torch.train --config ... \\
        --workdir ... [--device cpu]

Under ``torchrun`` each rank is one process on its own card (NCCL; gloo
with ``--device cpu``), JAX's process: it reads ``batch_size // N`` rows
of each global batch through the pipeline's host shard (``host_id`` its
rank), runs the data-parallel step (``train_step.make_train_step(mesh=)``:
global batch norm, loss normalizers and gradient sum, so the step is the
one-device step at the global batch), with the state replicated or, under
``train.param_sharding: "fsdp"``, sharded by FSDP. Rank 0 alone logs and
writes checkpoints, ``best/`` and ``export/``; every rank restores, and
evaluates its own rows of the validation set before the statistics are
gathered (``evaluate``).

The loop reads ``data.train_file_pattern`` through the deterministic,
resumable, prefetching ``data.pipeline.Pipeline`` (augmentation, mosaic,
``train.multiscale``), or any iterator a caller passes as ``batches`` in
the pipeline's contract with ``state()`` and ``restore()`` (for example
``data.synthetic.SceneBatches``). Each batch is uploaded from pinned
staging buffers (``DeviceFeed``), so a step never waits for the card; the
metrics are read back every ``log_every`` steps, and that is the only wait.

It initialises (weights seeded from ``train.seed``; ``train.init_from``
warm-starts them from an inference artifact, a directory or a ``.npz``)
or resumes from the newest checkpoint in ``workdir/checkpoints``, with
the batches resumed where they stood. Each batch resolution gets its own
``Detector`` (anchors) over the one shared model. ``train.distill_from``
loads a teacher artifact (same classes and anchors), checked before any
data or checkpoint is touched. Every ``eval_every`` steps the served
weights (the EMA when tracked) are loaded into a separate evaluation
``Detector`` and scored on ``data.val_file_pattern`` (COCO mAP); an
improvement writes the artifact directory ``workdir/best``. SIGTERM sets
a flag: the loop writes a final checkpoint and stops. An exception writes
a checkpoint and propagates. Metrics go to stdout and
``workdir/metrics.jsonl``; a run that ends normally writes the artifact
directory ``workdir/export`` (with the label map found beside the training
shards) for ``Predictor.from_checkpoint``; ``python -m
ssd_tpu_torch.export`` writes one from any checkpoint. ``profile_steps``
records a ``torch.profiler`` trace of that many steps from this run's
10th into ``workdir/profile``, with a summary of its waits for the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import signal
import time

import numpy as np
import torch
from torch.profiler import record_function

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.data.pipeline import Pipeline
from ssd_tpu_torch.device import PinnedStaging
from ssd_tpu_torch.eval.coco_map import DetectionEvaluator
from ssd_tpu_torch.export import (load_inference_artifact,
                                  save_inference_artifact)
from ssd_tpu_torch.models.detector import Detector
from ssd_tpu_torch.ops import matching_cuda, nms_cuda
from ssd_tpu_torch.parallel import mesh as mesh_lib
from ssd_tpu_torch.train_step import (Optimizer, TrainState,
                                      create_train_state,
                                      inference_variables, make_lr_schedule,
                                      make_train_step)
from ssd_tpu_torch.utils import profiling
from ssd_tpu_torch.utils.checkpoint import TrainCheckpointer
from ssd_tpu_torch.utils.logging import MetricLogger

EXPORT_NAME = "export"  # the artifact directories in the workdir
BEST_NAME = "best"
PROFILE_DIR = "profile"
PROFILE_START = 10  # the profiled window starts at this run's 10th step
BATCH_KEYS = ("images", "boxes", "labels", "num_boxes")


class DeviceFeed:
    """Uploads the training keys of a host batch to the device.

    On the card each array is copied into a pinned staging buffer and sent
    without waiting (``device.PinnedStaging``, the predictor's design). On
    the CPU the arrays become tensors as they are.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.staging = PinnedStaging(depth=3)  # batches in flight + 1

    def __call__(self, batch: dict) -> dict:
        out = {}
        for k in BATCH_KEYS:
            arr = np.ascontiguousarray(batch[k])
            host = torch.from_numpy(arr)
            if self.device.type != "cuda":
                out[k] = host
                continue
            buf, event = self.staging.take(arr.shape, host.dtype)
            buf.copy_(host)
            out[k] = self.staging.upload(buf, event, self.device)
        return out


def evaluate(detector: Detector, cfg: Config, host_id: int = 0,
             num_hosts: int = 1, max_batches: int | None = None,
             mesh=None) -> dict:
    """COCO-style mAP of ``detector`` (its weights as they are) over
    ``cfg.data.val_file_pattern``, read by an eval ``Pipeline`` at
    ``train.batch_size // num_hosts`` rows (at least 1) of host
    ``host_id``'s shard: the padded tail rows are skipped (``valid``),
    crowd boxes are ignore regions, areas are taken at ``orig_hw``. Under a
    process group every rank calls it with its rank as ``host_id`` and the
    statistics are gathered (``DetectionEvaluator.gather``), so every rank
    returns the global numbers. ``mesh``: the rows of each batch are
    predicted in contiguous blocks, one on each of the mesh's devices (a
    replica of ``detector`` each; K1 on each device), and come back in
    order. Raises ``FileNotFoundError`` when the pattern matches
    nothing."""
    replicas = [detector] if mesh is None else mesh_lib.replicate(detector,
                                                                  mesh)
    evaluator = DetectionEvaluator(cfg.num_classes)
    pipeline = Pipeline(cfg.data.val_file_pattern, cfg, is_training=False,
                        batch_size=max(cfg.train.batch_size // num_hosts, 1),
                        host_id=host_id, num_hosts=num_hosts)
    for i, batch in enumerate(pipeline):
        if max_batches is not None and i >= max_batches:
            break
        images = batch["images"]
        bounds = mesh_lib.row_bounds(len(images), len(replicas))
        outs = [r.predict(images[lo:hi])
                for r, (lo, hi) in zip(replicas, bounds) if hi > lo]
        evaluator.add_batch(
            {k: mesh_lib.local_rows([getattr(o, k) for o in outs])
             for k in ("boxes", "scores", "labels", "num_boxes")},
            batch["boxes"], batch["labels"], batch["num_boxes"],
            valid=batch["valid"], gt_is_crowd=batch["is_crowd"],
            orig_hw=batch["orig_hw"])
    return evaluator.gather().result()


def warm_start(state: TrainState, artifact_path: str) -> TrainState:
    """Seeds a fresh state from an inference artifact (a directory or a
    ``.npz``): every parameter and BN
    statistic whose name, shape and dtype match is copied; the rest (say a
    class head of another class count) keep their initialization. The EMA
    is re-seeded from the warm-started parameters."""
    _, donor = load_inference_artifact(artifact_path)

    def merge(fresh: dict, kind: str) -> None:
        copied = 0
        with torch.no_grad():
            for name, leaf in fresh.items():
                d = donor.get(name)
                if (d is not None and d.shape == leaf.shape
                        and d.dtype == leaf.dtype):
                    mesh_lib.assign(leaf, d)
                    copied += 1
        print(f"warm_start: copied {copied}/{len(fresh)} {kind} leaves "
              f"from {artifact_path}", flush=True)

    merge(state.params, "param")
    if any(k in donor for k in state.batch_stats):
        merge(state.batch_stats, "bn")
    if state.ema_params is not None:
        # the EMA was a copy of the random init; with a slow decay that
        # would dominate evaluation and export for thousands of steps
        with torch.no_grad():
            for k, e in state.ema_params.items():
                e.copy_(state.params[k])
    return state


def load_teacher(cfg: Config, device) -> tuple[Config, Detector] | None:
    """The distillation teacher of ``train.distill_from`` (None without
    one), checked against the student: the same class count and anchors."""
    if not cfg.train.distill_from:
        return None
    t_cfg, t_state = load_inference_artifact(cfg.train.distill_from)
    if t_cfg.num_classes != cfg.num_classes:
        raise ValueError(f"distill teacher has {t_cfg.num_classes} classes, "
                         f"student {cfg.num_classes}")
    if t_cfg.anchors != cfg.anchors:
        raise ValueError("distill teacher's anchor config differs from the "
                         "student's — head geometries must match")
    print(f"distillation: teacher {t_cfg.model.backbone} "
          f"(w={t_cfg.model.width_multiplier}) from "
          f"{cfg.train.distill_from}", flush=True)
    return t_cfg, Detector(t_cfg, t_state, device=device)


def find_label_map(train_file_pattern: str) -> dict | None:
    """The ``*label_map.json`` beside the training shards, if any."""
    pattern_dir = os.path.dirname(train_file_pattern) or "."
    maps = sorted(glob.glob(os.path.join(pattern_dir, "*label_map.json")))
    if not maps:
        return None
    with open(maps[0]) as f:
        return {int(k): v for k, v in json.load(f).items()}


def train(cfg: Config, workdir: str, batches=None, resume: bool = True,
          max_steps: int | None = None, device=None,
          profile_steps: int = 0) -> dict:
    """Runs the loop to ``max_steps`` (or ``train.num_steps``); returns the
    last step's metrics as floats. ``batches``: an iterator of host batches
    with ``state()``/``restore()`` (under a process group, of this rank's
    rows); ``None`` reads the tfrecords. Under ``torchrun`` (or a process
    group already started) the loop is data-parallel over the ranks (the
    module docstring)."""
    t = cfg.train
    accum = max(t.grad_accum_steps, 1)
    if t.batch_size % accum:
        raise ValueError(f"train.batch_size ({t.batch_size}) must divide by "
                         f"grad_accum_steps ({accum})")
    if t.param_sharding not in ("replicated", "fsdp"):
        raise ValueError(
            f"unknown train.param_sharding: {t.param_sharding!r}")
    mesh = (mesh_lib.create_mesh()
            if mesh_lib.initialize_distributed(device) else None)
    rank, world = mesh_lib.rank_and_world()
    if t.batch_size % world:
        raise ValueError(f"train.batch_size ({t.batch_size}) must divide by "
                         f"the data axis ({world})")
    if accum > 1 and (t.batch_size // accum) % world:
        # JAX's refusal (its SPMD depthwise backward miscomputes a
        # microbatch the data axis does not divide); here it also keeps
        # each rank's stride over its own rows equal to JAX's over the
        # global batch
        raise ValueError(
            f"microbatch ({t.batch_size}//{accum}) must divide by "
            f"the data axis ({world}) for grad accumulation")
    detector = Detector(cfg, device=device if mesh is None else mesh.device)
    device = detector.device
    # the teacher fails fast, before any data or checkpoint is touched
    teacher = load_teacher(cfg, device)
    optimizer = Optimizer(cfg)
    lr_fn = make_lr_schedule(cfg)
    ckpt = TrainCheckpointer(os.path.join(workdir, "checkpoints"),
                             keep=t.keep_checkpoints)
    if batches is None:
        batches = Pipeline(cfg.data.train_file_pattern, cfg,
                           is_training=True, batch_size=t.batch_size // world,
                           host_id=rank, num_hosts=world, seed=t.seed)

    detector.model.reset_parameters(t.seed)
    if mesh is not None and t.param_sharding == "fsdp":
        # before the state: its moments and EMA are made sharded
        mesh_lib.fsdp_sharded(mesh, detector.model)
    state = create_train_state(detector, optimizer, t.ema_decay)
    latest = ckpt.latest_step() if resume else None
    if latest is not None:
        state, it_state = ckpt.restore(state)
        if it_state:
            batches.restore(it_state)
        print(f"resumed from step {latest}", flush=True)
    elif t.init_from:
        state = warm_start(state, t.init_from)

    def teacher_for(det: Detector) -> Detector | None:
        """The teacher at this student detector's resolution."""
        if teacher is None:
            return None
        t_cfg, t_det = teacher
        return Detector(dataclasses.replace(t_cfg,
                                            image_size=det.cfg.image_size),
                        device=device, model=t_det.model)

    def build_step(det: Detector):
        return make_train_step(det, optimizer, t.ema_decay, accum,
                               teacher=teacher_for(det), mesh=mesh)

    step_fns = {tuple(cfg.image_hw()): build_step(detector)}

    def step_fn_for(hw: tuple) -> callable:
        if hw not in step_fns:
            step_fns[hw] = build_step(Detector(
                dataclasses.replace(cfg, image_size=hw), device=device,
                model=detector.model))
        return step_fns[hw]

    eval_det = None
    best_map = -1.0
    label_map = find_label_map(cfg.data.train_file_pattern)

    preempted = {"flag": False}

    def _sigterm(signum, frame):
        preempted["flag"] = True

    previous = signal.signal(signal.SIGTERM, _sigterm)
    logger = MetricLogger(workdir if rank == 0 else None)
    feed = DeviceFeed(device)
    num_steps = max_steps or t.num_steps
    profile_start = (state.step + PROFILE_START
                     if profile_steps > 0 and rank == 0 else -1)
    prof = None
    metrics = {}
    data_iter = iter(batches)
    logger.reset_clock()
    try:
        while state.step < num_steps:
            if state.step == profile_start:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    *([torch.profiler.ProfilerActivity.CUDA]
                      if device.type == "cuda" else [])])
                prof.__enter__()
                print(f"profiler: tracing {profile_steps} steps -> "
                      f"{os.path.join(workdir, PROFILE_DIR)}", flush=True)
            batch = next(data_iter)
            logger.tick_data()
            hw = tuple(int(v) for v in batch["images"].shape[1:3])
            with record_function("train.feed"):
                dev_batch = feed(batch)
            with record_function("train.step"):
                state, metrics = step_fn_for(hw)(state, dev_batch)
            step = state.step
            if step % t.log_every == 0 and rank == 0:
                with record_function("train.log"):
                    logger.log(step, metrics, extra={
                        "learning_rate": float(lr_fn(step)),
                        "image_hw": list(hw)})
            logger.tick_step()
            if prof is not None and step >= profile_start + profile_steps:
                _stop_profile(prof, workdir, device)
                prof = None
                logger.reset_clock()  # the trace's export is not input time
            if step % t.checkpoint_every == 0 or preempted["flag"]:
                ckpt.save(state, batches.state())
            if preempted["flag"]:
                print("SIGTERM received: final checkpoint written, exiting",
                      flush=True)
                break
            if t.eval_every and step % t.eval_every == 0:
                try:
                    if eval_det is None:
                        eval_det = Detector(cfg, inference_variables(state),
                                            device=device)
                    else:
                        eval_det.model.load_state_dict(
                            inference_variables(state))
                    # every rank: its rows, then the gathered numbers,
                    # the same on every rank, so the branch below is taken
                    # in lockstep (inference_variables is a collective
                    # under FSDP)
                    result = evaluate(eval_det, cfg, rank, world, mesh=mesh)
                    if rank == 0:
                        logger.log(step, {}, extra={"mAP": result["mAP"],
                                                    "AP50": result["AP50"]})
                    if result["mAP"] > best_map:
                        best_map = result["mAP"]
                        served = inference_variables(state)
                        if rank == 0:
                            save_inference_artifact(
                                os.path.join(workdir, BEST_NAME), cfg,
                                served, label_map)
                except FileNotFoundError:
                    pass  # no val set configured
    except Exception:
        # crash-path checkpoint: keep the progress, then propagate
        ckpt.save(state, batches.state())
        raise
    finally:
        if prof is not None:  # the loop ended inside the window
            _stop_profile(prof, workdir, device)
        close = getattr(data_iter, "close", None)
        if close is not None:  # stops the pipeline's prefetch thread
            close()
        signal.signal(signal.SIGTERM, previous)
        logger.close()

    ckpt.save(state, batches.state())
    if not preempted["flag"]:
        served = inference_variables(state)
        if rank == 0:
            save_inference_artifact(os.path.join(workdir, EXPORT_NAME), cfg,
                                    served, label_map)
    if not metrics:
        return {}
    return dict(zip(metrics, torch.stack(
        [v.float() for v in metrics.values()]).tolist()))


def _stop_profile(prof, workdir: str, device: torch.device) -> None:
    """Ends the profiled window: the chrome trace and ``summary.json``
    (``utils.profiling.summarize`` of the ``train.*`` spans)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.__exit__(None, None, None)
    out = os.path.join(workdir, PROFILE_DIR)
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(profiling.summarize(prof, "train."), f, indent=1)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True, help="path to config JSON")
    p.add_argument("--workdir", required=True)
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="record a torch.profiler trace of N steady steps "
                        "into WORKDIR/profile")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    if not os.path.exists(args.config):
        p.error(f"config file not found: {args.config}")
    cfg = Config.load(args.config)
    mesh_lib.initialize_distributed(args.device)  # under torchrun
    rank, world = mesh_lib.rank_and_world()
    os.makedirs(args.workdir, exist_ok=True)
    if rank == 0:
        cfg.save(os.path.join(args.workdir, "config.json"))
    matching_cuda.launches = nms_cuda.launches = 0
    t0 = time.perf_counter()
    try:
        last = train(cfg, args.workdir, resume=not args.no_resume,
                     max_steps=args.max_steps, device=args.device,
                     profile_steps=args.profile)
        cuda = torch.device(args.device or "cuda").type == "cuda"
        print(json.dumps({
            "train_done": True, "final_metrics": last,
            "wall_s": time.perf_counter() - t0,
            "rank": rank, "world_size": world,
            "kernel_launches": {"match": matching_cuda.launches,
                                "nms": nms_cuda.launches},
            "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                             if cuda else None)}), flush=True)
    finally:
        mesh_lib.shutdown_distributed()


if __name__ == "__main__":
    main()
