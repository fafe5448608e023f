"""The training loop on one device.

Counterpart of ``ssd_tpu/train.py::train`` without evaluation, a teacher
or a mesh. The caller gives the batches: any iterator of dicts in the input
pipeline's contract with ``state()`` and ``restore()`` (for example
``data.synthetic.SceneBatches``); the tfrecord pipeline is not ported yet.

    from ssd_tpu_torch.config import Config
    from ssd_tpu_torch.data.synthetic import SceneBatches, crowded_batch
    from ssd_tpu_torch.train import train
    cfg = Config.load("configs/coco_mobilenet_640_flagship.json")
    train(cfg, "runs/t1", SceneBatches(lambda i: crowded_batch(
        i, 0, 64, 640, 80, 100)), max_steps=10)

The loop initialises (weights seeded from ``train.seed``) or resumes from
the newest checkpoint in ``workdir/checkpoints``, with the batches resumed
where they stood. Each batch resolution gets its own ``Detector`` (anchors)
over the one shared model. SIGTERM sets a flag: the loop writes a final
checkpoint and stops. An exception writes a checkpoint and propagates.
Metrics are logged every ``log_every`` steps to stdout and
``workdir/metrics.jsonl``, checkpoints written every ``checkpoint_every``,
and a run that ends normally writes ``workdir/export.npz``: the served
weights (the EMA when tracked) for ``Predictor.from_npz``.
"""

from __future__ import annotations

import dataclasses
import os
import signal

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.convert import save_npz_artifact
from ssd_tpu_torch.models.detector import Detector
from ssd_tpu_torch.train_step import (Optimizer, create_train_state,
                                      inference_variables, make_lr_schedule,
                                      make_train_step)
from ssd_tpu_torch.utils.checkpoint import TrainCheckpointer
from ssd_tpu_torch.utils.logging import MetricLogger

EXPORT_NAME = "export.npz"


def train(cfg: Config, workdir: str, batches, resume: bool = True,
          max_steps: int | None = None, device=None) -> dict:
    """Runs the loop to ``max_steps`` (or ``train.num_steps``); returns the
    last step's metrics as floats."""
    t = cfg.train
    accum = max(t.grad_accum_steps, 1)
    if t.batch_size % accum:
        raise ValueError(f"train.batch_size ({t.batch_size}) must divide by "
                         f"grad_accum_steps ({accum})")
    detector = Detector(cfg, device=device)
    optimizer = Optimizer(cfg)
    lr_fn = make_lr_schedule(cfg)
    ckpt = TrainCheckpointer(os.path.join(workdir, "checkpoints"),
                             keep=t.keep_checkpoints)
    logger = MetricLogger(workdir)

    state = create_train_state(detector, optimizer, t.ema_decay, seed=t.seed)
    latest = ckpt.latest_step() if resume else None
    if latest is not None:
        state, it_state = ckpt.restore(state)
        if it_state:
            batches.restore(it_state)
        print(f"resumed from step {latest}", flush=True)

    def build_step(det: Detector):
        return make_train_step(det, optimizer, t.ema_decay, accum)

    step_fns = {tuple(cfg.image_hw()): build_step(detector)}

    def step_fn_for(batch: dict):
        hw = tuple(int(v) for v in batch["images"].shape[1:3])
        if hw not in step_fns:
            step_fns[hw] = build_step(Detector(
                dataclasses.replace(cfg, image_size=hw),
                device=detector.device, model=detector.model))
        return step_fns[hw]

    preempted = {"flag": False}

    def _sigterm(signum, frame):
        preempted["flag"] = True

    previous = signal.signal(signal.SIGTERM, _sigterm)
    num_steps = max_steps or t.num_steps
    metrics = {}
    logger.reset_clock()
    try:
        while state.step < num_steps:
            batch = next(batches)
            logger.tick_data()
            state, metrics = step_fn_for(batch)(state, batch)
            logger.tick_step()
            step = state.step
            if step % t.log_every == 0:
                logger.log(step, metrics,
                           extra={"learning_rate": float(lr_fn(step))})
            if step % t.checkpoint_every == 0 or preempted["flag"]:
                ckpt.save(state, batches.state())
            if preempted["flag"]:
                print("SIGTERM received: final checkpoint written, exiting",
                      flush=True)
                break
    except Exception:
        # crash-path checkpoint: keep the progress, then propagate
        ckpt.save(state, batches.state())
        raise
    finally:
        signal.signal(signal.SIGTERM, previous)
        logger.close()

    ckpt.save(state, batches.state())
    if not preempted["flag"]:
        save_npz_artifact(os.path.join(workdir, EXPORT_NAME), cfg,
                          inference_variables(state))
    return {k: float(v) for k, v in metrics.items()}
