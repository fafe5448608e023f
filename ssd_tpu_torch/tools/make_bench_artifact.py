"""Trains the sanity task's artifact (the port's
``ssd_tpu/tools/make_bench_artifact.py``).

The sanity task (``eval/sanity.py``): the flagship-shaped tiny detector
(dense4 MobileNet-v1 x0.25, 8 classes, 128 px, bf16) on seed-derived
synthetic scenes. The tool trains it on a pool of ``--pool`` fixed
training batches (batch ``i`` is ``data/synthetic.sanity_train_batch(i)``,
the JAX tool's batch ``i``), cycled, printing the loss every 100 steps;
saves an inference artifact directory (``export.save_inference_artifact``)
at ``--out``; and prints its ``sanity_map`` on the 32 seed-derived val
scenes (``eval/sanity.evaluate_map``).

The JAX tool starts from ``jax.random`` weights, which the port cannot
draw: ``--seed`` starts from ``convert.seeded_state(cfg, seed)`` with the
class head's bias at the RetinaNet prior, or ``--init`` from the weights
(and the config) of a given artifact, a directory or ``.npz``; its config
must be the sanity task's (8 classes, 128 px). ``ssd_tpu_torch/assets/``
holds the JAX package's trained sanity weights, the port's parity anchor,
and ``bench_assets/`` the JAX package's artifact: ``--out`` may point at
neither.

    python -m ssd_tpu_torch.tools.make_bench_artifact --out DIR \\
        [--steps 3000] [--pool 32] [--seed 0 | --init ART] [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import os

import torch

from ssd_tpu_torch.constants import CLASS_PRIOR

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PROTECTED = (os.path.join(ROOT, "ssd_tpu_torch", "assets"),
             os.path.join(ROOT, "bench_assets"))


def check_out(out: str) -> None:
    """Refuses an ``out`` inside the committed assets."""
    real = os.path.realpath(out)
    for d in PROTECTED:
        d = os.path.realpath(d)
        if real == d or real.startswith(d + os.sep):
            raise ValueError(f"--out {out} lies in {d}: the committed "
                             "reference weights are never overwritten")


def train_artifact(out: str, steps: int = 3000, pool: int = 32,
                   seed: int = 0, init: str | None = None,
                   device=None) -> dict:
    """Trains, saves ``out``, scores it; returns ``{"losses": [every
    step's loss], "sanity_map": mAP, "dtype": ...}`` (the losses read back
    in one copy at the end; the printed ones every 100 steps)."""
    from ssd_tpu_torch.convert import seeded_state
    from ssd_tpu_torch.data.synthetic import sanity_train_batch
    from ssd_tpu_torch.eval.sanity import evaluate_map, sanity_config
    from ssd_tpu_torch.export import (load_inference_artifact,
                                      save_inference_artifact)
    from ssd_tpu_torch.models.detector import Detector
    from ssd_tpu_torch.train import DeviceFeed
    from ssd_tpu_torch.train_step import (Optimizer, create_train_state,
                                          inference_variables,
                                          make_train_step)

    check_out(out)
    if init:
        cfg, state = load_inference_artifact(init)
        want = sanity_config()
        if (cfg.num_classes, cfg.image_size) != (want.num_classes,
                                                 want.image_size):
            raise ValueError(f"--init {init} is not the sanity task's model "
                             f"({cfg.num_classes} classes at "
                             f"{cfg.image_size} px)")
    else:
        cfg = sanity_config()
        state = seeded_state(cfg, seed, class_bias=-math.log(
            (1.0 - CLASS_PRIOR) / CLASS_PRIOR))
    det = Detector(cfg, state, device=device)
    opt = Optimizer(cfg)
    tstate = create_train_state(det, opt, cfg.train.ema_decay)
    step = make_train_step(det, opt, cfg.train.ema_decay)

    feed = DeviceFeed(det.device)
    batches = [feed(sanity_train_batch(i, cfg.train.batch_size,
                                       cfg.data.max_gt_boxes))
               for i in range(pool)]
    losses = []
    for i in range(steps):
        tstate, metrics = step(tstate, batches[i % len(batches)])
        losses.append(metrics["loss"])
        if i % 100 == 0 or i == steps - 1:
            print(f"step {i}: loss={float(metrics['loss']):.4f}", flush=True)
    losses = torch.stack(losses).tolist()

    save_inference_artifact(out, cfg, {k: v.cpu() for k, v in
                                       inference_variables(tstate).items()})
    print(f"saved -> {out}")
    dtype = {"bfloat16": "bf16", "float32": "f32"}.get(
        cfg.model.compute_dtype, cfg.model.compute_dtype)
    m = evaluate_map(out, device=device)
    print(f"sanity_map({dtype}) = {m:.4f}", flush=True)
    return {"losses": losses, "sanity_map": m, "dtype": dtype, "out": out}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--pool", type=int, default=32,
                   help="distinct seed-derived training batches to cycle")
    p.add_argument("--out", required=True,
                   help="artifact directory to write (not under the "
                        "committed assets)")
    src = p.add_mutually_exclusive_group()
    src.add_argument("--seed", type=int, default=0,
                     help="convert.seeded_state seed of the initial weights")
    src.add_argument("--init", default=None,
                     help="start from this artifact's weights and config")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    return train_artifact(args.out, args.steps, args.pool, args.seed,
                          args.init, args.device)


if __name__ == "__main__":
    main()
