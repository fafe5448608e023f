"""Why the train cell compares the median leaf's gap and not the worst
leaf's: a look on the CPU at a small size.

    python3 -m bench_port.look_leaves [--seeds 5 6 7] [--size 128]

The train cell's model and step, cut to ``--size`` pixels and a batch of
4, with the program computing in float32, so that the one rounding left
between it and the float32 reference is the program's bf16 rounding of
the normalized image (ResNet-50's stem input, as the JAX package rounds
it). Its first three steps are held to the plain reference and to the
reference with that same rounding (``judge.train_gaps``); for each seed
it prints both readings and the worst leaves of the first gradient.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from bench_port import harness, judge
from bench_port.drivers import train_step as drv
from bench_port.reference.model import Model
from bench_port.reference.train import Trainer

WORKLOAD = "retinanet_r50_fpn_640.train_b64"


class RoundedInput(Model):
    """The reference with the program's bf16 rounding of the normalized
    image."""

    def normalized(self, images):
        return super().normalized(images).to(torch.bfloat16).float()


def program_steps(cell) -> tuple:
    cfg = cell.repo_config
    pool = drv.batches(cell, cfg)
    ts, step, feed, init = drv.build(cell, cfg)
    losses = []
    for i in range(cell.traffic["followed"]):
        _, m = step(ts, feed(pool[i % len(pool)]))
        losses.append(float(m["loss"]))
        if i == 0:
            grad = drv._host(ts.opt_state["trace"])
    return cfg, pool, init, losses, grad, drv._host(ts.params)


def reference_steps(cfg, init, pool, n, rounded: bool) -> tuple:
    ref = Trainer(cfg, {k: v.clone() for k, v in init.items()})
    if rounded:
        ref.model = RoundedInput(cfg, ref.params)
        ref.model.training = True
    losses = []
    for i in range(n):
        b = {k: torch.from_numpy(v) for k, v in pool[i % len(pool)].items()}
        losses.append(ref.step(b)["loss"])
        if i == 0:
            grad = {k: v.detach().clone() for k, v in ref.trace.items()}
    change = {k: ref.params[k].detach() - init[k] for k in ref.params}
    return losses, grad, change


def look(seed: int, size: int) -> None:
    manifest = harness.load_json(harness.ROOT, "BENCHMARK.json")
    over = {"config": {"image_size": size, "train": {"batch_size": 4},
                       "model": {"compute_dtype": "float32"}},
            "traffic": {"pool_batches": 3}}
    cell = harness.Cell(manifest, WORKLOAD, seed, 1.0, False,
                        torch.device("cpu"), 0.0, over)
    cfg, pool, init, losses, grad, after = program_steps(cell)
    change = {k: after[k] - init[k] for k in init if k in after}
    n = cell.traffic["followed"]
    for rounded in (False, True):
        ref_losses, ref_grad, ref_change = reference_steps(
            cfg, init, pool, n, rounded)
        g = {k: grad[k] for k in ref_grad}
        c = {k: change[k] for k in ref_change}
        gaps = judge.train_gaps(losses, ref_losses, g, ref_grad, c,
                                ref_change)
        name = "rounded" if rounded else "plain"
        print(f"seed {seed} {size} px, reference {name}: "
              + ", ".join(f"{k} {v:.4g}" for k, v in gaps.items()))
        if not rounded:
            norms = {k: float(v.norm()) for k, v in g.items()}
            ref = {k: float(v.norm()) for k, v in ref_grad.items()}
            med = float(np.median(list(ref.values())))
            worst = sorted(ref, key=lambda k: -abs(norms[k] - ref[k])
                           / max(ref[k], med))[:5]
            for k in worst:
                print(f"  {k}: gap {abs(norms[k] - ref[k]) / max(ref[k], med):.4g}"
                      f", reference norm {ref[k]:.4g} (median leaf {med:.4g})")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seeds", type=int, nargs="+", default=[5, 6, 7])
    p.add_argument("--size", type=int, default=128)
    args = p.parse_args(argv)
    torch.set_num_threads(4)
    for seed in args.seeds:
        look(seed, args.size)


if __name__ == "__main__":
    main()
