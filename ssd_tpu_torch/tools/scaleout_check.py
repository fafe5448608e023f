"""N data-parallel ranks against one process: the same steps, the same
rows.

    python -m ssd_tpu_torch.tools.scaleout_check \\
        --config configs/coco_mobilenet_640_flagship.json --nproc 4 \\
        --batch 64 [--backend nccl|gloo] [--set model.compute_dtype=float32] \\
        [--set train.param_sharding=fsdp] [--device cpu]

Starts ``torchrun --standalone --nproc-per-node N`` of
``tools/bench_train.py``: each rank steps on its ``batch / N`` rows of
the seeded synthetic batch (a first step, a warm-up step and one timed
step: three steps) and saves its state and metrics. Then the same three
steps run in this process on all ``batch`` rows, one device. Prints one
JSON line: whether the ranks' states are bit-identical, their distance
from the one-process state (bit-equal share, largest absolute and
relative difference of the weights, BN statistics and EMA), each
metric's largest relative distance, every rank's K2 launches in its
timed step, and the step times. Exits non-zero when the ranks differ or
a bar (``BARS``, f32) is missed: the bars are for f32, where the ranks'
summation order is the only difference; in bf16 the distances are
reported against no bar.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.tools import bench_train
from ssd_tpu_torch.tools.bench_serve import apply_overrides

# f32: the ranks' statistics and sums in another order than one process's
BARS = {"loss_rtol": 1e-4, "grad_norm_rtol": 1e-3, "weight_rtol": 1e-4,
        "weight_atol": 1e-5}
LOSS_KEYS = ("loss", "classification_loss", "localization_loss")


def state_diff(got: dict, want: dict) -> dict:
    """Bit-equal share, largest absolute and relative difference of two
    states (their float tensors)."""
    equal = total = 0
    max_abs = max_rel = 0.0
    for k, w in want.items():
        if w is None or not w.is_floating_point():
            continue
        g, w = got[k].double(), w.double()
        equal += int((g == w).sum())
        total += w.numel()
        d = (g - w).abs()
        max_abs = max(max_abs, float(d.max()))
        max_rel = max(max_rel, float((d / w.abs().clamp_min(1e-30)).max()))
    return {"bit_equal_share": equal / max(total, 1), "max_abs_diff": max_abs,
            "max_rel_diff": max_rel}


def _flat(saved: dict) -> dict:
    out = {f"model/{k}": v for k, v in saved["model"].items()}
    out.update({f"ema/{k}": v for k, v in (saved["ema"] or {}).items()})
    return out


def run(config: str, nproc: int, batch: int, backend: str | None = None,
        overrides: list | None = None, device=None,
        timeout: float = 900) -> dict:
    """The check of the module docstring -> its JSON object (``ok`` says
    whether it held). ``config``: a JSON file; ``overrides``:
    ``KEY=VALUE`` strings as bench_train's ``--set`` takes them."""
    overrides = list(overrides or [])
    with open(config) as f:
        cfg = Config.from_dict(apply_overrides(json.load(f), overrides),
                               strict=False)
    with tempfile.TemporaryDirectory() as root:
        ranks = os.path.join(root, "rank{rank}.pt")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(nproc), "-m",
               "ssd_tpu_torch.tools.bench_train", "--config", config,
               "--batch", str(batch), "--steps", "1", "--warmup", "1",
               "--save", ranks]
        for kv in overrides:
            cmd += ["--set", kv]
        if backend:
            cmd += ["--backend", backend]
        if device:
            cmd += ["--device", str(device)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout,
                              env=dict(os.environ, OMP_NUM_THREADS="4"))
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"{nproc} ranks failed:\n"
                               f"{proc.stdout[-3000:]}\n"
                               f"{proc.stderr[-6000:]}")
        line = next(json.loads(x) for x in proc.stdout.splitlines()
                    if x.startswith("{"))
        saved = [torch.load(ranks.format(rank=r), weights_only=False)
                 for r in range(nproc)]
        plain_file = os.path.join(root, "plain.pt")
        plain = bench_train.run(cfg, batch, 1, 1, device=device,
                                save=plain_file)
        want = torch.load(plain_file, weights_only=False)
    first = _flat(saved[0])
    identical = all(
        all(torch.equal(first[k], v) for k, v in _flat(s).items())
        and s["metrics"] == saved[0]["metrics"] for s in saved[1:])
    worst = {"loss": 0.0, "grad_norm": 0.0, "num_positives_equal": True}
    for g, w in zip(saved[0]["metrics"], want["metrics"]):
        worst["num_positives_equal"] &= g["num_positives"] == w["num_positives"]
        for k in LOSS_KEYS:
            worst["loss"] = max(worst["loss"], abs(g[k] / w[k] - 1))
        worst["grad_norm"] = max(worst["grad_norm"],
                                 abs(g["grad_norm"] / w["grad_norm"] - 1))
    diff = state_diff(first, _flat(want))
    f32 = cfg.model.compute_dtype == "float32"
    close = all(torch.allclose(first[k].double(), v.double(),
                               rtol=BARS["weight_rtol"],
                               atol=BARS["weight_atol"])
                for k, v in _flat(want).items() if v.is_floating_point())
    launches = [s["match_launches"] for s in saved]
    ok = (identical and worst["num_positives_equal"]
          and (not f32 or (close and worst["loss"] <= BARS["loss_rtol"]
                           and worst["grad_norm"] <= BARS["grad_norm_rtol"])))
    return {"ok": ok, "ranks": nproc, "backend": backend or "default",
            "device": line["device"], "batch": batch,
            "dtype": cfg.model.compute_dtype,
            "param_sharding": line["param_sharding"], "steps": 3,
            "ranks_bit_identical": identical, "vs_one_process": diff,
            "metric_rel_diff": worst, "bars": BARS if f32 else None,
            "match_launches": launches, "step_ms": line["step_ms"],
            "img_per_s": line["img_per_s"], "plain_step_ms": plain["step_ms"],
            "plain_img_per_s": plain["img_per_s"],
            "peak_mem_gib": line["peak_mem_gib"],
            "plain_peak_mem_gib": plain["peak_mem_gib"], "wall_s": wall}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", default="configs/coco_mobilenet_640_flagship.json")
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--backend", default=None,
                   help="gloo puts several ranks on one card")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    result = run(args.config, args.nproc, args.batch, args.backend, args.set,
                 args.device)
    print(json.dumps(result), flush=True)
    if not result["ok"]:
        sys.exit(1)
    return result


if __name__ == "__main__":
    main()
