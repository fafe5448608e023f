"""The readings that a cell's limits are set from: the program's own
(sound runs) and its control's, seed by seed, in one process.

    python3 -m bench_port.controls --workload <name> --seeds 1 2 3 \\
        [--out controls.jsonl]

The control is the next precision below the configuration's, put in the
program's place:

* a bf16 serve cell: the program's own int8 path (int8 with
  ``int8_neck``, calibrated on a seeded batch), against the float32
  reference;
* an int8 serve cell: the reference's 4-bit emulation, against its 8-bit
  one (its selection, NMS and merge are the reference's own, on its own
  raw maps);
* the bf16 train cells: the reference with its convs fake-quantized to
  8 bits (per tensor, each call's own range, the rounding passed straight
  through), against the float32 reference; and the fault of half the
  batch left out (the program's step on the first half of each batch's
  rows, its mean over them), planted in the program.

``--kinds`` may also name the faults of ``faults.py`` (a serve cell's
``SERVING``, a data-parallel train cell's ``TRAINING``), each planted in
the program at the cell's own size. A data-parallel cell reads every seed
and kind in one session of its ranks.

Each line: ``{"workload", "seed", "kind": "program" | "control" |
"half_batch" | a fault, readings...}``. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys

import torch

from bench_port import faults, harness


def _free(cell) -> None:
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()


def serve_readings(cell, kind: str) -> dict:
    """One seed's readings of the program or the control, over every pool
    batch, against the reference the cell is judged by."""
    from bench_port.drivers import serve_pipelined as drv
    from bench_port.reference import detect
    from bench_port.reference.model import precise
    cfg = cell.repo_config
    int8 = cfg["model"]["compute_dtype"] == "int8"
    batches = drv.pool(cell, cfg)
    run_cfg = cfg
    if kind == "control" and not int8:  # the program's int8 path
        run_cfg = json.loads(json.dumps(cfg))
        run_cfg["model"].update(compute_dtype="int8", int8_neck=True)
    pred, state, calib = drv.build(cell, run_cfg)
    served = stages = None
    if kind != "control" or not int8:
        with (faults.planted(kind) if kind in faults.SERVING
              else contextlib.nullcontext()):
            served = [pred.predict(b) for b in batches]
            stages = drv.program_stages(pred, batches)
    del pred
    _free(cell)
    precise()
    bits = 8 if int8 else None
    if served is None:  # the reference's 4-bit emulation in the program's place
        ctl = drv.reference(cell, cfg, state, calib, 4)
        anchors = drv.reference_anchors(cell, cfg)
        served, stages = [], []
        for images in batches:
            raw, _, _, final = ctl(images)
            served.append({k: v.cpu().numpy() for k, v in final.items()})
            stages.append((raw, detect.select_cells(
                raw, anchors, cfg["num_classes"], cfg["nms"])))
        del ctl
    look = {}
    worst = drv.judge_pool(cell, cfg, drv.reference(cell, cfg, state, calib,
                                                    bits), batches, stages,
                           {j: [out] for j, out in enumerate(served)}, look)
    if look.get("gap", 0.0) > 1.0:  # the widest gap's detection, to look at
        worst["look"] = look
    return worst


def train_readings(cell, kind: str) -> dict:
    from bench_port.drivers import train_step as drv
    from bench_port.reference.model import Quant, precise
    cfg = cell.repo_config
    pool = drv.batches(cell, cfg)
    n = cell.traffic["followed"]
    ts, step, feed, init = drv.build(cell, cfg)
    if kind == "control":
        del ts, step, feed
        _free(cell)
        precise()
        losses, grad, change = drv.reference_steps(
            cell, cfg, init, pool, n, Quant(8, dynamic=True, ste=True))
        after = {k: init[k].to(cell.device) + v for k, v in change.items()}
    else:
        losses = []
        with (faults.planted(kind) if kind in faults.TRAINING
              else contextlib.nullcontext()):
            for i in range(n):
                _, m = step(ts, feed(pool[i % len(pool)]))
                losses.append(m["loss"])
                if i == 0:
                    grad = drv._host(ts.opt_state["trace"])
        after = drv._host(ts.params)
        losses = [float(v) for v in losses]
        del ts, step, feed
        _free(cell)
        precise()
    _free(cell)
    return drv.follow(cell, cfg, init, pool, n, losses, grad, after)


def dp_readings(cell, seeds: list, kinds: list) -> tuple[list, list]:
    """A data-parallel train cell's readings of each seed and kind, in one
    session of its ranks -> (the jobs, their readings)."""
    from bench_port.drivers import train_dp
    jobs = [(seed, kind) for seed in seeds for kind in kinds]
    outs = train_dp.session(cell, jobs, timed=False)
    return jobs, [o["gaps"] for o in outs]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--kinds", nargs="+",
                   default=["program", "control"])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from bench_port.run import T0
    if not torch.cuda.is_available():
        sys.exit("the controls are read on the card")
    manifest = harness.load_json(harness.ROOT, "BENCHMARK.json")
    out = open(args.out, "a") if args.out else None

    def emit(seed, kind, readings):
        line = {"workload": args.workload, "seed": seed, "kind": kind,
                **readings}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()

    def cell_of(seed):
        return harness.Cell(manifest, args.workload, seed, 1.0, False,
                            torch.device("cuda", 0), T0)

    if cell_of(0).traffic["driver"] == "train_dp":
        for (seed, kind), readings in zip(*dp_readings(
                cell_of(0), args.seeds, args.kinds)):
            emit(seed, kind, readings)
        return
    for seed in args.seeds:
        for kind in args.kinds:
            cell = cell_of(seed)
            fn = (train_readings if cell.traffic["driver"] == "train_step"
                  else serve_readings)
            emit(seed, kind, fn(cell, kind))
            _free(cell)


if __name__ == "__main__":
    main()
