"""Which leaves read a train cell's worst-leaf gaps, and what moves them:
the look behind comparing the median leaf's gap and not the worst's.

    python3 -m bench_port.look_leaves [--workload W] [--seeds 5 6 7]
        [--size 128 | --size 0] [--out look.jsonl]

From one seeded state, on the same batches, four runs of the cell's
first ``followed`` steps: the program as the cell runs it (``program``);
the program computing in float32 (``program_f32``), whose one rounding
left is its bf16 rounding of the normalized image (as the JAX package
rounds it); the float32 reference (``reference``); and the reference
with that rounding (``reference_rounded``). ``--size 0`` runs the cell
at its own size and batch, on the card; otherwise cut to ``--size``
pixels and a batch of 4, on the CPU, without the bf16 program (the CPU's
bf16 convs take minutes at any useful size).

For each pair it prints ``judge.train_gaps``; then the five worst leaves
of the program against the reference (or, without it, of the float32
program), of the first gradient, the change and the EMA's change, each
with its gap in every pair, its reference norm over the median leaf's,
and the norm of the leaf's difference over its own (``elem``).
"""

from __future__ import annotations

import argparse
import json
import types

import numpy as np
import torch

from bench_port import harness, judge
from bench_port.drivers import train_step as drv
from bench_port.reference.model import precise
from bench_port.weights import ema_start

WORKLOAD = "retinanet_r50_fpn_640.train_b64"
PAIRS = (("program", "reference"), ("program_f32", "reference"),
         ("program_f32", "reference_rounded"),
         ("reference_rounded", "reference"))
QUANTITIES = ("grad", "change", "ema")


def _cpu(tensors: dict) -> dict:
    return {k: v.detach().to("cpu", torch.float32, copy=True)
            for k, v in tensors.items()}


def program_run(cell) -> tuple:
    """-> (readings, init): the losses, the first gradient, each leaf's
    change and the EMA's change from its start (``None`` without one)."""
    cfg = cell.repo_config
    pool = drv.batches(cell, cfg)
    ts, step, feed, init = drv.build(cell, cfg)
    start = (_cpu(ema_start(init, cell.seed, cell.device))
             if ts.ema_params is not None else None)
    losses = []
    for i in range(cell.traffic["followed"]):
        _, m = step(ts, feed(pool[i % len(pool)]))
        losses.append(float(m["loss"]))
        if i == 0:
            grad = _cpu(ts.opt_state["trace"])
    after = _cpu(ts.params)
    out = {"losses": losses, "grad": grad,
           "change": {k: after[k] - init[k] for k in after}}
    if start is not None:
        ema = _cpu(ts.ema_params)
        out["ema"] = {k: ema[k] - start[k] for k in ema}
    del ts, step, feed
    drv.free(cell.device)
    return out, init, pool


def reference_run(cell, init: dict, pool: list, rounded: bool) -> dict:
    ref_module = cell.reference
    if rounded:
        class Rounded(ref_module.Model):
            def normalized(self, images):
                return super().normalized(images).to(torch.bfloat16).float()
        cell.reference = types.SimpleNamespace(Model=Rounded)
    try:
        losses, grad, change, ema = drv.reference_steps(
            cell, cell.repo_config, init, pool, cell.traffic["followed"])
    finally:
        cell.reference = ref_module
    out = {"losses": [float(v) for v in losses], "grad": _cpu(grad),
           "change": _cpu(change)}
    if ema is not None:
        start, ema = _cpu(ema[0]), _cpu(ema[1])
        out["ema"] = {k: ema[k] - start[k] for k in ema}
    drv.free(cell.device)
    return out


def leaf_gaps(a: dict, b: dict) -> dict:
    """Each leaf's gap as ``judge`` reads it (the leaves' norms, over the
    reference's or the median leaf's, whichever is larger)."""
    na = {k: float(a[k].norm()) for k in b}
    nb = {k: float(b[k].norm()) for k in b}
    med = float(np.median(list(nb.values())))
    return {k: abs(na[k] - nb[k]) / max(nb[k], med) for k in b}


def look(workload: str, seed: int, size: int, device, out) -> None:
    manifest = harness.load_json(harness.ROOT, "BENCHMARK.json")
    small = {} if size == 0 else {
        "config": {"image_size": size, "train": {"batch_size": 4}},
        "traffic": {"pool_batches": 3}}
    f32 = {"model": {"compute_dtype": "float32"}}

    def cell_of(over):
        merged = json.loads(json.dumps(small))
        for key, value in over.items():
            merged.setdefault(key, {}).update(value)
        return harness.Cell(manifest, workload, seed, 1.0, False, device,
                            0.0, merged)

    runs = {}
    f32_cell = cell_of({"config": f32, "traffic": f32})
    if size == 0:
        runs["program"], init, pool = program_run(cell_of({}))
    else:
        runs["program_f32"], init, pool = program_run(f32_cell)
    precise()
    cell = cell_of({})
    runs["reference"] = reference_run(cell, init, pool, False)
    runs["reference_rounded"] = reference_run(cell, init, pool, True)
    if "program_f32" not in runs:
        try:
            runs["program_f32"] = program_run(f32_cell)[0]
        except torch.cuda.OutOfMemoryError as e:  # a witness the less
            print(f"seed {seed}: the float32 program does not fit: {e}",
                  flush=True)
            drv.free(device)
    pairs = [(a, b) for a, b in PAIRS if a in runs]
    line = {"workload": workload, "seed": seed, "size": size, "pairs": {}}
    for a, b in pairs:
        ra, rb = runs[a], runs[b]
        gaps = judge.train_gaps(ra["losses"], rb["losses"], ra["grad"],
                                rb["grad"], ra["change"], rb["change"],
                                ra.get("ema"), rb.get("ema"))
        line["pairs"][f"{a}/{b}"] = gaps
        print(f"seed {seed}, {a} against {b}: " + ", ".join(
            f"{k} {v:.4g}" for k, v in gaps.items()), flush=True)
    line["worst"] = {}
    for q in QUANTITIES:
        if q not in runs["reference"]:
            continue
        per = {f"{a}/{b}": leaf_gaps(runs[a][q], runs[b][q])
               for a, b in pairs}
        first = f"{pairs[0][0]}/{pairs[0][1]}"
        ref = runs["reference"][q]
        med = float(np.median([float(v.norm()) for v in ref.values()]))
        worst = sorted(per[first], key=lambda k: -per[first][k])[:5]
        rows = []
        for k in worst:
            a = runs[pairs[0][0]][q][k]
            row = {"leaf": k, "numel": ref[k].numel(),
                   "norm_over_median": float(ref[k].norm()) / med,
                   "elem": float((a - ref[k]).norm())
                   / max(float(ref[k].norm()), 1e-30),
                   **{p: per[p][k] for p in per}}
            rows.append(row)
            print(f"  {q} {k} ({row['numel']}; norm "
                  f"{row['norm_over_median']:.3g} x the median leaf, elem "
                  f"{row['elem']:.3g}): " + ", ".join(
                      f"{p} {per[p][k]:.4g}" for p in per), flush=True)
        line["worst"][q] = rows
    if out:
        out.write(json.dumps(line) + "\n")
        out.flush()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", default=WORKLOAD)
    p.add_argument("--seeds", type=int, nargs="+", default=[5, 6, 7])
    p.add_argument("--size", type=int, default=128,
                   help="0: the cell's own size and batch, on the card")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if args.size == 0:
        if not torch.cuda.is_available():
            raise SystemExit("the cell's own size runs on the card")
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(4)
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        look(args.workload, seed, args.size, device, out)


if __name__ == "__main__":
    main()
