"""The port's entry points for a driver: the single-card predict function
and the multi-rank dry run (the counterpart of the JAX package's
``__graft_entry__.py``).

    python -m ssd_tpu_torch.tools.dryrun --devices 4 [--device cpu]

``entry()`` returns the flagship detector's predict (640 px, dense4, 80
classes, weights seeded from 0) and its example argument, a zero uint8
batch of 8, on the card. ``dryrun_multichip(n)`` starts ``n`` ranks (NCCL,
one card a rank, when ``n`` cards are visible; otherwise gloo, every rank
on the one card, or on the CPU with ``device="cpu"``) and runs, at the
JAX dry run's tiny shapes (MobileNet x0.25, 64 px, 4 classes, batch
``2n``) on a ``(n // m, m)`` mesh, ``m = 2`` when ``n`` is even and at
least 4:

1. the channel-TP step (``parallel.mesh.model_sharded``), asserting that
   something is split over ``model``;
2. FSDP over ``data`` composed with it (``fsdp_sharded(base=)``), with 2
   accumulation steps, from the state of step 1;
3. the meshed predict: each data index predicts its block of the batch,
   the blocks are gathered over the data group, and their largest
   difference from the one-device predict of the whole batch must be 0.

Rank 0 prints the JAX dry run's line, with its keys.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.ops import matching_cuda, nms_cuda
from ssd_tpu_torch.parallel import mesh as mesh_lib

DET_KEYS = ("boxes", "scores", "labels", "num_boxes")
RANK_TIMEOUT_S = 600


def entry(device=None):
    """``(fn, (images,))``: the flagship 640 px detector's predict,
    ``fn(images) -> (boxes, scores, labels, num_boxes)``, and a zero uint8
    batch of 8 on ``device`` (the card by default)."""
    from ssd_tpu_torch.models.detector import Detector
    cfg = Config.from_dict({"num_classes": 80, "image_size": 640,
                            "model": {"stem_schedule": "dense4"}})
    det = Detector(cfg, device=device)

    def fn(images):
        out = det.predict(images)
        return out.boxes, out.scores, out.labels, out.num_boxes

    images = torch.zeros((8, 640, 640, 3), dtype=torch.uint8,
                         device=det.device)
    return fn, (images,)


def tiny_config(n_devices: int) -> Config:
    """The JAX dry run's config: MobileNet x0.25 at 64 px, 4 classes, f32,
    batch ``2 * n_devices``."""
    return Config.from_dict({
        "num_classes": 4, "image_size": 64,
        "model": {"backbone": "mobilenet", "width_multiplier": 0.25,
                  "fpn_channels": 32, "head_depth": 1,
                  "compute_dtype": "float32"},
        "train": {"batch_size": 2 * n_devices, "warmup_steps": 0}})


def tiny_batch(n: int) -> dict:
    """The JAX dry run's batch: seed-0 uint8 images and one box each."""
    rng = np.random.default_rng(0)
    return {"images": rng.integers(0, 255, (n, 64, 64, 3)).astype(np.uint8),
            "boxes": np.tile(np.array([0.2, 0.2, 0.8, 0.8], np.float32),
                             (n, 8, 1)),
            "labels": np.zeros((n, 8), np.int32),
            "num_boxes": np.ones((n,), np.int32)}


def _count(state, sharded_on) -> int:
    """The state's leaves (parameters, optimizer moments, EMA) sharded
    over the named mesh dim."""
    leaves = list(state.params.values())
    for k, v in state.opt_state.items():
        if isinstance(v, dict):
            leaves += list(v.values())
    leaves += list((state.ema_params or {}).values())
    n = 0
    for t in leaves:
        if mesh_lib.is_sharded(t):
            names = t.device_mesh.mesh_dim_names
            n += any(name == sharded_on and not p.is_replicate()
                     for name, p in zip(names, t.placements))
    return n


def run_rank(mesh: mesh_lib.Mesh, n_devices: int) -> dict:
    """The dry run on this rank (the module docstring) -> its numbers;
    every rank of the group calls it. ``line`` is JAX's printed line."""
    from ssd_tpu_torch.models.detector import Detector
    from ssd_tpu_torch.predictor import Predictor
    from ssd_tpu_torch.train_step import (Optimizer, create_train_state,
                                          inference_variables,
                                          make_train_step)
    m = mesh.model_parallelism
    cfg = tiny_config(n_devices)
    n = cfg.train.batch_size
    batch = tiny_batch(n)
    d, data = mesh_lib.data_index_and_size(mesh)
    k = n // data
    rows = {key: v[d * k:(d + 1) * k] for key, v in batch.items()}
    matching_cuda.launches = nms_cuda.launches = 0

    det = Detector(cfg, device=mesh.device)
    split = mesh_lib.model_sharded(mesh, det.model)
    opt = Optimizer(cfg)
    state = create_train_state(det, opt)
    n_tp = _count(state, mesh_lib.MODEL_AXIS)
    if m > 1 and not n_tp:
        raise AssertionError("model axis constructed but nothing sharded "
                             "on it")
    state, metrics = make_train_step(det, opt, mesh=mesh)(state, rows)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"TP step loss {loss}")

    # FSDP over data composed with the TP above, 2 accumulation steps,
    # from the state of step 1
    det2 = Detector(cfg, device=mesh.device)
    mesh_lib.fsdp_sharded(mesh, det2.model,
                          base=mesh_lib.model_sharded(mesh, det2.model)
                          or None)
    state2 = create_train_state(det2, opt)
    with torch.no_grad():
        for src, dst in ((state.params, state2.params),
                         (state.batch_stats, state2.batch_stats),
                         *((state.opt_state[key], state2.opt_state[key])
                           for key in state.opt_state if key != "count")):
            for name, v in src.items():
                mesh_lib.assign(dst[name], mesh_lib.full_tensor(v.detach()))
    state2.opt_state["count"] = state.opt_state["count"]
    n_fsdp = _count(state2, mesh_lib.DATA_AXIS)
    state2, metrics2 = make_train_step(det2, opt, grad_accum_steps=2,
                                       mesh=mesh)(state2, rows)
    loss2 = float(metrics2["loss"])
    if not np.isfinite(loss2):
        raise AssertionError(f"FSDP x TP step loss {loss2}")

    # the meshed predict: this data index's block, gathered over data
    variables = {key: v.to("cpu") for key, v in
                 inference_variables(state2).items()}
    pred = Predictor(cfg, variables, device=mesh.device)
    block = pred.predict(rows["images"])
    gathered = {}
    for key in DET_KEYS:
        t = torch.from_numpy(np.ascontiguousarray(block[key])).to(
            mesh.device)
        parts = [torch.empty_like(t) for _ in range(data)]
        dist.all_gather(parts, t, group=mesh.group)
        gathered[key] = torch.cat(parts).cpu().numpy()
    single = pred.predict(batch["images"])
    deltas = {key: float(np.max(np.abs(gathered[key].astype(np.float32)
                                       - single[key].astype(np.float32))))
              if single[key].size else 0.0 for key in DET_KEYS}
    delta = max(deltas.values())
    if delta != 0.0:
        raise AssertionError(f"meshed predict diverged from one device: "
                             f"{deltas}")
    boxes = tuple(gathered["boxes"].shape)
    line = (f"dryrun_multichip({n_devices}): ok, loss={loss:.4f}, "
            f"mesh={dict(mesh.shape)}, tp_sharded_leaves={n_tp}, "
            f"fsdp_loss={loss2:.4f}, fsdp_sharded_leaves={n_fsdp}, "
            f"meshed_predict_boxes={boxes}, "
            f"meshed_predict_max_delta={delta}")
    return {"line": line, "loss": loss, "fsdp_loss": loss2,
            "mesh": dict(mesh.shape), "tp_sharded_leaves": n_tp,
            "tp_split_params": len(split), "fsdp_sharded_leaves": n_fsdp,
            "meshed_predict_boxes": list(boxes),
            "meshed_predict_max_delta": delta,
            "match_launches": matching_cuda.launches,
            "nms_launches": nms_cuda.launches}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(n_devices: int, device=None) -> tuple[str, str]:
    """``(backend, device)`` of the ranks: NCCL one card a rank, else gloo
    on the one card, else gloo on the CPU."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo", "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("the dry run runs on the card; pass "
                           "device='cpu' for gloo on the CPU")
    if torch.cuda.device_count() >= n_devices:
        return "nccl", "cuda"
    return "gloo", "cuda"


def dryrun_multichip(n_devices: int, device=None,
                     timeout: float = RANK_TIMEOUT_S) -> dict:
    """Starts ``n_devices`` ranks of the dry run (the module docstring),
    prints rank 0's line and returns ``{"line", "backend", "ranks": [each
    rank's numbers]}``; a rank that fails raises."""
    backend, dev = _launch(n_devices, device)
    with tempfile.TemporaryDirectory() as out:
        for attempt in range(2):  # a gloo rendezvous on a loaded host
            port = _free_port()
            procs = [subprocess.Popen(
                [sys.executable, "-m", "ssd_tpu_torch.tools.dryrun",
                 "--rank", str(r), "--world", str(n_devices), "--port",
                 str(port), "--backend", backend, "--device", dev,
                 "--out", out],
                env=dict(os.environ, LOCAL_RANK=str(r),
                         OMP_NUM_THREADS="1"),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for r in range(n_devices)]
            logs = []
            for p in procs:
                try:
                    logs.append(p.communicate(timeout=timeout)[0])
                except subprocess.TimeoutExpired:
                    for q in procs:
                        q.kill()
                    logs.append(p.communicate()[0])
            if not any(p.returncode for p in procs):
                break
        for r, p in enumerate(procs):
            if p.returncode:
                raise RuntimeError(f"dry run rank {r} failed:\n"
                                   f"{logs[r][-4000:]}")
        ranks = []
        for r in range(n_devices):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    print(ranks[0]["line"], flush=True)
    return {"line": ranks[0]["line"], "backend": backend, "ranks": ranks}


def _rank_main(args) -> None:
    torch.set_num_threads(1)
    device = "cpu" if args.device == "cpu" else None
    mesh_lib.initialize_distributed(
        device, f"tcp://localhost:{args.port}", args.world, args.rank,
        backend=args.backend)
    try:
        m = 2 if args.world % 2 == 0 and args.world >= 4 else 1
        mesh = mesh_lib.create_mesh(model_parallelism=m)
        with (_deterministic() if mesh.device.type == "cuda"
              else contextlib.nullcontext()):
            result = run_rank(mesh, args.world)
        with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        mesh_lib.shutdown_distributed()


@contextlib.contextmanager
def _deterministic():
    """cuDNN's deterministic algorithms, chosen without benchmarking, for
    the block: the meshed predict's blocks and the whole batch then run
    the same arithmetic a row."""
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prev


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--devices", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="cpu: gloo ranks on the CPU (default: the card)")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--backend", default=None, help=argparse.SUPPRESS)
    p.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        _rank_main(args)
        return
    dryrun_multichip(args.devices, args.device)


if __name__ == "__main__":
    main()
