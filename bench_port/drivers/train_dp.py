"""Data-parallel training steps over ``ranks`` devices of one host, through
the step ``train_step.make_train_step(mesh=)`` returns, fed by
``train.DeviceFeed`` as ``train.train`` feeds it.

Ranks: rank 0 is the harness's process on the cell's device, with the
cell, its window and its profiler; ranks 1 to ``ranks - 1`` are processes
it starts (``python -m bench_port.drivers.train_dp <spec>``), one a device
(``cuda:<rank>``). Each joins the process group through
``parallel.mesh.initialize_distributed`` (NCCL on the card, gloo on the
CPU, at ``tcp://localhost:<a free port>``). A rank that fails ends the
run: rank 0 stops the others and exits with an error rather than wait in
a collective. Before they leave the group, each rank other than 0 tells
rank 0 what it loaded of JAX or the JAX package (``harness.FORBIDDEN``);
rank 0 then prints no result and exits with 3 if any did, as ``run.main``
does for its own process.

Set-up, on every rank: the configuration's model with seeded weights (the
RetinaNet init, as ``train_step``), rank 0's broadcast to all, so that the
replicas start equal; ``train.batch_size`` set to the global batch,
``ranks x rows``, as the port reads it under a mesh; ``pool_batches``
seeded COCO-like batches of ``rows`` rows, this rank's own (the batch
indices of rank ``r`` are ``i x ranks + r``: the global batch ``i`` is the
ranks' rows together), cycled; the first ``followed`` steps through the
same step and feed. The rows a rank reads are those of its data index
(``parallel.mesh.data_index_and_size``), as ``train.train`` takes its
pipeline's host shard.

Window: every rank steps back to back; after each step rank 0 decides
whether the window is over and sends that over the host group (gloo,
``parallel.mesh.host_group``), which adds no device sync to a step. The
window closes when every card is idle (each rank synchronises, then a
barrier on the host group). ``train_img_per_s`` is ``ranks x rows`` times
the steps, over the window. The trace, the idle share and the spans are
rank 0's; ``memory_peak_bytes`` is the fullest card's.

Check: the reference (``reference/train.py`` with ``group``) follows the
same steps from the same initial parameters, each rank on its own rows,
batch norm's means and the positive count summed over the ranks, the
gradients and the loss summed (the one-process step at the global batch,
which is what the port's step computes), after the window and with the
program's state freed; rank 0 compares (``judge.train_gaps``).

The mix's ``fault`` (a name of ``faults.TRAINING``; the tests set it, no
mix file does) plants that fault on every rank, under the set-up's steps
and the window.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import subprocess
import sys
import threading
import time

import torch
import torch.distributed as dist

from bench_port import faults, generator, judge, peaks
from bench_port.drivers.train_step import (_host, anchor_count, free,
                                           program, reference_steps)
from bench_port.harness import ROOT, forbidden_modules, per_layer_metrics
from bench_port.reference import for_config
from bench_port.reference.model import Quant, precise
from bench_port.weights import seeded_state

JOIN_SECONDS = 30  # how long rank 0 waits for a rank to exit at the end


class Rank:
    """What one rank runs: the repo config (with the global batch), the
    mix, its reference module, its place in the group, and once joined the
    mesh."""

    def __init__(self, cfg: dict, traffic: dict, reference, rank: int,
                 world: int, device: torch.device):
        self.cfg, self.traffic, self.reference = cfg, traffic, reference
        self.rank, self.world, self.device = rank, world, device
        self.mesh = None

    @property
    def rows(self) -> int:
        return self.traffic["rows"]


def config(cell) -> dict:
    """The repo config as the cell runs it, ``train.batch_size`` the global
    batch."""
    cfg = cell.repo_config
    cfg["train"]["batch_size"] = cell.traffic["rows"] * cell.traffic["ranks"]
    return cfg


def batches(ctx: Rank, seed: int, index: int) -> list:
    """Data index ``index``'s rows of each pool batch."""
    t, cfg = ctx.traffic, ctx.cfg
    hw = (cfg["image_size"],) * 2
    return [generator.scene_batch(seed, i * ctx.world + index, ctx.rows, hw,
                                  cfg["num_classes"], t["scenes"],
                                  ctx.device)
            for i in range(t["pool_batches"])]


def initial_state(ctx: Rank, seed: int) -> dict:
    """The seeded weights on this rank's device, rank 0's on every rank."""
    t = ctx.traffic
    state = seeded_state(ctx.reference.param_shapes(ctx.cfg), seed,
                         ctx.device, t["class_bias"], t.get("predict_std"))
    for v in state.values():
        dist.broadcast(v, 0)
    return state


def _host_group():
    from ssd_tpu_torch.parallel import mesh as mesh_lib
    return mesh_lib.host_group() or dist.group.WORLD


def _all_idle(ctx: Rank) -> None:
    """Every card idle: each rank synchronises, then a host barrier."""
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    dist.barrier(group=_host_group())


def window(ctx: Rank, ts, step, feed, pool: list, i: int, cell=None) -> None:
    """Steps back to back until rank 0 (``cell``'s) says the window is
    over, after a step."""
    flag = torch.zeros(1, dtype=torch.int32)
    host = _host_group()
    with (cell.window() if cell is not None
          else contextlib.nullcontext()) as w:
        end = w.start + w.seconds if w is not None else None
        steps = 0
        while True:
            step(ts, feed(pool[i % len(pool)]))
            i += 1
            steps += 1
            if w is not None:
                flag[0] = int(time.perf_counter() >= end)
            dist.broadcast(flag, 0, group=host)
            if flag[0]:
                _all_idle(ctx)
                if w is not None:
                    w.close(steps, steps * ctx.rows * ctx.world)
                return


def memory_peak(ctx: Rank) -> int:
    """The fullest card's peak, on every rank."""
    mine = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    peaks_ = [torch.zeros(1, dtype=torch.int64) for _ in range(ctx.world)]
    dist.all_gather(peaks_, torch.tensor([mine], dtype=torch.int64),
                    group=_host_group())
    return int(max(int(p) for p in peaks_))


def replica_mismatch(ctx: Rank, tensors: dict) -> float:
    """The share of ``tensors`` (by name) in which a rank's differs from
    rank 0's in any bit, the largest over the ranks, on every rank: data
    parallelism keeps one state, so that a sound step leaves every
    replica equal."""
    keys = sorted(tensors)
    mine = torch.cat([tensors[k].detach().reshape(-1) for k in keys])
    first = mine.clone()
    dist.broadcast(first, 0)
    differ = torch.stack([d.any() for d in (mine != first).split(
        [tensors[k].numel() for k in keys])])
    share = torch.tensor([float(differ.sum()) / len(keys)])
    shares = [torch.zeros(1) for _ in range(ctx.world)]
    dist.all_gather(shares, share, group=_host_group())
    return max(float(v) for v in shares)


def job(ctx: Rank, seed: int, kind: str, timed: bool, cell=None) -> dict:
    """One seed on this rank: the program's first steps (``kind``
    ``program``, or a fault of ``faults.TRAINING`` planted on every rank),
    or the control (the reference with its convs fake-quantized to 8 bits
    in the program's place); with ``timed`` the window after them (rank 0
    holds ``cell``). Every rank then follows the reference. -> rank 0's
    readings: ``gaps`` (``judge.train_gaps``), and where the program ran
    ``memory_peak_bytes`` and ``k2_bound_s``; ``{}`` elsewhere."""
    from ssd_tpu_torch.parallel import mesh as mesh_lib
    followed = ctx.traffic["followed"]
    own = batches(ctx, seed, ctx.rank)
    state = initial_state(ctx, seed)
    init = _host(state)
    out = {}
    if kind == "control":
        del state
        free(ctx.device)
        precise()
        losses, grad, change = reference_steps(
            ctx, ctx.cfg, init, own, followed,
            Quant(8, dynamic=True, ste=True), dist.group.WORLD)
        replica = 0.0  # one reference state for all the ranks
        after = {k: init[k].to(ctx.device) + v for k, v in change.items()}
        del change
    else:
        with (faults.planted(kind) if kind != "program"
              else contextlib.nullcontext()):
            index, _ = mesh_lib.data_index_and_size(ctx.mesh)
            pool = own if index == ctx.rank else batches(ctx, seed, index)
            ts, step, feed = program(ctx.cfg, state, ctx.device, ctx.mesh)
            del state
            losses = []
            for i in range(followed):
                _, metrics = step(ts, feed(pool[i % len(pool)]))
                losses.append(metrics["loss"])
                if i == 0 and ctx.rank == 0:
                    grad = _host(ts.opt_state["trace"])
            if ctx.rank == 0:
                after = _host(ts.params)
            losses = [float(v) for v in losses]
            replica = replica_mismatch(ctx, dict(
                ts.params, **{k + ".trace": v
                              for k, v in ts.opt_state["trace"].items()}))
            _all_idle(ctx)
            if timed:
                if cell is not None:
                    cell.setup_done()
                window(ctx, ts, step, feed, pool, followed, cell)
        out["memory_peak_bytes"] = memory_peak(ctx)
        out["k2_bound_s"] = sum(
            peaks.k2_bound_s(ctx.rows, anchor_count(ctx.cfg),
                             b["boxes"].shape[1], int(b["num_boxes"].sum()))
            for b in pool) / len(pool)
        del ts, step, feed, pool
        free(ctx.device)
        precise()
    t0 = time.perf_counter()
    ref_losses, ref_grad, ref_change = reference_steps(
        ctx, ctx.cfg, init, own, followed, group=dist.group.WORLD)
    out["check_s"] = time.perf_counter() - t0
    if ctx.rank:
        return {}
    dev = ctx.device
    change = {k: after[k].to(dev) - init[k].to(dev) for k in ref_change}
    grad = {k: grad[k].to(dev) for k in ref_change}
    out["gaps"] = dict(judge.train_gaps(losses, ref_losses, grad, ref_grad,
                                        change, ref_change),
                       replica_mismatch=replica)
    return out


# ------------------------------------------------------------- the ranks

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _join(ctx: Rank, init_method: str) -> None:
    from ssd_tpu_torch.parallel import mesh as mesh_lib
    mesh_lib.initialize_distributed(ctx.device, init_method, ctx.world,
                                    ctx.rank)
    ctx.mesh = mesh_lib.create_mesh()


def _leave(ctx: Rank) -> dict:
    """Every rank ends the group together (NCCL's teardown waits for the
    other ranks'), once its jobs are done and so its window closed: first
    each tells the others what it loaded of ``harness.FORBIDDEN`` ->
    ``{rank: names}`` of the ranks other than 0 that loaded any (rank 0's
    own process is ``run.main``'s to look at, as in every cell)."""
    from ssd_tpu_torch.parallel import mesh as mesh_lib
    _all_idle(ctx)
    found = [None] * ctx.world
    dist.all_gather_object(found, forbidden_modules(), group=_host_group())
    mesh_lib.shutdown_distributed()
    return {r: names for r, names in enumerate(found) if r and names}


class _Ranks:
    """Ranks 1 to ``world - 1``, each a process of its own, watched: one
    that fails takes the run down with it, since the others would wait in
    a collective for ever."""

    def __init__(self, spec: dict):
        # their standard output goes to standard error: the result's line
        # is the last on standard output
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "bench_port.drivers.train_dp",
             json.dumps(dict(spec, rank=r))],
            cwd=ROOT, stdin=subprocess.DEVNULL, stdout=2)
            for r in range(1, spec["world"])]
        self.done = threading.Event()
        self.watch = threading.Thread(target=self._watch, daemon=True)
        self.watch.start()

    def _watch(self) -> None:
        while not self.done.wait(0.5):
            failed = [p for p in self.procs if p.poll() not in (None, 0)]
            if failed:
                print(f"bench_port: a rank exited with code "
                      f"{failed[0].returncode}: no result", file=sys.stderr,
                      flush=True)
                self.kill()
                os._exit(4)

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def close(self, ok: bool) -> None:
        """Waits for the ranks to exit, ``JOIN_SECONDS`` at the most, and
        stops those that outlast it (all of them where ``ok`` is false).
        Raises where a rank failed by itself."""
        self.done.set()
        self.watch.join()
        if ok:
            deadline = time.monotonic() + JOIN_SECONDS
            for p in self.procs:
                try:
                    p.wait(max(deadline - time.monotonic(), 0.1))
                except subprocess.TimeoutExpired:
                    break
        late = [r for r, p in enumerate(self.procs, 1) if p.poll() is None]
        self.kill()
        if ok and late:
            print(f"bench_port: ranks {late} had not exited "
                  f"{JOIN_SECONDS} s after the run and were stopped",
                  file=sys.stderr, flush=True)
        codes = [p.returncode for r, p in enumerate(self.procs, 1)
                 if r not in late]
        if ok and any(codes):
            raise RuntimeError(f"ranks ended with codes {codes}")


def session(cell, jobs: list[tuple[int, str]], timed: bool) -> list[dict]:
    """Runs ``jobs`` (``(seed, kind)``) on every rank, rank 0 here on the
    cell's device; -> rank 0's readings of each."""
    from ssd_tpu_torch.parallel import mesh as mesh_lib
    t = cell.traffic
    world = t["ranks"]
    if cell.device.type == "cuda" and torch.cuda.device_count() < world:
        raise SystemExit(f"{world} ranks need {world} cards; found "
                         f"{torch.cuda.device_count()}")
    init_method = f"tcp://localhost:{_free_port()}"
    if cell.device.type == "cuda":
        # one intra-op thread a rank, as torchrun starts each: four ranks'
        # pools on one host's cores otherwise contend with the launching
        # threads (the feed's copy read 15-43 ms a step, the runs 3.7-6.2%
        # apart, each rank with a pool of every core: PERF.md)
        torch.set_num_threads(1)
    ctx = Rank(config(cell), t, cell.reference, 0, world, cell.device)
    ranks = _Ranks({"cfg": ctx.cfg, "traffic": t,
                    "reference": cell.config.get("reference", "model"),
                    "world": world, "device": cell.device.type,
                    "init_method": init_method,
                    "threads": torch.get_num_threads(),
                    "jobs": jobs, "timed": timed})
    ok = False
    try:
        _join(ctx, init_method)
        out = [job(ctx, seed, kind, timed, cell) for seed, kind in jobs]
        found = _leave(ctx)
        ok = True
    finally:
        if not ok:
            mesh_lib.shutdown_distributed()
        ranks.close(ok)
    if found:
        print(f"bench_port: ranks loaded {found}, which the port's "
              "benchmark must not: no result", file=sys.stderr, flush=True)
        raise SystemExit(3)
    return out


def run(cell) -> dict:
    t = cell.traffic
    kind = t.get("fault", "program")  # a fault only where a test plants one
    out = session(cell, [(cell.seed, kind)], timed=True)[0]
    print(f"bench_port: the reference's steps took {out['check_s']:.1f} s",
          file=sys.stderr)
    world, n = t["ranks"], t["rows"] * t["ranks"]
    metrics = {}
    if cell.trace:
        dtype = cell.repo_config["model"]["compute_dtype"]
        metrics = per_layer_metrics(cell, {
            "k2_bound_s": out["k2_bound_s"],
            "flops_per_image": cell.config["flops_per_image"]["train"],
            "peak_flops": world * peaks.DENSE_PEAK[dtype]})
    else:
        metrics["train_img_per_s"] = {"value": cell.images / cell.window_s,
                                      "unit": "img/s"}
    return {"attempted": (t["followed"] + cell.units) * n, "failed": 0,
            "checks": cell.checks(out["gaps"]), "metrics": metrics,
            "memory_peak_bytes": out["memory_peak_bytes"], "devices": world}


def main(spec: dict) -> None:
    """A rank other than 0: joins the group and runs the jobs."""
    _die_with_parent()
    torch.set_num_threads(spec["threads"])
    rank = spec["rank"]
    device = torch.device("cuda", rank) if spec["device"] == "cuda" \
        else torch.device("cpu")
    ctx = Rank(spec["cfg"], spec["traffic"],
               for_config({"reference": spec["reference"]}), rank,
               spec["world"], device)
    _join(ctx, spec["init_method"])
    for seed, kind in spec["jobs"]:
        job(ctx, seed, kind, spec["timed"])
    _leave(ctx)


def _die_with_parent() -> None:
    """Linux: this process is killed when rank 0's ends."""
    import ctypes
    import signal
    try:
        ctypes.CDLL("libc.so.6").prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except OSError:
        pass


if __name__ == "__main__":
    main(json.loads(sys.argv[1]))
